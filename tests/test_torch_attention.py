"""Parity of the port's set-attention op (diffuscene_tpu_torch/ops/attention.py)
with the JAX package's Pallas kernel (diffuscene_tpu/ops/attention.py:
fused_set_attention), run in interpret mode on the CPU as its own tests do.

Tolerances: f32 atol 3e-5, the JAX package's own
(tests/test_fused_attention.py:27), for the same f32 math summed in another
order; bf16 atol 3e-2: outputs of O(1) rounded to bf16 (2^-8 relative), plus
a flipped rounding of LN(x) or of the head outputs before their products.

The CUDA kernel itself runs only on the card: see ``chip_smoke.py`` and the
``gpu``-marked test at the end.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuscene_tpu.ops import attention as jat
from diffuscene_tpu_torch.models.denoiser import Attention, PreNorm, Residual
from diffuscene_tpu_torch.ops import attention as tat
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


B, N, C, H, D = 3, 12, 128, 4, 32
TOL = {"f32": dict(atol=3e-5, rtol=0), "bf16": dict(atol=3e-2, rtol=0)}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _case(seed, n=N, c=C):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0, base=0.0: (base + rng.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    return {"x": f(B, n, c), "g": f(c, scale=0.2, base=1.0),
            "w_qkv": f(c, 3 * H * D, scale=c ** -0.5), "w_out": f(H * D, c, scale=(H * D) ** -0.5),
            "b_out": f(c, scale=0.1)}


def _run_torch(d, dtype, eps, x=None):
    tdt = DTYPES[dtype][1]
    x = torch.from_numpy(d["x"] if x is None else x).to(tdt)
    out = tat.fused_set_attention(x, *(torch.from_numpy(d[k]) for k in ("g", "w_qkv", "w_out",
                                                                         "b_out")),
                                  heads=H, dim_head=D, eps=eps, compute_dtype=tdt)
    assert out.dtype == tdt and out.shape == x.shape
    return out.float().numpy()


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_attention_matches_jax_pallas(dtype, eps):
    d = _case(seed=int(eps * 1e5))
    jdt = DTYPES[dtype][0]
    want = jat.fused_set_attention(jnp.asarray(d["x"]).astype(jdt), *(jnp.asarray(d[k]) for k in (
        "g", "w_qkv", "w_out", "b_out")), heads=H, dim_head=D, eps=eps, compute_dtype=jdt)
    np.testing.assert_allclose(_run_torch(d, dtype, eps), np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])


@pytest.mark.parametrize("n", [12, 24])
@pytest.mark.parametrize("c", [256, 1024])
def test_attention_matches_jax_pallas_at_the_set_widths(c, n):
    """The plain f32 B2, which the card's wide kernel is held to, against
    the JAX Pallas B2 (interpret mode) at the f32 set's other widths, up to
    the most objects a scene the kernels take."""
    d = _case(seed=c + n, n=n, c=c)
    want = jat.fused_set_attention(*(jnp.asarray(d[k]) for k in ("x", "g", "w_qkv", "w_out",
                                                                  "b_out")),
                                   heads=H, dim_head=D, eps=1e-5, compute_dtype=jnp.float32)
    np.testing.assert_allclose(_run_torch(d, "f32", 1e-5), np.asarray(want), **TOL["f32"])


@pytest.mark.parametrize("n", [12, 24])
@pytest.mark.parametrize("c", [256, 1024])
def test_bf16_attention_matches_jax_pallas_at_the_set_widths(c, n):
    """The plain bf16 B2, which the card's bf16 wide kernel is held to,
    against the JAX Pallas B2 (interpret mode) in bf16 at the set's other
    widths (the same set as f32), up to the most objects a scene the
    kernels take; the bf16 engine's eps (1e-3)."""
    d = _case(seed=c + n + 1, n=n, c=c)
    want = jat.fused_set_attention(jnp.asarray(d["x"]).astype(jnp.bfloat16),
                                   *(jnp.asarray(d[k]) for k in ("g", "w_qkv", "w_out", "b_out")),
                                   heads=H, dim_head=D, eps=1e-3, compute_dtype=jnp.bfloat16)
    np.testing.assert_allclose(_run_torch(d, "bf16", 1e-3), np.asarray(want.astype(jnp.float32)),
                               **TOL["bf16"])


def test_attention_permutation_equivariance():
    d = _case(seed=1)
    perm = np.random.default_rng(2).permutation(N)
    out = _run_torch(d, "f32", 1e-5)
    out_p = _run_torch(d, "f32", 1e-5, x=d["x"][:, perm])
    np.testing.assert_allclose(out_p, out[:, perm], atol=1e-5)


def test_attention_equals_module_residual_prenorm_attention_f32():
    """In f32 the op is the model's ``Residual(PreNorm(Attention))`` (whose
    pre-norm is one-pass with eps 1e-5) on the same weights."""
    d = _case(seed=3)
    block = Residual(PreNorm(C, Attention(C, heads=H, dim_head=D)))
    with torch.no_grad():
        block.fn.norm.g.copy_(torch.from_numpy(d["g"]).reshape(1, C, 1))
        block.fn.fn.to_qkv.weight.copy_(torch.from_numpy(d["w_qkv"]).t()[:, :, None])
        block.fn.fn.to_out.weight.copy_(torch.from_numpy(d["w_out"]).t()[:, :, None])
        block.fn.fn.to_out.bias.copy_(torch.from_numpy(d["b_out"]))
        want = block(torch.from_numpy(d["x"])).numpy()
    np.testing.assert_allclose(_run_torch(d, "f32", 1e-5), want, **TOL["f32"])


def test_wrapper_validates_and_counts_only_kernel_launches():
    d = _case(seed=4)
    before = tat.fused_set_attention.launches
    _run_torch(d, "f32", 1e-5)
    assert tat.fused_set_attention.launches == before  # the CPU path is not a launch
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    with pytest.raises(ValueError):   # w_qkv of the wrong width
        tat.fused_set_attention(t["x"], t["g"], t["w_qkv"][:, :-1], t["w_out"], t["b_out"])
    with pytest.raises(ValueError):   # neither cpu nor cuda: no silent fallback
        tat.fused_set_attention(t["x"].to("meta"), t["g"], t["w_qkv"], t["w_out"], t["b_out"])


def _core_matrix_offsets(k_deep: int, n_wide: int) -> torch.Tensor:
    """Offset of (k, n) in a chunk of the no-swizzle core-matrix layout:
    ((k // 8) * (n_wide // 8) + n // 8) * 64 + (n % 8) * 8 + k % 8."""
    k = torch.arange(k_deep)[:, None]
    n = torch.arange(n_wide)[None, :]
    return ((k // 8) * (n_wide // 8) + n // 8) * 64 + (n % 8) * 8 + k % 8


def _tf32_offsets(n_wide: int) -> torch.Tensor:
    """Offset within one part of a 32-deep split step of the tf32 K-major
    core-matrix layout, (row, n) of the step: kappa = 8 j + t + 4 h holds
    row 8 t + 2 j + h, at ((kappa // 4) * (n_wide // 8) + n // 8) * 32 +
    (n % 8) * 4 + kappa % 4."""
    row = torch.arange(32)[:, None]
    n = torch.arange(n_wide)[None, :]
    t, j, h = row // 8, (row % 8) // 2, row % 2
    kappa = 8 * j + t + 4 * h
    return ((kappa // 4) * (n_wide // 8) + n // 8) * 32 + (n % 8) * 4 + kappa % 4


@pytest.mark.parametrize("head", range(4))
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_attention_weight_packing_per_head(dtype, head):
    """CTA ``head`` reads the chunks that hold its q, k and v columns of
    W_qkv and the (128, 128) block of W_out for its output columns.  bf16:
    8 chunks of 64 deep x 96 and 4 chunks of 64 x 64.  f32: 16 steps of 32
    deep x 96 and, per warpgroup u, group 2h + u's 4 steps of 32 x 64, each
    step its tf32 hi then lo parts."""
    from diffuscene_tpu_torch.ops.fused_resblock import tf32_split

    rng = np.random.default_rng(20 + head)
    w_qkv = torch.from_numpy(rng.normal(size=(512, 384)).astype(np.float32))
    w_out = torch.from_numpy(rng.normal(size=(128, 512)).astype(np.float32))
    cols = torch.cat([torch.arange(32 * head, 32 * head + 32) + 128 * part for part in range(3)])
    if dtype == "bf16":
        qkv, out = tat.pack_attention_weights(w_qkv, w_out)
        assert qkv.shape == (4 * 8 * 64 * 96,) and out.shape == (128 * 512,)
        off = _core_matrix_offsets(64, 96)
        for kt in range(8):
            chunk = qkv[(head * 8 + kt) * 6144:(head * 8 + kt + 1) * 6144]
            torch.testing.assert_close(chunk[off], w_qkv[64 * kt:64 * kt + 64, cols], rtol=0,
                                       atol=0)
        block = out[head * 16384:(head + 1) * 16384]
        off = _core_matrix_offsets(64, 64)
        for u in range(2):
            for kt in range(2):
                chunk = block[(2 * u + kt) * 4096:(2 * u + kt + 1) * 4096]
                c0 = 128 * head + 64 * u
                torch.testing.assert_close(chunk[off], w_out[64 * kt:64 * kt + 64, c0:c0 + 64],
                                           rtol=0, atol=0)
        with pytest.raises(ValueError):   # the kernels' widths only
            tat.pack_attention_weights(w_qkv[:384], w_out[:, :384])
        return
    qkv, out = tat.pack_attention_weights_tf32(w_qkv, w_out)
    assert qkv.shape == (2 * 512 * 384,) and out.shape == (2 * 128 * 512,)
    parts_qkv, parts_out = tf32_split(w_qkv), tf32_split(w_out)
    off = _tf32_offsets(96)
    for st in range(16):
        chunk = qkv[(head * 16 + st) * 6144:(head * 16 + st + 1) * 6144]
        for part in range(2):
            torch.testing.assert_close(chunk[3072 * part:][off],
                                       parts_qkv[part][32 * st:32 * st + 32, cols], rtol=0, atol=0)
    off = _tf32_offsets(64)
    for u in range(2):
        for st in range(4):
            chunk = out[((2 * head + u) * 4 + st) * 4096:][:4096]
            c0 = 128 * head + 64 * u
            for part in range(2):
                torch.testing.assert_close(chunk[2048 * part:][off],
                                           parts_out[part][32 * st:32 * st + 32, c0:c0 + 64],
                                           rtol=0, atol=0)
    with pytest.raises(ValueError):   # the kernels' widths only
        tat.pack_attention_weights_tf32(w_qkv[:384], w_out[:, :384])


@pytest.mark.parametrize("c", [256, 1024])
def test_attention_weight_packing_tf32_at_the_set_widths(c):
    """The f32 kernels' weights at C = 256 and 1024: head h's C / 32 steps
    of W_qkv from h * C / 32 * 6144, and its C / 256 chunks of W_out
    (output columns [h C / 4, (h + 1) C / 4)), each chunk's 4 steps from
    (h C / 256 + u) * 16384, every step its tf32 hi then lo parts."""
    from diffuscene_tpu_torch.ops.fused_resblock import tf32_split

    rng = np.random.default_rng(c)
    w_qkv = torch.from_numpy(rng.normal(size=(c, 384)).astype(np.float32))
    w_out = torch.from_numpy(rng.normal(size=(128, c)).astype(np.float32))
    qkv, out = tat.pack_attention_weights_tf32(w_qkv, w_out)
    assert qkv.shape == (2 * c * 384,) and out.shape == (2 * 128 * c,)
    parts_qkv, parts_out = tf32_split(w_qkv), tf32_split(w_out)
    steps, chunks = c // 32, c // 256
    for head in range(4):
        cols = torch.cat([torch.arange(32 * head, 32 * head + 32) + 128 * p for p in range(3)])
        for st in (0, steps - 1):
            chunk = qkv[(head * steps + st) * 6144:][:6144]
            for part in range(2):
                torch.testing.assert_close(chunk[3072 * part:][_tf32_offsets(96)],
                                           parts_qkv[part][32 * st:32 * st + 32, cols],
                                           rtol=0, atol=0)
        for u in range(chunks):
            for st in range(4):
                chunk = out[((head * chunks + u) * 4 + st) * 4096:][:4096]
                c0 = c // 4 * head + 64 * u
                for part in range(2):
                    torch.testing.assert_close(chunk[2048 * part:][_tf32_offsets(64)],
                                               parts_out[part][32 * st:32 * st + 32, c0:c0 + 64],
                                               rtol=0, atol=0)


@pytest.mark.parametrize("permuted", [False, True], ids=["plain", "wide"])
@pytest.mark.parametrize("c", [256, 1024])
def test_attention_weight_packing_bf16_at_the_set_widths(c, permuted):
    """The bf16 kernels' weights at C = 256 and 1024: head h's C / 64
    chunks of W_qkv from h * C / 64 * 6144 (``permuted``, the wide
    kernel's: chunk row k = 16 j + 8 h + 2 t + e holds row 16 t + 4 j + 2 h
    + e of the K tile, as pack_group_tiles(permuted=True)), and W_out's
    chunk g (columns [64 g, 64 g + 64)) as its two 64-deep K tiles from g *
    8192, each 32-deep half (one head's rows) 2048 elements."""
    rng = np.random.default_rng(c + 1)
    w_qkv = torch.from_numpy(rng.normal(size=(c, 384)).astype(np.float32))
    w_out = torch.from_numpy(rng.normal(size=(128, c)).astype(np.float32))
    qkv, out = tat.pack_attention_weights(w_qkv, w_out, permuted=permuted)
    assert qkv.shape == (c * 384,) and out.shape == (128 * c,)
    kappa = torch.arange(64)
    if permuted:
        j, h, t, e = kappa // 16, (kappa // 8) % 2, (kappa // 2) % 4, kappa % 2
        kappa = 16 * t + 4 * j + 2 * h + e
    tiles, off = c // 64, _core_matrix_offsets(64, 96)
    for head in range(4):
        cols = torch.cat([torch.arange(32 * head, 32 * head + 32) + 128 * p for p in range(3)])
        for kt in (0, tiles - 1):
            chunk = qkv[(head * tiles + kt) * 6144:][:6144]
            torch.testing.assert_close(chunk[off], w_qkv[64 * kt + kappa][:, cols], rtol=0, atol=0)
    off = _core_matrix_offsets(64, 64)
    for g in range(c // 64):
        for q in range(4):   # head q's 32 rows: half q % 2 of K tile q // 2
            half = out[g * 8192 + q * 2048:][:2048]
            torch.testing.assert_close(half[off[:32]], w_out[32 * q:32 * q + 32, 64 * g:64 * g + 64],
                                       rtol=0, atol=0)


@pytest.mark.parametrize("c", [256, 1024])
def test_attention_tile_plan_bf16_at_the_set_widths(c):
    """The bf16 wide kernel's launch at C = 256 and 1024: one cluster of 4
    CTAs a tile, no x tile in shared memory (a ring of 3 stages of 12 KB,
    111,440 bytes a CTA at every width, within the H100's 232,448), each
    CTA streaming its W_qkv columns (C x 96) and W_out block (128 x C / 4)
    in bf16 once a tile."""
    for n, scenes in ((12, 5), (21, 3), (24, 2)):
        for B in (7, 64, 256):
            plan = tat.tile_plan(B, n, dtype=torch.bfloat16, C=c)
            tiles = -(-B // scenes)
            per_cta = 2 * (c * 96 + 128 * c // 4)
            assert tuple(plan) == (scenes, tiles, tiles, 4 * tiles, 111_440, 4 * tiles * per_cta)


@pytest.mark.parametrize("c", [256, 1024])
def test_attention_tile_plan_f32_at_the_set_widths(c):
    """The wide f32 kernel's launch at C = 256 and 1024: one cluster of 4
    CTAs a tile, no x tile in shared memory (172,880 bytes a CTA at every
    width, within the H100's 232,448), each CTA streaming its split W_qkv
    columns (C x 96) and W_out block (128 x C / 4) once a tile."""
    for n, scenes in ((12, 5), (21, 3), (24, 2)):
        for B in (7, 64, 256):
            plan = tat.tile_plan(B, n, dtype=torch.float32, C=c)
            tiles = -(-B // scenes)
            per_cta = 2 * 4 * (c * 96 + 128 * c // 4)
            assert tuple(plan) == (scenes, tiles, tiles, 4 * tiles, 172_880, 4 * tiles * per_cta)
    assert tat.tile_plan(64, 12, dtype=torch.float32, C=c).smem_bytes <= 232_448


@pytest.mark.parametrize("n,scenes,tiles_64", [(12, 5, 13), (21, 3, 22), (24, 2, 32)])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_attention_tile_plan(dtype, n, scenes, tiles_64):
    """Tiles of whole scenes in 64 rows, one cluster of 4 CTAs each; one
    CTA's shared memory fits.  bf16: capped at the clusters resident at
    once, each loading its weights once.  f32: one cluster a tile at every
    batch (run/generate.sh's 256, the JAX bench's 768), each CTA streaming
    its 512 KB of split weights."""
    if dtype == "bf16":
        plan = tat.tile_plan(64, n)
        assert (plan.scenes_per_tile, plan.tiles, plan.clusters, plan.ctas) == (
            scenes, tiles_64, tiles_64, 4 * tiles_64)
        assert plan.scenes_per_tile * n <= 64 < (plan.scenes_per_tile + 1) * n
        assert 200_000 < plan.smem_bytes <= 232_448
        big = tat.tile_plan(768, n, resident=33)
        assert big.tiles == -(-768 // scenes) and (big.clusters, big.ctas) == (33, 132)
        assert big.weight_bytes == 132 * (512 * 96 + 128 * 128) * 2
        with pytest.raises(ValueError):
            tat.tile_plan(64, 25)
        return
    for B in (64, 256, 768):
        plan = tat.tile_plan(B, n, resident=33, dtype=torch.float32)
        tiles = -(-B // scenes)
        assert tuple(plan) == (scenes, tiles, tiles, 4 * tiles, 231_000, 4 * tiles * 524_288)
        assert plan.clusters * plan.scenes_per_tile >= B > (plan.clusters - 1) * scenes
    assert tat.tile_plan(64, n, dtype=torch.float32).tiles == tiles_64
    assert tat.tile_plan(64, 12, dtype=torch.float32).weight_bytes == 13 * 4 * 2 ** 19   # 27.3 MB
    with pytest.raises(ValueError):
        tat.tile_plan(64, 25, dtype=torch.float32)


@pytest.mark.parametrize("n", [12, 21])
def test_split_tf32_attention_matches_f32_attention(monkeypatch, n):
    """The f32 kernel's arithmetic before the card: the plain twin with its
    two products (its only ``@``) formed as hi*lo + lo*hi + hi*hi of tf32
    parts (both operands; each term an f32 product, summed in f32), at the
    kernel's widths (C=512, 4 heads of 32, B=2), within the card's kernel
    tolerance (chip_smoke.py KERNEL_TOL f32: atol 1e-3, rtol 1e-4) of the
    plain f32 twin."""
    from diffuscene_tpu_torch.ops.fused_resblock import tf32_split

    d = _case(seed=40 + n, n=n, c=512)
    args = [torch.from_numpy(d[k]) for k in ("x", "g", "w_qkv", "w_out", "b_out")]
    kw = dict(heads=H, dim_head=D, eps=1e-5, compute_dtype=torch.float32)
    want = tat.fused_set_attention_reference(*args, **kw)
    matmul = torch.matmul

    def split_matmul(a, w):
        (ah, al), (wh, wl) = tf32_split(a.contiguous()), tf32_split(w.contiguous())
        return matmul(ah, wl) + matmul(al, wh) + matmul(ah, wh)

    monkeypatch.setattr(torch.Tensor, "__matmul__", split_matmul)
    got = tat.fused_set_attention_reference(*args, **kw)
    monkeypatch.undo()
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)
    assert not torch.equal(got, want)   # the products did go through the split


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["c256", "c384", "c1024", "c2048", "heads8x16", "n25",
                                  "n25_c1024"])
def test_kernel_path_refuses_shapes_it_does_not_take(case, dtype):
    """No fallback: the kernels take 4 heads of 32, N <= 24 and C in (256,
    512, 1024), one set for both dtypes; anything else raises before any
    launch, through the shape check the launch path runs (here on CPU
    tensors, before it builds).  C=256 and 1024 joined the set with the
    wide kernels (f32, then bf16): in either dtype they pass that check."""
    C, heads, dim_head, n = {"c256": (256, 4, 32, 12), "c384": (384, 4, 32, 12),
                             "c1024": (1024, 4, 32, 12), "c2048": (2048, 4, 32, 12),
                             "heads8x16": (512, 8, 16, 12), "n25": (512, 4, 32, 25),
                             "n25_c1024": (1024, 4, 32, 25)}[case]
    tdt = DTYPES[dtype][1]
    if case in ("c256", "c1024"):
        tat.check_kernel_shapes(n, C, heads, dim_head, tdt)
        return
    with pytest.raises(ValueError):
        tat.check_kernel_shapes(n, C, heads, dim_head, tdt)
    hd = heads * dim_head
    x, v = torch.zeros(2, n, C, dtype=tdt), torch.zeros(C)
    with pytest.raises(ValueError):
        tat._launch_kernel(x, v, torch.zeros(C, 3 * hd), torch.zeros(hd, C), v, heads, dim_head,
                           1e-5, tdt)
    for n_ok in (1, 12, 21, 24):   # taken
        tat.check_kernel_shapes(n_ok, 512, 4, 32, tdt)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", [12, 21])
def test_cuda_kernel_matches_plain_version(n, dtype):
    """The CUDA kernel against its plain version on the card, C=512."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    d = _case(seed=5, n=n, c=512)
    tdt = DTYPES[dtype][1]
    t = {k: torch.from_numpy(v).cuda() for k, v in d.items()}
    args = (t["x"].to(tdt), t["g"], t["w_qkv"], t["w_out"], t["b_out"])
    got = tat.fused_set_attention(*args, eps=1e-3, compute_dtype=tdt)
    want = tat.fused_set_attention_reference(*args, eps=1e-3, compute_dtype=tdt)
    torch.cuda.synchronize()
    tol = dict(atol=1e-3, rtol=1e-4) if dtype == "f32" else dict(atol=1e-1, rtol=5e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.gpu
def test_cuda_kernel_bf16_at_bench_batch_and_refusals():
    """The bf16 cluster kernel at B=768 (persistent clusters walking several
    tiles each) against its plain version, and a bf16 shape it does not
    take raises on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    d = _case(seed=6, n=12, c=512)
    t = {k: torch.from_numpy(v).cuda() for k, v in d.items()}
    x = t["x"].repeat(256, 1, 1).to(torch.bfloat16)          # (768, 12, 512)
    args = (x, t["g"], t["w_qkv"], t["w_out"], t["b_out"])
    got = tat.fused_set_attention(*args, eps=1e-3)
    want = tat.fused_set_attention_reference(*args, eps=1e-3)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=1e-1, rtol=5e-2)
    with pytest.raises(ValueError):
        tat.fused_set_attention(x[:, :, :384].contiguous(), t["g"][:384], t["w_qkv"][:384],
                                t["w_out"][:, :384], t["b_out"][:384])


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [256, 768])
def test_cuda_kernel_f32_at_large_batches_and_refusals(batch):
    """The f32 cluster kernel at run/generate.sh's batch (256) and the JAX
    bench's (768), one cluster a tile in several waves (where a race on the
    reused bytes of the x tile would show), against its plain version; an
    f32 shape it does not take raises on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    d = _case(seed=7, n=12, c=512)
    t = {k: torch.from_numpy(v).cuda() for k, v in d.items()}
    g = torch.Generator("cuda").manual_seed(batch)
    x = t["x"].repeat(batch // 3, 1, 1)
    x = x + 0.1 * torch.randn(x.shape, generator=g, device="cuda")
    args = (x, t["g"], t["w_qkv"], t["w_out"], t["b_out"])
    kw = dict(eps=1e-5, compute_dtype=torch.float32)
    got = tat.fused_set_attention(*args, **kw)
    want = tat.fused_set_attention_reference(*args, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)
    for bad in ((x[:, :, :384].contiguous(), t["g"][:384], t["w_qkv"][:384],
                 t["w_out"][:, :384], t["b_out"][:384]),
                (torch.cat([x[:, :12], x[:, :13]], dim=1), *args[1:])):
        with pytest.raises(ValueError):
            tat.fused_set_attention(*bad, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c", [256, 1024])
@pytest.mark.parametrize("n", [12, 24])
def test_cuda_wide_kernel_matches_plain_version(n, c, dtype):
    """The wide kernel of each dtype against its plain version on the card
    (eps 1e-5 in f32, the bf16 engine's 1e-3 in bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    d = _case(seed=8, n=n, c=c)
    tdt = DTYPES[dtype][1]
    t = {k: torch.from_numpy(v).cuda() for k, v in d.items()}
    args = (t["x"].to(tdt), t["g"], t["w_qkv"], t["w_out"], t["b_out"])
    kw = dict(eps=1e-5 if dtype == "f32" else 1e-3, compute_dtype=tdt)
    got = tat.fused_set_attention(*args, **kw)
    want = tat.fused_set_attention_reference(*args, **kw)
    torch.cuda.synchronize()
    tol = dict(atol=1e-3, rtol=1e-4) if dtype == "f32" else dict(atol=1e-1, rtol=5e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
