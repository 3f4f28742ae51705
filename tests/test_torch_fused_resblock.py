"""Parity of the port's single-ResnetBlock op
(diffuscene_tpu_torch/ops/fused_resblock.py) with the JAX package's Pallas
kernel (diffuscene_tpu/ops/fused_resblock.py:fused_resnet_block).

On the CPU the port's ``fused_resnet_block`` runs its plain version; the JAX
side runs the Pallas kernel in interpret mode, as its own tests do.  The same
numpy inputs, made from a seed, go to both.  Tolerances: f32 atol 2e-5, the
JAX package's own (tests/test_fused_engine.py:42), for the same f32 math
summed in another order; bf16 atol 5e-2, rtol 2e-2: one rounding of an
output of O(1) is 2^-8 relative, and a flipped rounding of the second
product's operand moves an output by about as much.

The CUDA kernel itself runs only on the card: see ``chip_smoke.py`` and the
``gpu``-marked test at the end.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuscene_tpu.ops import fused_resblock as jrb
from diffuscene_tpu_torch.models.denoiser import ResnetBlock, init_parameters
from diffuscene_tpu_torch.ops import fused_resblock as trb
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


C, GROUPS = 64, 8
TOL = {"f32": dict(atol=2e-5, rtol=0), "bf16": dict(atol=5e-2, rtol=2e-2)}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _case(B, N, c_in, seed=0, c=C):
    """numpy inputs of one block: x (M, c_in), per-row film, weights."""
    rng = np.random.default_rng(seed)
    M = B * N
    f = lambda *s, scale=1.0, base=0.0: (base + rng.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    d = {"x": f(M, c_in), "film": f(M, 2 * c, scale=0.2),
         "w1": f(c_in, c, scale=c_in ** -0.5), "b1": f(c, scale=0.1),
         "gn1_scale": f(c, scale=0.1, base=1.0), "gn1_bias": f(c, scale=0.1),
         "w2": f(c, c, scale=c ** -0.5), "b2": f(c, scale=0.1),
         "gn2_scale": f(c, scale=0.1, base=1.0), "gn2_bias": f(c, scale=0.1)}
    if c_in != c:
        d["w_res"] = f(c_in, c, scale=c_in ** -0.5)
        d["b_res"] = f(c, scale=0.1)
    return d


_WEIGHTS = ("w1", "b1", "gn1_scale", "gn1_bias", "w2", "b2", "gn2_scale", "gn2_bias")


def _run_jax(d, N, dtype, groups=GROUPS):
    jdt = DTYPES[dtype][0]
    kw = {k: jnp.asarray(d[k]) for k in _WEIGHTS}
    if "w_res" in d:
        kw.update(w_res=jnp.asarray(d["w_res"]), b_res=jnp.asarray(d["b_res"]))
    out = jrb.fused_resnet_block(jnp.asarray(d["x"]).astype(jdt), jnp.asarray(d["film"]),
                                 n_per_scene=N, groups=groups, compute_dtype=jdt, **kw)
    return np.asarray(out.astype(jnp.float32))


def _run_torch(d, N, dtype, film=None, skip_split=None, groups=GROUPS):
    """The port on CPU tensors; ``film`` replaces d["film"]; ``skip_split``
    passes x as two tensors, x[:, :k] and the skip x[:, k:]."""
    tdt = DTYPES[dtype][1]
    kw = {k: torch.from_numpy(d[k]) for k in _WEIGHTS}
    if "w_res" in d:
        kw.update(w_res=torch.from_numpy(d["w_res"]), b_res=torch.from_numpy(d["b_res"]))
    x = torch.from_numpy(d["x"]).to(tdt)
    skip = None
    if skip_split is not None:
        x, skip = x[:, :skip_split].contiguous(), x[:, skip_split:].contiguous()
    film = torch.from_numpy(d["film"]) if film is None else film
    out = trb.fused_resnet_block(x, film, n_per_scene=N, groups=groups, compute_dtype=tdt,
                                 skip=skip, **kw)
    assert out.dtype == tdt and out.shape == (d["x"].shape[0], d["w1"].shape[1])
    return out.float().numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c_in", [C, 2 * C])
@pytest.mark.parametrize("N", [12, 21])
def test_block_matches_jax_pallas(N, c_in, dtype):
    """C_in = C: identity residual; C_in = 2C: the skip-concat shape, with
    its residual projection."""
    d = _case(2, N, c_in, seed=N + c_in)
    np.testing.assert_allclose(_run_torch(d, N, dtype), _run_jax(d, N, dtype), **TOL[dtype])


# (C, groups, x width, skip width): the kernels' set at its edges, groups
# of 32, 128, 32 and 128 channels, inputs up to 2048 wide; in f32 and (the
# "bf16_" cases) in bf16, the one set both dtypes take
SET_CASES = {"c256_g8": (256, 8, 256, 0), "c512_g4": (512, 4, 512, 512),
             "c512_g16": (512, 16, 512, 0), "c1024_g8": (1024, 8, 1024, 1024)}
SET_CASES.update({f"bf16_{k}": v for k, v in SET_CASES.items()})


@pytest.mark.parametrize("N", [12, 21])
@pytest.mark.parametrize("case", list(SET_CASES))
def test_block_matches_jax_pallas_at_the_set_widths(case, N):
    """The plain B1, which the card's kernels are held to, against the JAX
    Pallas B1 (interpret mode) at the widths and groupings the kernels take
    beyond C=512 in 8 groups, in f32 and in bf16: per-scene film on skip
    inputs through the projection, per-row film on an identity residual."""
    c, groups, kx, ks = SET_CASES[case]
    dtype = "bf16" if case.startswith("bf16_") else "f32"
    d = _case(3, N, kx + ks, seed=c + groups, c=c)
    if ks:
        scene_film = d["film"][::N].copy()
        d["film"] = np.repeat(scene_film, N, axis=0)
        got = _run_torch(d, N, dtype, film=torch.from_numpy(scene_film), skip_split=kx,
                         groups=groups)
    else:
        got = _run_torch(d, N, dtype, groups=groups)
    np.testing.assert_allclose(got, _run_jax(d, N, dtype, groups=groups), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_per_scene_film_and_skip_forms_match_jax(dtype):
    """The engine's forms: a per-scene (B, 2C) film and a skip-concat input
    as two tensors equal B1 on the expanded rows and the concatenation."""
    B, N = 2, 12
    d = _case(B, N, 2 * C, seed=3)
    scene_film = d["film"][::N].copy()                      # (B, 2C)
    d["film"] = np.repeat(scene_film, N, axis=0)            # B1's own per-row form
    want = _run_jax(d, N, dtype)
    got = _run_torch(d, N, dtype, film=torch.from_numpy(scene_film), skip_split=C)
    np.testing.assert_allclose(got, want, **TOL[dtype])
    # and in the port the two forms are the same computation
    assert np.array_equal(got, _run_torch(d, N, dtype))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_no_film_equals_zero_film_rows(dtype):
    """A FiLM-free block (film None) is B1 with zero film rows, exactly."""
    d = _case(2, 12, C, seed=4)
    tdt = DTYPES[dtype][1]
    w = [torch.from_numpy(d[k]) for k in _WEIGHTS]
    x = torch.from_numpy(d["x"]).to(tdt)
    none = trb.fused_resnet_block(x, None, *w, n_per_scene=12, compute_dtype=tdt)
    zero = trb.fused_resnet_block(x, torch.zeros(24, 2 * C), *w, n_per_scene=12,
                                  compute_dtype=tdt)
    assert torch.equal(none, zero)
    d["film"] = np.zeros_like(d["film"])
    np.testing.assert_allclose(none.float().numpy(), _run_jax(d, 12, dtype), **TOL[dtype])


@pytest.mark.parametrize("c_in", [C, 2 * C])
def test_block_matches_module_resnet_block_f32(c_in):
    """The op on the module's prepared weights equals the port's
    ``ResnetBlock`` (per-object condition rows through its mlp) in f32."""
    B, N, E = 2, 12, 48
    block = ResnetBlock(c_in, C, emb_dim=E, groups=GROUPS)
    init_parameters(block, torch.Generator().manual_seed(c_in))
    with torch.no_grad():
        for name, p in block.named_parameters():   # every leaf non-trivial
            if "norm" in name or name.endswith("bias"):
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(len(name))))
    rng = np.random.default_rng(c_in)
    x = torch.from_numpy(rng.normal(size=(B, N, c_in)).astype(np.float32))
    emb = torch.from_numpy(rng.normal(size=(B, N, E)).astype(np.float32))
    with torch.no_grad():
        want = block(x, emb).reshape(B * N, C)
        film = block.mlp(emb).reshape(B * N, 2 * C)
        b1, b2 = block.block1, block.block2
        got = trb.fused_resnet_block(
            x.reshape(B * N, c_in), film,
            trb.standardize_kernel(b1.proj.kernel()), b1.proj.bias, b1.norm.weight, b1.norm.bias,
            trb.standardize_kernel(b2.proj.kernel()), b2.proj.bias, b2.norm.weight, b2.norm.bias,
            w_res=None if block.res_conv is None else block.res_conv.kernel(),
            b_res=None if block.res_conv is None else block.res_conv.bias,
            n_per_scene=N, groups=GROUPS, compute_dtype=torch.float32)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


def test_wrapper_validates_and_counts_only_kernel_launches():
    d = _case(2, 12, 2 * C, seed=5)
    before = trb.fused_resnet_block.launches
    _run_torch(d, 12, "f32")
    assert trb.fused_resnet_block.launches == before  # the CPU path is not a launch
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    w = [t[k] for k in _WEIGHTS]
    with pytest.raises(ValueError):   # rows that are not whole scenes
        trb.fused_resnet_block(t["x"][:-1], None, *w, w_res=t["w_res"], n_per_scene=12)
    with pytest.raises(ValueError):   # an identity residual over a wider input
        trb.fused_resnet_block(t["x"], None, *w, n_per_scene=12)
    with pytest.raises(ValueError):   # a film of neither rows nor scenes
        trb.fused_resnet_block(t["x"], t["film"][:5], *w, w_res=t["w_res"], n_per_scene=12)
    with pytest.raises(ValueError):   # neither cpu nor cuda: no silent fallback
        trb.fused_resnet_block(t["x"].to("meta"), None, *w, w_res=t["w_res"], n_per_scene=12)


def test_prepared_operands_follow_their_weights():
    """The wrappers pack and stack weights once per weight set
    (ops/build.py:prepared): the same tensors give the same operands; an
    in-place change of any of them, or another tensor, makes them anew."""
    from diffuscene_tpu_torch.ops import build

    b, w = torch.zeros(4), torch.ones(4, 4)
    made = []

    def make():
        made.append(w.sum().item())
        return len(made)

    assert build.prepared(b, (w, None), make) == 1
    assert build.prepared(b, (w, None), make) == 1
    w.add_(1.0)                                # in place
    assert build.prepared(b, (w, None), make) == 2
    assert build.prepared(b, (w.clone(), None), make) == 3   # another tensor
    assert made == [16.0, 32.0, 32.0]


def test_prepared_operands_follow_the_compute_dtype():
    """The packed layout depends on the compute dtype, so the B1 and B2
    wrappers key their prepared operands on it: the same weights run in
    f32 and then in bf16 (or back) get each dtype's own operands."""
    from diffuscene_tpu_torch.ops import build

    b, w = torch.zeros(4), torch.ones(4, 4)

    def make(dt):
        return lambda: w.to(dt)

    for dt in (torch.float32, torch.bfloat16, torch.float32):
        assert build.prepared(b, (w,), make(dt), key=dt).dtype == dt
    held = build.prepared(b, (w,), make(torch.float32), key=torch.float32)
    assert build.prepared(b, (w,), make(torch.bfloat16), key=torch.float32) is held
    # a wide block (C=1024 over a 1024 + 1024 input, projection): its f32
    # split chunks, then its bf16 permuted chunks, then f32 again
    C, K = 1024, 2048
    ws = [torch.ones(K, C), torch.zeros(C), torch.ones(C), torch.zeros(C), torch.ones(C, C),
          torch.zeros(C), torch.ones(C), torch.zeros(C), torch.ones(K, C), torch.zeros(C)]
    for dt, n_w1 in ((torch.float32, 2 * K * C), (torch.bfloat16, K * C), (torch.float32, 2 * K * C)):
        kernel = trb.kernel_name(dt, C, 8, 1024, 1024)
        assert kernel == ("resblock_tf32_wide" if dt == torch.float32 else "resblock_bf16_wide")
        (w1p, w2p, wrp, vec), dev, _ = trb.kernel_operands(*ws, dt, kernel)
        assert all(w.dtype == dt for w in (w1p, w2p, wrp)) and vec.dtype == torch.float32
        assert w1p.numel() == wrp.numel() == n_w1 and vec.shape == (7, C)


@pytest.mark.parametrize("name,K,kx", [("w1_x_skip", 1024, 512), ("w2", 512, 512),
                                       ("w_res_x_skip", 1024, 512), ("w1_cat", 1024, 1024)])
def test_group_tile_packing_matches_index_formula(name, K, kx):
    """Element (group g, k-tile kt, position p) of the bf16 kernel's packed
    weight is W[64 kt + 8 (p // 512) + p % 8, 64 g + 8 ((p // 64) % 8) +
    (p // 8) % 8]: core matrices of 8 columns x 8 k values (128 bytes), 128
    bytes apart in n and 1024 in k (the wgmma descriptor's SBO and LBO in
    csrc/sm90.cuh).  With the skip split at kx, a group's first kx / 64
    chunks hold x rows and the rest skip rows."""
    C = trb.CHANNELS
    w = torch.arange(K * C, dtype=torch.float64).reshape(K, C)   # every element distinct
    packed = trb.pack_group_tiles(w).reshape(C // 64, K // 64, 4096)
    g, kt, p = np.meshgrid(np.arange(C // 64), np.arange(K // 64), np.arange(4096), indexing="ij")
    k = 64 * kt + 8 * (p // 512) + p % 8
    col = 64 * g + 8 * ((p // 64) % 8) + (p // 8) % 8
    assert np.array_equal(packed.numpy(), w.numpy()[k, col])
    assert (k[:, : kx // 64] < kx).all() and (k[:, kx // 64:] >= kx).all()
    with pytest.raises(ValueError):   # neither 64-deep tiles nor a width of the set
        trb.pack_group_tiles(w[:, :384])
    with pytest.raises(ValueError):
        trb.pack_group_tiles(w[:-32])


@pytest.mark.parametrize("permuted", [False, True], ids=["cluster8", "wide"])
@pytest.mark.parametrize("C,K,kx", [(256, 2048, 256), (1024, 2048, 1024), (1024, 1536, 1024)])
def test_group_tile_packing_at_the_set_widths(C, K, kx, permuted):
    """The bf16 packing at the set's other widths and its widest inputs:
    chunk (g, kt) of the 64 columns [64 g, 64 g + 64) from (g K / 64 + kt)
    4096, the core-matrix layout of the C=512 case; for the wide kernel
    (``permuted``) the chunk's k = 16 j + 8 h + 2 t + e holds row 16 t + 4
    j + 2 h + e of the K tile (each thread's A fragments 16 contiguous
    columns, csrc/sm90.cuh load_a_global_bf16), with the skip rows after
    the x rows of every chunk column."""
    w = torch.arange(K * C, dtype=torch.float64).reshape(K, C)
    packed = trb.pack_group_tiles(w, permuted=permuted).reshape(C // 64, K // 64, 4096)
    g, kt, p = np.meshgrid(np.arange(C // 64), np.arange(K // 64), np.arange(4096), indexing="ij")
    kappa = 8 * (p // 512) + p % 8
    if permuted:
        j, h, t, e = kappa // 16, (kappa // 8) % 2, (kappa // 2) % 4, kappa % 2
        kappa = 16 * t + 4 * j + 2 * h + e
    k = 64 * kt + kappa
    col = 64 * g + 8 * ((p // 64) % 8) + (p // 8) % 8
    assert np.array_equal(packed.numpy(), w.numpy()[k, col])
    assert (k[:, : kx // 64] < kx).all() and (k[:, kx // 64:] >= kx).all()
    assert np.unique(k * C + col).size == K * C   # every element once


# (N, kx, ks, B) -> (scenes per tile, clusters, CTAs, stages, shared bytes)
PLANS = {
    (12, 512, 0, 64): (5, 13, 104, 4, 102344), (12, 1024, 0, 64): (5, 13, 104, 8, 200648),
    (12, 512, 512, 64): (5, 13, 104, 8, 200648), (12, 512, 512, 63): (5, 13, 104, 8, 200648),
    (12, 512, 0, 768): (5, 154, 1232, 4, 102344), (12, 512, 512, 768): (5, 154, 1232, 8, 200648),
    (21, 512, 0, 64): (3, 22, 176, 4, 102344), (21, 512, 512, 64): (3, 22, 176, 8, 200648),
    (21, 1024, 0, 63): (3, 21, 168, 8, 200648), (21, 512, 512, 768): (3, 256, 2048, 8, 200648),
}


@pytest.mark.parametrize("case", list(PLANS))
def test_tile_plan_at_flagship_shapes(case):
    """The bf16 kernel's launch: whole scenes in 64-row tiles, one cluster
    of 8 CTAs a tile, and a CTA's shared memory within the H100's 232,448
    bytes (the library checks the same sum against the .cu when it loads)."""
    N, kx, ks, B = case
    plan = trb.tile_plan(B, N, kx, ks)
    assert tuple(plan) == PLANS[case]
    assert plan.scenes_per_tile * N <= trb.TILE_ROWS < (plan.scenes_per_tile + 1) * N
    assert plan.clusters * plan.scenes_per_tile >= B > (plan.clusters - 1) * plan.scenes_per_tile
    assert plan.smem_bytes <= trb.SMEM_LIMIT


@pytest.mark.parametrize("name,K,kx", [("w1_x_skip", 1024, 512), ("w2", 512, 512),
                                       ("w_res_x_skip", 1024, 512), ("w1_cat", 1024, 1024)])
def test_tf32_tile_packing_matches_index_formula(name, K, kx):
    """Element (group g, 32-deep step st, part, position p) of the f32
    kernel's packed weight is the tf32 hi (part 0) or lo (part 1) of W[k,
    col] with kappa = 4 (p // 256) + p % 4 the wgmma k of the chunk's
    K-major core-matrix layout (core matrices 1024 bytes apart in k, 128 in
    n), k = 32 st + 8 (kappa % 4) + 2 (kappa // 8) + (kappa // 4) % 2 (the
    permuted step, so that a thread's A fragments are contiguous columns),
    col = 64 g + 8 ((p // 32) % 8) + (p // 4) % 8.  With the skip split at
    kx, a group's first kx / 32 chunks hold x rows and the rest skip rows."""
    C = trb.CHANNELS
    rng = np.random.default_rng(K + kx)
    w = torch.from_numpy(rng.normal(size=(K, C)).astype(np.float32))
    parts = [t.numpy() for t in trb.tf32_split(w)]
    packed = trb.pack_tf32_tiles(w).reshape(C // 64, K // 32, 2, 2048).numpy()
    g, st, p = np.meshgrid(np.arange(C // 64), np.arange(K // 32), np.arange(2048), indexing="ij")
    kappa = 4 * (p // 256) + p % 4
    k = 32 * st + 8 * (kappa % 4) + 2 * (kappa // 8) + (kappa // 4) % 2
    col = 64 * g + 8 * ((p // 32) % 8) + (p // 4) % 8
    for part in (0, 1):
        assert np.array_equal(packed[:, :, part], parts[part][k, col])
    assert (k[:, : kx // 32] < kx).all() and (k[:, kx // 32:] >= kx).all()
    # every element once: hi + lo is W to within 2^-22
    assert np.allclose(packed[:, :, 0] + packed[:, :, 1], w.numpy()[k, col], rtol=2.0 ** -22, atol=0)
    with pytest.raises(ValueError):   # neither 64-deep tiles nor a width of the set
        trb.pack_tf32_tiles(w[:, :384])
    with pytest.raises(ValueError):
        trb.pack_tf32_tiles(w[:-32])


@pytest.mark.parametrize("C,K,kx", [(256, 2048, 256), (1024, 2048, 1024), (1024, 1536, 1024)])
def test_tf32_tile_packing_at_the_set_widths(C, K, kx):
    """The same index formula at the f32 set's other widths and its widest
    inputs: chunk (g, st) of the 64 columns [64 g, 64 g + 64) (a CTA's, or
    one warpgroup's of it, in the wide kernel), with the skip rows after
    the x rows of every chunk column."""
    rng = np.random.default_rng(C + K)
    w = torch.from_numpy(rng.normal(size=(K, C)).astype(np.float32))
    parts = [t.numpy() for t in trb.tf32_split(w)]
    packed = trb.pack_tf32_tiles(w).reshape(C // 64, K // 32, 2, 2048).numpy()
    g, st, p = np.meshgrid(np.arange(C // 64), np.arange(K // 32), np.arange(2048), indexing="ij")
    kappa = 4 * (p // 256) + p % 4
    k = 32 * st + 8 * (kappa % 4) + 2 * (kappa // 8) + (kappa // 4) % 2
    col = 64 * g + 8 * ((p // 32) % 8) + (p // 4) % 8
    for part in (0, 1):
        assert np.array_equal(packed[:, :, part], parts[part][k, col])
    assert (k[:, : kx // 32] < kx).all() and (k[:, kx // 32:] >= kx).all()
    assert np.unique(k * C + col).size == K * C   # every element once


def test_tf32_split_rounds_to_nearest_away_and_leaves_2e_22():
    """The plain twin of the kernel's split (cvt.rna.tf32.f32 twice): hi and
    lo keep 10 mantissa bits (the 13 low bits are zero), hi is v rounded to
    nearest with ties away from zero, and |v - hi - lo| <= 2^-22 |v|."""
    rng = np.random.default_rng(11)
    v = (rng.normal(size=4096) * 10.0 ** rng.uniform(-20, 20, size=4096)).astype(np.float32)
    ties = np.float32(1.0) + np.float32(2.0 ** -11) * np.arange(1, 64, 2, dtype=np.float32)
    v = np.concatenate([v, ties, -ties, np.float32([0.1, -3.3, np.pi])])
    hi, lo = trb.tf32_split(torch.from_numpy(v))
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    v64, hi64, lo64 = v.astype(np.float64), hi.double().numpy(), lo.double().numpy()
    # hi against rounding in f64: |v| in units of its tf32 spacing, halves away
    ulp = 2.0 ** (np.floor(np.log2(np.abs(v64))) - 10)
    assert np.array_equal(hi64, np.sign(v64) * np.floor(np.abs(v64) / ulp + 0.5) * ulp)
    assert (np.abs(v64 - hi64 - lo64) <= 2.0 ** -22 * np.abs(v64)).all()
    # ties go away from zero: 1 + 2^-11 -> 1 + 2^-10
    assert hi[4096].item() == 1.0 + 2.0 ** -10 and hi[4096 + 32].item() == -(1.0 + 2.0 ** -10)


def test_three_tf32_products_hold_f32_accuracy_at_k1024():
    """hi*hi + hi*lo + lo*hi, the kernel's product, against the f64 product
    at K=1024 (the skip blocks' depth), each term exact in f64: its error
    is at most 2^-20 sum_k |a_k b_k| (per term v w - (hi hi' + hi lo' +
    lo hi') is at most about 3 x 2^-22 |v w|).  One pass, hi*hi alone,
    errs about 2^-12 relative, hundreds of times more."""
    rng = np.random.default_rng(12)
    a = torch.from_numpy(rng.normal(size=(48, 1024)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(1024, 64)).astype(np.float32))
    (ah, al), (bh, bl) = trb.tf32_split(a), trb.tf32_split(b)
    d = lambda t: t.double()   # noqa: E731
    exact = d(a) @ d(b)
    scale = d(a).abs() @ d(b).abs()
    split = d(ah) @ d(bh) + d(ah) @ d(bl) + d(al) @ d(bh)
    assert ((split - exact).abs() / scale).max().item() <= 2.0 ** -20
    one_pass = ((d(ah) @ d(bh) - exact).abs() / scale).max().item()
    assert one_pass > 100 * ((split - exact).abs() / scale).max().item()


# (N, kx, ks, B) -> (scenes per tile, clusters, CTAs); every width takes 5
# ring stages and 224,272 bytes of shared memory a CTA
F32_PLANS = {
    (12, 512, 0, 64): (5, 13, 104), (12, 512, 512, 64): (5, 13, 104),
    (12, 512, 0, 63): (5, 13, 104), (12, 512, 512, 63): (5, 13, 104),
    (12, 512, 0, 256): (5, 52, 416), (12, 512, 512, 256): (5, 52, 416),
    (12, 512, 0, 768): (5, 154, 1232), (12, 1024, 0, 768): (5, 154, 1232),
    (21, 512, 0, 64): (3, 22, 176), (21, 512, 512, 64): (3, 22, 176),
    (21, 512, 0, 63): (3, 21, 168), (21, 1024, 0, 63): (3, 21, 168),
    (21, 512, 0, 256): (3, 86, 688), (21, 512, 512, 256): (3, 86, 688),
    (21, 512, 0, 768): (3, 256, 2048), (21, 512, 512, 768): (3, 256, 2048),
}


@pytest.mark.parametrize("case", list(F32_PLANS))
def test_f32_tile_plan_at_flagship_shapes(case):
    """The f32 kernel's launch: whole scenes in 64-row tiles (the wgmma M),
    one cluster of 8 CTAs a tile, and a CTA's shared memory (the ring of
    split chunks, 8 slots of 64 rows) within the H100's 232,448 bytes (the
    library checks the same sum against the .cu when it loads)."""
    N, kx, ks, B = case
    plan = trb.tile_plan(B, N, kx, ks, torch.float32)
    assert tuple(plan) == F32_PLANS[case] + (5, 224272)
    assert plan.scenes_per_tile * N <= trb.TILE_ROWS < (plan.scenes_per_tile + 1) * N
    assert plan.clusters * plan.scenes_per_tile >= B > (plan.clusters - 1) * plan.scenes_per_tile
    assert plan.smem_bytes <= trb.SMEM_LIMIT


@pytest.mark.parametrize("C", trb.SET_CHANNELS)
def test_f32_plans_of_the_set_fit(C):
    """Every f32 plan of the set: C=512 in 8 groups (with a projection, or
    an identity residual over x) on resblock_tf32, every other (C, groups)
    and an identity residual over [x | skip] on the wide kernel, whose
    cluster is C / 64 / warpgroups CTAs (4 or 8); one CTA's shared memory
    within the H100's 232,448 bytes at every width (the library checks the
    same sums against the .cu when it loads)."""
    for groups in trb.SET_GROUPS:
        if C // groups < trb.MIN_GROUP:
            assert not trb.takes(C, groups, C)
            continue
        for kx, ks in ((C, 0), (C // 2, C // 2), (C, 2048 - C), (64, 0)):
            res = kx + ks != C
            assert trb.takes(C, groups, kx, ks, 12)
            plan = trb.tile_plan(64, 12, kx, ks, torch.float32, C, groups, res)
            kernel = trb.kernel_name(torch.float32, C, groups, kx, ks, res)
            if kernel == "resblock_tf32":
                assert (C, groups) == (512, 8) and (res or not ks)
                assert tuple(plan) == (5, 13, 104, 5, 224272)
            else:
                wg = trb.wide_warpgroups(C)
                assert wg == (2 if C == 1024 else 1)
                assert tuple(plan) == (5, 13, 13 * C // 64 // wg, trb.WIDE_STAGES,
                                       75584 if wg == 1 else 151104)
            assert plan.smem_bytes <= trb.SMEM_LIMIT
    assert not trb.takes(C, 8, C, 2112 - C) and not trb.takes(C, 8, C, 0, 65)


@pytest.mark.parametrize("C", trb.SET_CHANNELS)
def test_bf16_plans_of_the_set_fit(C):
    """Every bf16 plan of the same set: C=512 in 8 groups with inputs of a
    multiple of 128 columns up to 1024 (a projection, or an identity
    residual over x) on resblock_sm90, exactly the shapes it took before
    the widening; every other block of the set on resblock_bf16_wide, a
    cluster of C / 64 / warpgroups CTAs with a ring of 4 stages of 8 KB
    chunks a warpgroup (42,816 or 85,568 bytes a CTA, within the H100's
    232,448)."""
    bf = torch.bfloat16
    for groups in trb.SET_GROUPS:
        if C // groups < trb.MIN_GROUP:
            continue
        for kx, ks in ((C, 0), (C // 2, C // 2), (C, 2048 - C), (64, 0), (C + 64, 0),
                       (C, 1024 - C)):
            res = kx + ks != C
            plan = trb.tile_plan(64, 12, kx, ks, bf, C, groups, res)
            kernel = trb.kernel_name(bf, C, groups, kx, ks, res)
            cluster8 = ((C, groups) == (512, 8) and (res or not ks) and (kx + ks) % 128 == 0
                        and kx + ks <= 1024)
            assert kernel == ("resblock_sm90" if cluster8 else "resblock_bf16_wide")
            if cluster8:
                assert plan.ctas == 104 and plan.smem_bytes in (102344, 200648)
            else:
                wg = trb.wide_warpgroups(C)
                assert tuple(plan) == (5, 13, 13 * C // 64 // wg, trb.WIDE_STAGES,
                                       42816 if wg == 1 else 85568)
            assert plan.smem_bytes <= trb.SMEM_LIMIT


# Unet1D widths and the compute dtype -> whether the card's 3-D engine
# takes the model (models/inference.py:check_card_widths, one set for both
# dtypes)
CARD_MODELS = {"f32_wide": (dict(dim_mults=(1, 1, 2, 2)), torch.float32, True),
               "f32_groups16": (dict(resnet_block_groups=16), torch.float32, True),
               "bf16_wide": (dict(dim_mults=(1, 1, 2, 2)), torch.bfloat16, True),
               "bf16_groups16": (dict(resnet_block_groups=16), torch.bfloat16, True),
               "f32_dim64": (dict(dim=64), torch.float32, False),
               "bf16_dim64": (dict(dim=64), torch.bfloat16, False)}


@pytest.mark.parametrize("case", list(CARD_MODELS))
def test_card_width_check_is_per_dtype(case):
    """The 3-D engine's check on the card, run in each dtype, is one rule
    for both: a model inside the kernels' set passes (the [1, 1, 2, 2]
    flagship's 28 blocks and mid_attn at C=1024; the flagship in 16
    groups), in f32 and in bf16; a model outside the set (dim 64) raises
    the ValueError naming fused=False in either dtype.  The [1, 1, 2, 2]
    flagship's blocks are the 28 of the JAX Unet1D: 10 at C=512 over 512
    inputs, 7 at C=512 over 1024 (projections), 8 at C=1024 over at most
    1024, 3 at C=1024 over wider skip inputs."""
    from diffuscene_tpu_torch.models import Unet1D
    from diffuscene_tpu_torch.models.inference import block_shapes, check_card_widths

    kw, dt, taken = CARD_MODELS[case]
    net = Unet1D(**{"dim": 512, "channels": 62, "objfeat_dim": 32, **kw}, compute_dtype=dt,
                 device="meta")
    if taken:
        check_card_widths(net)
    else:
        with pytest.raises(ValueError, match="fused=False"):
            check_card_widths(net)
    if kw.get("dim_mults") == (1, 1, 2, 2):
        shapes = block_shapes(net)
        kinds = {"512 over 512": sum(s == (512, 512, 0) for s in shapes),
                 "512 over 1024": sum(c == 512 and x + k == 1024 for c, x, k in shapes),
                 "1024 over <=1024": sum(c == 1024 and x + k <= 1024 for c, x, k in shapes),
                 "1024 over wider": sum(c == 1024 and x + k > 1024 for c, x, k in shapes)}
        assert kinds == {"512 over 512": 10, "512 over 1024": 7, "1024 over <=1024": 8,
                         "1024 over wider": 3}


# (C, x width, skip width, rows a scene, groups); the cases without a
# prefix are bf16.  groups16, c1024, identity_skip, cin_not_128 and
# f32_groups16 are in the set since the wide kernels (one set for both
# dtypes), and each case that left the refused set has one beside it that
# is still outside
REFUSED = {"c64": (64, 64, 0, 12, 8), "groups16": (512, 512, 0, 12, 16),
           "cx_not_64": (512, 528, 0, 12, 8), "cin_not_128": (512, 576, 0, 12, 8),
           "rows65": (512, 512, 0, 65, 8), "c1024": (1024, 1024, 0, 12, 8),
           "identity_skip": (512, 256, 256, 12, 8),
           "c384": (384, 384, 0, 12, 8), "c256_groups32": (256, 256, 0, 12, 32),
           "cin2112": (1024, 1024, 1088, 12, 8),
           "f32_rows65": (512, 512, 0, 65, 8), "f32_c64": (64, 64, 0, 12, 8),
           "f32_groups16": (512, 512, 0, 12, 16), "f32_cx_not_64": (512, 528, 0, 12, 8),
           "f32_c384": (384, 384, 0, 12, 8), "f32_c256_groups32": (256, 256, 0, 12, 32),
           "f32_cin2112": (1024, 1024, 1088, 12, 8)}
TAKEN = {"f32_groups16", "groups16", "c1024", "identity_skip", "cin_not_128"}


@pytest.mark.parametrize("case", list(REFUSED))
def test_kernel_path_refuses_shapes_it_does_not_take(case):
    """No fallback: what the kernels do not take raises before any launch.
    One set for both dtypes: C in (256, 512, 1024) in 4, 8, 16 or 32 groups
    of at least 16 channels, input widths of multiples of 64 up to 2048
    together, scenes of at most 64 rows; a case of the set (TAKEN) passes
    the shape check that the launch path runs, and is routed to a kernel
    of its dtype (bf16 outside resblock_sm90's shapes to the wide one)."""
    C, kx, ks, n, groups = REFUSED[case]
    dt = torch.float32 if case.startswith("f32_") else torch.bfloat16
    has_res = kx + ks != C
    if case in TAKEN:
        trb.check_kernel_shapes(C, groups, kx, ks, n, has_res, dt)
        want = "resblock_tf32_wide" if dt == torch.float32 else "resblock_bf16_wide"
        assert trb.kernel_name(dt, C, groups, kx, ks, has_res) == want
        return
    x = torch.zeros(n, kx, dtype=dt)
    skip = torch.zeros(n, ks, dtype=dt) if ks else None
    w1, w2 = torch.zeros(kx + ks, C), torch.zeros(C, C)
    v = torch.zeros(C)
    w_res = torch.zeros(kx + ks, C) if has_res else None
    with pytest.raises(ValueError):
        trb._launch_kernel(x, skip, None, w1, v, v, v, w2, v, v, v, w_res, v, n, groups, 1e-6, dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_library_agrees_with_the_plan(dtype):
    """The library's limits and shared-memory sums equal the wrapper's
    (load_library raises otherwise), and enough clusters of each kernel
    fit on the card to run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    from diffuscene_tpu_torch.ops import build

    tdt = DTYPES[dtype][1]
    code = build.DTYPE_CODES[tdt]
    lib = trb.load_library()
    shapes = [(512, 8, kx, ks) for kx, ks in ((512, 0), (1024, 0), (512, 512))]
    shapes += [(C, g, C, ks) for C in trb.SET_CHANNELS for g in trb.SET_GROUPS
               for ks in (0, 2048 - C) if C // g >= trb.MIN_GROUP]
    for C, g, kx, ks in shapes:
        res = int(kx + ks != C)
        assert (lib.fused_resblock_smem_bytes(code, C, g, kx, ks, res)
                == trb.tile_plan(64, 12, kx, ks, tdt, C, g).smem_bytes)
        assert lib.fused_resblock_max_active_clusters(code, C, g, kx, ks, res) >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("B", [7, 256])
@pytest.mark.parametrize("N", [12, 21])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c_in,film", [(512, "row"), (512, "none"), (1024, "scene")])
def test_cuda_kernel_matches_plain_version(c_in, film, dtype, N, B):
    """The CUDA kernel against its plain version on the card, C=512, at a
    ragged last tile (7 scenes: tiles of 5 scenes of 12 or 3 of 21) and at
    run/generate.sh's batch (256)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    d = _case(B, N, c_in, seed=6, c=512)
    tdt = DTYPES[dtype][1]
    dev = torch.device("cuda")
    t = {k: torch.from_numpy(v).to(dev) for k, v in d.items()}
    f = {"row": t["film"], "scene": t["film"][::N].contiguous(), "none": None}[film]
    kw = dict(w_res=t.get("w_res"), b_res=t.get("b_res"), n_per_scene=N, compute_dtype=tdt)
    x = t["x"].to(tdt)
    skip = None
    if c_in == 1024:
        x, skip = x[:, :512].contiguous(), x[:, 512:].contiguous()
    args = (x, f, *(t[k] for k in _WEIGHTS))
    got = trb.fused_resnet_block(*args, skip=skip, **kw)
    want = trb.fused_resnet_block_reference(*args, skip=skip, **kw)
    torch.cuda.synchronize()
    tol = dict(atol=1e-3, rtol=1e-4) if dtype == "f32" else dict(atol=1e-1, rtol=5e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("C,groups", [(256, 8), (512, 4), (512, 16), (1024, 8)])
def test_cuda_wide_kernel_matches_plain_version(C, groups, dtype):
    """The wide kernel of each dtype against its plain version on the card,
    at a ragged last tile: an identity residual over [x | skip] with
    per-row film, and a 2048-wide skip input through the projection with
    per-scene film."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    dev = torch.device("cuda")
    tdt = DTYPES[dtype][1]
    tol = dict(atol=1e-3, rtol=1e-4) if dtype == "f32" else dict(atol=1e-1, rtol=5e-2)
    for kx, ks, film, N in ((C // 2, C // 2, "row", 12), (C, 2048 - C, "scene", 21)):
        d = _case(7, N, kx + ks, seed=C + groups + ks, c=C)
        t = {k: torch.from_numpy(v).to(dev) for k, v in d.items()}
        f = t["film"] if film == "row" else t["film"][::N].contiguous()
        x = t["x"].to(tdt)
        x, skip = x[:, :kx].contiguous(), x[:, kx:].contiguous()
        kw = dict(w_res=t.get("w_res"), b_res=t.get("b_res"), n_per_scene=N, groups=groups,
                  compute_dtype=tdt, skip=skip)
        args = (x, f, *(t[k] for k in _WEIGHTS))
        got = trb.fused_resnet_block(*args, **kw)
        want = trb.fused_resnet_block_reference(*args, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **tol)
