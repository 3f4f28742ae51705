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


def _run_jax(d, N, dtype):
    jdt = DTYPES[dtype][0]
    kw = {k: jnp.asarray(d[k]) for k in _WEIGHTS}
    if "w_res" in d:
        kw.update(w_res=jnp.asarray(d["w_res"]), b_res=jnp.asarray(d["b_res"]))
    out = jrb.fused_resnet_block(jnp.asarray(d["x"]).astype(jdt), jnp.asarray(d["film"]),
                                 n_per_scene=N, groups=GROUPS, compute_dtype=jdt, **kw)
    return np.asarray(out.astype(jnp.float32))


def _run_torch(d, N, dtype, film=None, skip_split=None):
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
    out = trb.fused_resnet_block(x, film, n_per_scene=N, groups=GROUPS, compute_dtype=tdt,
                                 skip=skip, **kw)
    assert out.dtype == tdt and out.shape == (d["x"].shape[0], C)
    return out.float().numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c_in", [C, 2 * C])
@pytest.mark.parametrize("N", [12, 21])
def test_block_matches_jax_pallas(N, c_in, dtype):
    """C_in = C: identity residual; C_in = 2C: the skip-concat shape, with
    its residual projection."""
    d = _case(2, N, c_in, seed=N + c_in)
    np.testing.assert_allclose(_run_torch(d, N, dtype), _run_jax(d, N, dtype), **TOL[dtype])


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
    with pytest.raises(ValueError):   # neither 64-deep tiles nor 512 columns
        trb.pack_group_tiles(w[:, :256])


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


@pytest.mark.parametrize("case", ["c64", "groups16", "cx_not_64", "cin_not_128", "rows65",
                                  "f32_rows25"])
def test_kernel_path_refuses_shapes_it_does_not_take(case):
    """No fallback: what the kernels do not take raises before any launch
    (the bf16 kernel: C=512 in 8 groups, input widths of multiples of 64
    summing to a multiple of 128, scenes of at most 64 rows; the f32
    kernel: scenes of at most 24 rows)."""
    C, c_in, n, groups, dt = 512, 512, 12, 8, torch.bfloat16
    if case == "c64":
        C, c_in = 64, 64
    elif case == "groups16":
        groups = 16
    elif case == "cx_not_64":
        c_in = 528
    elif case == "cin_not_128":
        c_in = 576
    elif case == "rows65":
        n = 65
    else:
        n, dt = 25, torch.float32
    x = torch.zeros(n, c_in, dtype=dt)
    w1, w2 = torch.zeros(c_in, C), torch.zeros(C, C)
    v = torch.zeros(C)
    w_res = None if c_in == C else torch.zeros(c_in, C)
    with pytest.raises(ValueError):
        trb._launch_kernel(x, None, None, w1, v, v, v, w2, v, v, v, w_res, v, n, groups, 1e-6, dt)


@pytest.mark.gpu
def test_cuda_library_agrees_with_the_plan():
    """The library's limits and shared-memory sums equal the wrapper's
    (load_library raises otherwise), and enough clusters of the bf16 kernel
    fit on the card to run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    lib = trb.load_library()
    for kx, ks in ((512, 0), (1024, 0), (512, 512)):
        assert lib.fused_resblock_smem_bytes(kx, ks) == trb.tile_plan(64, 12, kx, ks).smem_bytes
        assert lib.fused_resblock_max_active_clusters(kx, ks, int(kx + ks != 512)) >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("N", [12, 21])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c_in,film", [(512, "row"), (512, "none"), (1024, "scene")])
def test_cuda_kernel_matches_plain_version(c_in, film, dtype, N):
    """The CUDA kernel against its plain version on the card, C=512, a
    ragged last tile (7 scenes: tiles of 5 scenes of 12, of 3 of 21)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    B = 7
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
