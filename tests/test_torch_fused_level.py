"""Parity of the port's resblock chain (diffuscene_tpu_torch/ops/fused_level.py)
with the JAX package's chain kernel (diffuscene_tpu/ops/fused_level.py).

On the CPU the port's ``apply_chain`` runs its plain torch version; the JAX
side runs the Pallas kernel in interpret mode, as its own tests do.  The
same numpy inputs, made from a seed, go to both.  Tolerances: f32 atol 1e-4
(f32 products and sums in another order); bf16 atol = rtol = 5e-2, the JAX
package's own bf16 chain tolerance (tests/test_fused_level.py).

The CUDA kernel itself runs only on the card: see ``chip_smoke.py`` and the
``gpu``-marked test at the end.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuscene_tpu.ops import fused_level as jfl
from diffuscene_tpu_torch.ops import fused_level as tfl
from diffuscene_tpu_torch.ops import fused_resblock as trb
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


GROUPS = 8
C = 64

# (name, per-block (film, has_skip, has_res_proj)): every block kind the
# flagship's 19 chains use, plus an un-filmed block and a projected residual
VARIANTS = {
    "none": [("none", False, False)],
    "scene_res": [("scene", False, True)],
    "row_scene": [("row", False, False), ("scene", False, False)],
    "skip": [("scene", True, True)],
    "row_skip": [("row", False, False), ("scene", True, True)],
}


def _case(variant, B, N, seed=0, C=C):
    """numpy inputs for one chain: x, films, skips and build_chain weights."""
    rng = np.random.default_rng(seed)
    M = B * N
    x = (rng.normal(size=(M, C)) * 0.5).astype(np.float32)
    blocks, weights, films, skips = [], [], [], []
    for film, has_skip, res in VARIANTS[variant]:
        blocks.append((film, has_skip, res))
        wd = {"w1": rng.normal(size=(C, C)) / np.sqrt(2 * C),
              "w2": rng.normal(size=(C, C)) / np.sqrt(C)}
        if has_skip:
            wd["w1s"] = rng.normal(size=(C, C)) / np.sqrt(2 * C)
        if res:
            wd["wres"] = rng.normal(size=(C, C)) / np.sqrt(2 * C)
            wd["bres"] = rng.normal(size=C) * 0.1
            if has_skip:
                wd["wres_s"] = rng.normal(size=(C, C)) / np.sqrt(2 * C)
        for k in ("b1", "b2", "gn1_bias", "gn2_bias"):
            wd[k] = rng.normal(size=C) * 0.1
        for k in ("gn1_scale", "gn2_scale"):
            wd[k] = 1.0 + rng.normal(size=C) * 0.1
        weights.append({k: v.astype(np.float32) for k, v in wd.items()})
        if film == "scene":
            films.append((rng.normal(size=(B, 2 * C)) * 0.2).astype(np.float32))
        elif film == "row":
            films.append((rng.normal(size=(M, 2 * C)) * 0.2).astype(np.float32))
        else:
            films.append(None)
        skips.append((rng.normal(size=(M, C)) * 0.5).astype(np.float32) if has_skip else None)
    return x, blocks, weights, films, skips


def _run_jax(case, N, dtype, backend, groups=GROUPS):
    x, blocks, weights, films, skips = case
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    chain = jfl.build_chain(
        [jfl.ChainBlock(has_skip=s, film=f, has_res_proj=r) for f, s, r in blocks],
        [{k: jnp.asarray(v) for k, v in w.items()} for w in weights], compute_dtype=jdt)
    cast = lambda a: None if a is None else jnp.asarray(a).astype(jdt)  # noqa: E731
    B = x.shape[0] // N
    out = jfl.apply_chain(chain, cast(x), [cast(f) for f in films], [cast(s) for s in skips],
                          n_per_scene=N, groups=groups, tile_scenes=B, backend=backend)
    return np.asarray(out.astype(jnp.float32))


def _run_torch(case, N, dtype, groups=GROUPS):
    x, blocks, weights, films, skips = case
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    chain = tfl.build_chain(
        [tfl.ChainBlock(has_skip=s, film=f, has_res_proj=r) for f, s, r in blocks],
        [{k: torch.from_numpy(v) for k, v in w.items()} for w in weights], compute_dtype=tdt)
    cast = lambda a: None if a is None else torch.from_numpy(a).to(tdt)  # noqa: E731
    out = tfl.apply_chain(chain, cast(x), [cast(f) for f in films], [cast(s) for s in skips],
                          n_per_scene=N, groups=groups)
    return out.float().numpy()


TOL = {"f32": dict(atol=1e-4, rtol=0), "bf16": dict(atol=5e-2, rtol=5e-2)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("N,B", [(12, 8), (21, 16)])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_chain_matches_jax_pallas(variant, N, B, dtype):
    """N=21 needs B=16: the Pallas tiling takes whole scenes in tiles of a
    multiple of 16 rows."""
    case = _case(variant, B, N, seed=list(VARIANTS).index(variant) + N)
    want = _run_jax(case, N, dtype, backend="pallas")
    got = _run_torch(case, N, dtype)
    np.testing.assert_allclose(got, want, **TOL[dtype])


# the edges of the set the card's kernels take (tfl.takes: C 256, 512,
# 1024 in 4-32 groups of at least 16 channels): (C, groups)
SET_EDGES = [(256, 16), (512, 4), (512, 32), (1024, 4)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("width,groups", SET_EDGES)
def test_chain_set_edges_match_jax_pallas(width, groups, dtype):
    """The plain chain at the set's edges against the JAX Pallas chain: a
    two-block row_skip chain, B=4 scenes of 12 rows (one tile of 48 rows,
    a multiple of 16 as the Pallas tiling needs)."""
    case = _case("row_skip", 4, 12, seed=width + groups, C=width)
    want = _run_jax(case, 12, dtype, backend="pallas", groups=groups)
    got = _run_torch(case, 12, dtype, groups=groups)
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("variant", ["row_skip", "scene_res"])
def test_chain_any_batch_matches_jax_xla(variant):
    """B=3 scenes of 21 rows: the JAX Pallas tiling rejects it, the port takes
    any B; compared with the JAX package's plain XLA chain."""
    case = _case(variant, 3, 21, seed=5)
    want = _run_jax(case, 21, "f32", backend="xla")
    got = _run_torch(case, 21, "f32")
    np.testing.assert_allclose(got, want, **TOL["f32"])


def test_wrapper_validates_and_counts_only_kernel_launches():
    case = _case("row_skip", 2, 12)
    before = tfl.apply_chain.launches
    _run_torch(case, 12, "f32")
    assert tfl.apply_chain.launches == before  # the CPU path is not a launch
    x, blocks, weights, films, skips = case
    chain = tfl.build_chain(
        [tfl.ChainBlock(has_skip=s, film=f, has_res_proj=r) for f, s, r in blocks],
        [{k: torch.from_numpy(v) for k, v in w.items()} for w in weights],
        compute_dtype=torch.float32)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    with pytest.raises(ValueError):  # film missing for a "row" block
        tfl.apply_chain(chain, t(x), [None, t(films[1])], [t(s) for s in skips], n_per_scene=12)
    with pytest.raises(ValueError):  # rows that are not whole scenes
        tfl.apply_chain(chain, t(x)[:-1], [t(f) for f in films], [t(s) for s in skips],
                        n_per_scene=12)
    with pytest.raises(ValueError):  # neither cpu nor cuda: no silent fallback
        tfl.apply_chain(chain, t(x).to("meta"), [t(f) for f in films],
                        [t(s) for s in skips], n_per_scene=12)
    with pytest.raises(ValueError):
        tfl.ChainBlock(has_skip=True, film="scene", has_res_proj=False)


def _blocks(variant):
    return [tfl.ChainBlock(has_skip=s, film=f, has_res_proj=r) for f, s, r in VARIANTS[variant]]


# (N, B) -> (scenes per tile, clusters); every chain without a skip takes 4
# ring stages and 104,216 bytes of shared memory a CTA, with one 8 and 203,544
TILES = {(12, 64): (5, 13), (12, 63): (5, 13), (12, 768): (5, 154),
         (21, 64): (3, 22), (21, 63): (3, 21), (21, 768): (3, 256)}


@pytest.mark.parametrize("N,B", list(TILES))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_tile_plan_at_flagship_shapes(variant, N, B):
    """The bf16 kernel's launch: whole scenes in 64-row tiles, one cluster
    of 8 CTAs a tile, and a CTA's shared memory within the H100's 232,448
    bytes (the library checks the same sum against the .cu when it loads)."""
    plan = tfl.tile_plan(B, N, _blocks(variant))
    skip = any(s for _, s, _ in VARIANTS[variant])
    ts, clusters = TILES[(N, B)]
    assert tuple(plan) == (ts, clusters, 8 * clusters, 8 if skip else 4,
                           203544 if skip else 104216, None)
    assert plan.scenes_per_tile * N <= trb.TILE_ROWS < (plan.scenes_per_tile + 1) * N
    assert plan.clusters * plan.scenes_per_tile >= B > (plan.clusters - 1) * plan.scenes_per_tile
    assert plan.smem_bytes <= trb.SMEM_LIMIT


@pytest.mark.parametrize("variant", ["skip", "row_skip"])
def test_chain_weight_packing_matches_index_formula(variant):
    """Element (group g, weight w, K tile q, position p) of the bf16 kernel's
    packed chain weights is W[w][64 q + 8 (p // 512) + p % 8, 64 g + 8 ((p //
    64) % 8) + (p // 8) % 8]: core matrices of 8 columns x 8 k values, 128
    bytes apart in n and 1024 in k (csrc/sm90.cuh), each group's chunks of
    the whole chain contiguous, the stack's order w1, [w1s], w2, [wres,
    [wres_s]] kept, so the skip halves W1s and Wres_s are weights of their
    own."""
    C = trb.CHANNELS
    names = []
    for _, has_skip, res in VARIANTS[variant]:
        names += ["w1"] + ["w1s"] * has_skip + ["w2"] + ["wres"] * res + ["wres_s"] * (has_skip and res)
    base = {k: torch.zeros(C) for k in ("b1", "b2", "gn1_bias", "gn2_bias", "gn1_scale",
                                       "gn2_scale", "bres")}
    weights, i = [], 0
    for _, has_skip, res in VARIANTS[variant]:
        wd = dict(base)
        for k in ["w1"] + ["w1s"] * has_skip + ["w2"] + ["wres"] * res + ["wres_s"] * (has_skip and res):
            # every element of the stack distinct
            wd[k] = torch.arange(C * C, dtype=torch.float64).reshape(C, C) + i * C * C
            i += 1
        weights.append(wd)
    chain = tfl.build_chain(_blocks(variant), weights, compute_dtype=torch.float64)
    nW = chain.W.shape[0]
    assert nW == len(names)
    packed = tfl.pack_chain_weights(chain.W).reshape(C // 64, nW, 8, 4096)
    g, w, q, p = np.meshgrid(np.arange(C // 64), np.arange(nW), np.arange(8), np.arange(4096),
                             indexing="ij")
    k = 64 * q + 8 * (p // 512) + p % 8
    col = 64 * g + 8 * ((p // 64) % 8) + (p // 8) % 8
    assert np.array_equal(packed.numpy(), chain.W.numpy()[w, k, col])
    # the order of the stack: weight w holds the values made w-th
    assert np.array_equal(packed.numpy()[0, :, 0, 0] // (C * C), np.arange(nW))


@pytest.mark.parametrize("variant", ["skip", "row_skip"])
def test_f32_chain_weight_packing_matches_index_formula(variant):
    """The f32 kernel's packed chain weights: the 32-deep step st of weight w
    for group g is the 4096 floats from (g * 16 nW + 16 w + st) * 4096, its
    tf32 hi (part 0) then lo (part 1), each CTA's chunks of the whole chain
    contiguous; within a part, position p holds W[w][32 st + k, col] with
    kappa = 4 (p // 256) + p % 4, k = 8 (kappa % 4) + 2 (kappa // 8) +
    (kappa // 4) % 2 and col = 64 g + 8 ((p // 32) % 8) + (p // 4) % 8, the
    layout of pack_tf32_tiles (tests/test_torch_fused_resblock.py)."""
    C = trb.CHANNELS
    rng = np.random.default_rng(len(variant))
    base = {k: torch.zeros(C) for k in ("b1", "b2", "gn1_bias", "gn2_bias", "gn1_scale",
                                       "gn2_scale", "bres")}
    weights = [dict(base, **{k: torch.from_numpy(rng.normal(size=(C, C)).astype(np.float32))
                             for k in ("w1", "w1s", "w2", "wres", "wres_s")})
               for _ in VARIANTS[variant]]
    chain = tfl.build_chain(_blocks(variant), weights, compute_dtype=torch.float32)
    nW = chain.W.shape[0]
    packed = tfl.pack_chain_weights(chain.W)
    assert packed.numel() == 2 * chain.W.numel()
    packed = packed.reshape(C // 64, nW, 16, 2, 2048).numpy()
    parts = [t.numpy() for t in trb.tf32_split(chain.W)]
    g, w, st, p = np.meshgrid(np.arange(C // 64), np.arange(nW), np.arange(16), np.arange(2048),
                              indexing="ij")
    kappa = 4 * (p // 256) + p % 4
    k = 32 * st + 8 * (kappa % 4) + 2 * (kappa // 8) + (kappa // 4) % 2
    col = 64 * g + 8 * ((p // 32) % 8) + (p // 4) % 8
    for part in (0, 1):
        assert np.array_equal(packed[:, :, :, part], parts[part][w, k, col])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["bf16_layout", "f32"])
def test_wide_chain_weight_packing_matches_index_formula(dtype):
    """The wide kernels' packed chain weights at C=256 (a row_skip chain, 5
    weights): with S = C / 32 (f32) or C / 64 (bf16) K steps a weight, the
    step st of weight w for group g is the 4096 values from (g * S nW + S w
    + st) * 4096.  bf16 (the layout checked in f64, every value exact):
    position p holds W[w][64 st + 16 t + 4 j + 2 h + e, col], k = 8 (p //
    512) + p % 8 = 16 j + 8 h + 2 t + e (the K tile's rows permuted) and col
    = 64 g + 8 ((p // 64) % 8) + (p // 8) % 8.  f32: the pack_tf32_tiles
    layout at this C, tf32 hi then lo.  A skip block's w1 and w1s (wres and
    wres_s) are consecutive, the (2C, C) [x | skip] weight's K steps in
    one run."""
    C = 256
    base = {k: torch.zeros(C) for k in ("b1", "b2", "gn1_bias", "gn2_bias", "gn1_scale",
                                       "gn2_scale", "bres")}
    weights, i = [], 0
    for _, has_skip, res in VARIANTS["row_skip"]:
        wd = dict(base)
        names = ["w1"] + ["w1s"] * has_skip + ["w2"] + ["wres"] * res
        for k in names + ["wres_s"] * (has_skip and res):
            wd[k] = (torch.arange(C * C, dtype=torch.float64).reshape(C, C) + i * C * C) / (C * C)
            i += 1
        weights.append(wd)
    chain = tfl.build_chain(_blocks("row_skip"), weights, compute_dtype=dtype)
    nW = chain.W.shape[0]
    packed = tfl.pack_chain_weights(chain.W, permuted=True)
    if dtype == torch.float32:
        S = C // 32
        packed = packed.reshape(C // 64, nW, S, 2, 2048).numpy()
        parts = [t.numpy() for t in trb.tf32_split(chain.W)]
        g, w, st, p = np.meshgrid(np.arange(C // 64), np.arange(nW), np.arange(S),
                                  np.arange(2048), indexing="ij")
        kappa = 4 * (p // 256) + p % 4
        k = 32 * st + 8 * (kappa % 4) + 2 * (kappa // 8) + (kappa // 4) % 2
        col = 64 * g + 8 * ((p // 32) % 8) + (p // 4) % 8
        for part in (0, 1):
            assert np.array_equal(packed[:, :, :, part], parts[part][w, k, col])
        return
    S = C // 64
    packed = packed.reshape(C // 64, nW, S, 4096).numpy()
    g, w, st, p = np.meshgrid(np.arange(C // 64), np.arange(nW), np.arange(S), np.arange(4096),
                              indexing="ij")
    k = 8 * (p // 512) + p % 8
    j, h, t, e = k // 16, (k // 8) % 2, (k // 2) % 4, k % 2
    col = 64 * g + 8 * ((p // 64) % 8) + (p // 8) % 8
    assert np.array_equal(packed, chain.W.numpy()[w, 64 * st + 16 * t + 4 * j + 2 * h + e, col])
    # the stack's order: weight w holds the values made w-th
    assert np.array_equal(np.floor(packed[0, :, 0, 0]), np.arange(nW))


# (C, groups) -> (CTAs a cluster, f32 and bf16 shared memory a CTA) of the
# wide kernels: 1 consumer warpgroup a CTA, 2 at C=1024; the same for every
# chain and grouping
WIDE_PLANS = {(256, 8): (4, 77376, 44608), (256, 16): (4, 77376, 44608),
              (512, 4): (8, 77376, 44608), (512, 32): (8, 77376, 44608),
              (1024, 4): (8, 154688, 89152), (1024, 16): (8, 154688, 89152)}


@pytest.mark.parametrize("width,groups", list(WIDE_PLANS))
def test_wide_tile_plan(width, groups):
    """The wide kernels' launch (every chain but C=512 in 8 groups): whole
    scenes in 64-row tiles, one cluster of C / 64 / warpgroups CTAs a tile,
    4 ring stages, a CTA's shared memory (the ring, 14 vectors, the
    moments' partial sums) within the H100's 232,448 bytes, the library
    checks the same sum when it loads."""
    ctas, f32, bf16 = WIDE_PLANS[(width, groups)]
    for dtype, smem, kernel in ((torch.float32, f32, "chain_tf32_wide"),
                                (torch.bfloat16, bf16, "chain_bf16_wide")):
        assert tfl.kernel_name(dtype, width, groups) == kernel
        for variant in ("row_scene", "row_skip"):
            for (N, B), (ts, clusters) in TILES.items():
                plan = tfl.tile_plan(B, N, _blocks(variant), dtype=dtype, C=width, groups=groups)
                assert tuple(plan) == (ts, clusters, ctas * clusters, 4, smem, None)
                assert plan.smem_bytes <= trb.SMEM_LIMIT
    assert tfl.kernel_name(torch.float32, 512, 8) == "chain_tf32"
    assert tfl.kernel_name(torch.bfloat16, 512, 8) == "chain_sm90"


# (N, B) -> (scenes per tile, clusters) of the f32 kernel; every chain takes
# 5 ring stages and 226,128 bytes of shared memory a CTA
F32_TILES = {(12, 64): (5, 13), (12, 256): (5, 52), (12, 768): (5, 154),
             (21, 64): (3, 22), (21, 256): (3, 86), (21, 768): (3, 256)}


@pytest.mark.parametrize("N,B", list(F32_TILES))
@pytest.mark.parametrize("variant", ["row_scene", "row_skip"])
def test_f32_tile_plan_at_flagship_shapes(variant, N, B):
    """The f32 kernel's launch: whole scenes in 64-row tiles (the wgmma M),
    one cluster of 8 CTAs a tile, and a CTA's shared memory (the ring of
    split chunks, 8 slots of 64 rows, 14 vectors, 42 barriers) within the
    H100's 232,448 bytes (the library checks the same sum when it loads)."""
    plan = tfl.tile_plan(B, N, _blocks(variant), dtype=torch.float32)
    ts, clusters = F32_TILES[(N, B)]
    assert tuple(plan) == (ts, clusters, 8 * clusters, 5, 226128, None)
    assert plan.scenes_per_tile * N <= trb.TILE_ROWS < (plan.scenes_per_tile + 1) * N
    assert plan.clusters * plan.scenes_per_tile >= B > (plan.clusters - 1) * plan.scenes_per_tile
    assert plan.smem_bytes <= trb.SMEM_LIMIT


def test_split_tf32_chain_matches_f32_chain(monkeypatch):
    """The f32 kernel's arithmetic before the card: the plain twin with
    every product (its only torch.matmul calls) formed as hi*lo + lo*hi +
    hi*hi of tf32 parts (both operands; each term an f32 product, summed in
    f32), a two-block row_skip chain at the flagship's width (C=512, N=12,
    B=8), within the card's kernel tolerance (chip_smoke.py KERNEL_TOL f32:
    atol 1e-3, rtol 1e-4) of the plain f32 chain."""
    x, blocks, weights, films, skips = _case("row_skip", 8, 12, seed=9, C=512)
    chain = tfl.build_chain(
        [tfl.ChainBlock(has_skip=s, film=f, has_res_proj=r) for f, s, r in blocks],
        [{k: torch.from_numpy(v) for k, v in w.items()} for w in weights],
        compute_dtype=torch.float32)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    args = (chain, t(x), [t(f) for f in films], [t(s) for s in skips])
    want = tfl.apply_chain_reference(*args, n_per_scene=12)
    matmul = torch.matmul

    def split_matmul(a, w):
        (ah, al), (wh, wl) = trb.tf32_split(a), trb.tf32_split(w)
        return matmul(ah, wl) + matmul(al, wh) + matmul(ah, wh)

    monkeypatch.setattr(torch, "matmul", split_matmul)
    got = tfl.apply_chain_reference(*args, n_per_scene=12)
    monkeypatch.undo()
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)
    assert not torch.equal(got, want)   # the products did go through the split


REFUSED = {
    "bf16_c64": dict(C=64), "bf16_c2048": dict(C=2048), "bf16_rows65": dict(n=65),
    "bf16_groups2": dict(groups=2), "bf16_groups64": dict(groups=64),
    "bf16_two_skips": dict(variant="two_skips"), "f32_rows65": dict(n=65, dt=torch.float32),
    "f32_c576": dict(C=576, dt=torch.float32), "f32_c448": dict(C=448, dt=torch.float32),
    "f32_c2048": dict(C=2048, dt=torch.float32),
    "f32_groups_of_8": dict(C=256, groups=32, dt=torch.float32),
    "f32_rows65_c1024": dict(C=1024, groups=4, n=65, dt=torch.float32),
    "f32_two_skips": dict(variant="two_skips", dt=torch.float32),
    "three_blocks": dict(variant="three"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_kernel_path_refuses_shapes_it_does_not_take(case):
    """No fallback: what the kernels do not take raises before any launch
    (both dtypes: C = 256, 512 or 1024 in 4-32 groups of at least 16
    channels, scenes of at most 64 rows, at most one skip a chain, chains of
    1 or 2 blocks)."""
    kw = dict(C=512, groups=8, n=12, dt=torch.bfloat16, variant="row_skip")
    kw.update(REFUSED[case])
    blocks = {"two_skips": [("scene", True, True)] * 2, "three": [("none", False, False)] * 3,
              "row_skip": VARIANTS["row_skip"]}[kw["variant"]]
    blocks = [tfl.ChainBlock(has_skip=s, film=f, has_res_proj=r) for f, s, r in blocks]
    with pytest.raises(ValueError):
        tfl.check_kernel_shapes(blocks, kw["dt"], kw["C"], kw["n"], kw["groups"])
    # and through the launch path, on CPU tensors: it raises before it builds
    C, n, dt = kw["C"], kw["n"], kw["dt"]
    wd = {k: torch.zeros(C, C) for k in ("w1", "w1s", "w2", "wres", "wres_s")}
    wd.update({k: torch.zeros(C) for k in ("b1", "b2", "gn1_bias", "gn2_bias", "gn1_scale",
                                          "gn2_scale", "bres")})
    chain = tfl.build_chain(blocks, [wd] * len(blocks), compute_dtype=dt)
    x = torch.zeros(n, C, dtype=dt)
    films = [None if b.film == "none" else torch.zeros(n, 2 * C, dtype=dt) for b in blocks]
    skips = [torch.zeros(n, C, dtype=dt) if b.has_skip else None for b in blocks]
    with pytest.raises(ValueError):
        tfl._launch_kernel(chain, x, films, skips, n, kw["groups"], 1e-6)
    for dt in (torch.bfloat16, torch.float32):   # taken
        tfl.check_kernel_shapes(_blocks("row_skip"), dt, 512, 21, 8)
        tfl.check_kernel_shapes(_blocks("row_skip"), dt, 512, 64, 8)
        for C, groups in ((512, 16), (256, 16), (1024, 4), (1024, 32)):
            tfl.check_kernel_shapes(_blocks("row_skip"), dt, C, 64, groups)
            assert tfl.takes(C, groups, 64) and not tfl.takes(C, groups, 65)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_library_agrees_with_the_plan(dtype):
    """The library's limits and shared-memory sums equal the wrapper's
    (load_library raises otherwise), and enough clusters of each kernel fit
    on the card to run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    from diffuscene_tpu_torch.ops import build

    lib = tfl.load_library()
    for variant in ("row_scene", "row_skip"):
        for C, groups in ((512, 8), (256, 16), (1024, 4)):
            plan = tfl.tile_plan(64, 12, _blocks(variant), lib, dtype, C, groups)
            assert (lib.fused_chain_smem_bytes(build.DTYPE_CODES[dtype],
                                               int(variant == "row_skip"), C, groups)
                    == plan.smem_bytes)
            assert plan.resident >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("N", [12, 21])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cuda_kernel_matches_plain_version(variant, dtype, N):
    """The CUDA kernel against its plain version on the card, C=512, a
    ragged last tile (7 scenes: bf16 tiles of 5 scenes of 12, of 3 of 21)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    x, blocks, weights, films, skips = _case(variant, 7, N, seed=3, C=512)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    dev = torch.device("cuda")
    chain = tfl.build_chain(
        [tfl.ChainBlock(has_skip=s, film=f, has_res_proj=r) for f, s, r in blocks],
        [{k: torch.from_numpy(v).to(dev) for k, v in w.items()} for w in weights],
        compute_dtype=tdt)
    cast = lambda a: None if a is None else torch.from_numpy(a).to(dev, tdt)  # noqa: E731
    args = (chain, cast(x), [cast(f) for f in films], [cast(s) for s in skips])
    got = tfl.apply_chain(*args, n_per_scene=N)
    want = tfl.apply_chain_reference(*args, n_per_scene=N)
    torch.cuda.synchronize()
    tol = dict(atol=1e-3, rtol=0) if dtype == "f32" else dict(atol=1e-1, rtol=5e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("width,groups", SET_EDGES + [(1024, 16)])
@pytest.mark.parametrize("variant", ["row_scene", "row_skip", "skip"])
def test_cuda_wide_kernel_matches_plain_version(variant, width, groups, dtype):
    """The wide kernels (chain_tf32_wide, chain_bf16_wide) against the plain
    version on the card at the set's edges, a ragged last tile (7 scenes of
    12 rows), within chip_smoke.py's KERNEL_TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    x, blocks, weights, films, skips = _case(variant, 7, 12, seed=width + groups, C=width)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    dev = torch.device("cuda")
    chain = tfl.build_chain(
        [tfl.ChainBlock(has_skip=s, film=f, has_res_proj=r) for f, s, r in blocks],
        [{k: torch.from_numpy(v).to(dev) for k, v in w.items()} for w in weights],
        compute_dtype=tdt)
    cast = lambda a: None if a is None else torch.from_numpy(a).to(dev, tdt)  # noqa: E731
    args = (chain, cast(x), [cast(f) for f in films], [cast(s) for s in skips])
    before = dict(tfl.apply_chain.by_kernel)
    got = tfl.apply_chain(*args, n_per_scene=12, groups=groups)
    want = tfl.apply_chain_reference(*args, n_per_scene=12, groups=groups)
    torch.cuda.synchronize()
    kernel = tfl.kernel_name(tdt, width, groups)
    assert tfl.apply_chain.by_kernel[kernel] == before.get(kernel, 0) + 1
    tol = dict(atol=1e-3, rtol=1e-4) if dtype == "f32" else dict(atol=1e-1, rtol=5e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
