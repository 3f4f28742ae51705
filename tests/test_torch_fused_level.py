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


def _run_jax(case, N, dtype, backend):
    x, blocks, weights, films, skips = case
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    chain = jfl.build_chain(
        [jfl.ChainBlock(has_skip=s, film=f, has_res_proj=r) for f, s, r in blocks],
        [{k: jnp.asarray(v) for k, v in w.items()} for w in weights], compute_dtype=jdt)
    cast = lambda a: None if a is None else jnp.asarray(a).astype(jdt)  # noqa: E731
    B = x.shape[0] // N
    out = jfl.apply_chain(chain, cast(x), [cast(f) for f in films], [cast(s) for s in skips],
                          n_per_scene=N, groups=GROUPS, tile_scenes=B, backend=backend)
    return np.asarray(out.astype(jnp.float32))


def _run_torch(case, N, dtype):
    x, blocks, weights, films, skips = case
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    chain = tfl.build_chain(
        [tfl.ChainBlock(has_skip=s, film=f, has_res_proj=r) for f, s, r in blocks],
        [{k: torch.from_numpy(v) for k, v in w.items()} for w in weights], compute_dtype=tdt)
    cast = lambda a: None if a is None else torch.from_numpy(a).to(tdt)  # noqa: E731
    out = tfl.apply_chain(chain, cast(x), [cast(f) for f in films], [cast(s) for s in skips],
                          n_per_scene=N, groups=GROUPS)
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


def test_mma_weight_packing_matches_fragment_layout():
    """The bf16 kernel's B fragments: lane (g, t) of the warp owning output
    column n reads 4 contiguous values of the packed weight at k-step ks,
    which must be W[k, n] for k = 16ks + (2t, 2t+1, 2t+8, 2t+9); summing
    those fragments over every lane recovers the matmul."""
    rng = np.random.default_rng(9)
    W = torch.from_numpy(rng.normal(size=(2, 64, 128)).astype(np.float32))
    P = tfl.pack_mma_weights(W)
    assert P.shape == (2, 128, 64) and P.is_contiguous()
    for ks in range(4):
        for t in range(4):
            ks_idx = [16 * ks + k for k in (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)]
            frag = P[:, :, 16 * ks + 4 * t: 16 * ks + 4 * t + 4]          # (2, N, 4)
            torch.testing.assert_close(frag, W[:, ks_idx, :].transpose(1, 2), rtol=0, atol=0)
    A = torch.from_numpy(rng.normal(size=(5, 64)).astype(np.float32))
    acc = torch.zeros(2, 5, 128)
    for ks in range(4):
        for t in range(4):
            ks_idx = [16 * ks + k for k in (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)]
            acc += torch.einsum("mk,wnk->wmn", A[:, ks_idx], P[:, :, 16 * ks + 4 * t:16 * ks + 4 * t + 4])
    torch.testing.assert_close(acc, torch.einsum("mk,wkn->wmn", A, W), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cuda_kernel_matches_plain_version(variant, dtype):
    """The CUDA kernel against its plain version on the card, C=512."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    x, blocks, weights, films, skips = _case(variant, 7, 12, seed=3, C=512)  # ragged last tile
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    dev = torch.device("cuda")
    chain = tfl.build_chain(
        [tfl.ChainBlock(has_skip=s, film=f, has_res_proj=r) for f, s, r in blocks],
        [{k: torch.from_numpy(v).to(dev) for k, v in w.items()} for w in weights],
        compute_dtype=tdt)
    cast = lambda a: None if a is None else torch.from_numpy(a).to(dev, tdt)  # noqa: E731
    args = (chain, cast(x), [cast(f) for f in films], [cast(s) for s in skips])
    got = tfl.apply_chain(*args, n_per_scene=12)
    want = tfl.apply_chain_reference(*args, n_per_scene=12)
    torch.cuda.synchronize()
    tol = dict(atol=1e-3, rtol=0) if dtype == "f32" else dict(atol=1e-1, rtol=5e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
