"""Parity of the port's chamfer distance and KNN (diffuscene_tpu_torch/ops/
chamfer.py, ops/knn.py) with the JAX package's (diffuscene_tpu/ops/).

On the CPU the port's ``directed_nn`` runs its plain torch twin; the JAX side
runs the Pallas kernel in interpret mode, as its own tests do.  The same
numpy inputs, made from a seed, go to both.  Tolerances: distances atol 1e-5
(f32, values of O(1), the same expansion with products summed in another
order); indices exactly equal (random clouds, no two candidate distances
within a rounding); gradients atol 1e-5 as the JAX package's own chamfer
gradient test.

The CUDA kernel itself runs only on the card: see ``chip_smoke.py`` and the
``gpu``-marked test at the end.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuscene_tpu.ops import chamfer as jch
from diffuscene_tpu.ops import knn as jknn
from diffuscene_tpu_torch.ops import chamfer as tch
from diffuscene_tpu_torch.ops import knn as tknn
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


DIST_ATOL = 1e-5


def _clouds(seed, B, N, M, D):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(B, N, D)).astype(np.float32),
            rng.uniform(size=(B, M, D)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_chamfer():
    return jax.jit(jch.chamfer_distance)


# ragged N != M in every case, as the AE's 2048 inputs vs 2025 outputs
@pytest.mark.parametrize("D,N,M", [(2, 100, 120), (3, 100, 120), (5, 130, 97)])
def test_plain_twin_matches_jax_pallas_and_oracle(jax_chamfer, D, N, M):
    x, y = _clouds(D, 4, N, M, D)
    want = [np.asarray(a) for a in jax_chamfer(jnp.asarray(x), jnp.asarray(y))]
    oracle = [np.asarray(a) for a in jch.chamfer_oracle(jnp.asarray(x), jnp.asarray(y))]
    got = [a.numpy() for a in tch.chamfer_distance(torch.from_numpy(x), torch.from_numpy(y))]
    for ref in (want, oracle):
        np.testing.assert_allclose(got[0], ref[0], atol=DIST_ATOL, rtol=0)
        np.testing.assert_allclose(got[1], ref[1], atol=DIST_ATOL, rtol=0)
        np.testing.assert_array_equal(got[2], ref[2])
        np.testing.assert_array_equal(got[3], ref[3])
    assert got[2].dtype == np.int32 and got[3].dtype == np.int32


def test_identical_clouds(jax_chamfer):
    x, _ = _clouds(7, 2, 64, 1, 3)
    want = [np.asarray(a) for a in jax_chamfer(jnp.asarray(x), jnp.asarray(x))]
    got = [a.numpy() for a in tch.chamfer_distance(torch.from_numpy(x), torch.from_numpy(x))]
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, atol=DIST_ATOL, rtol=0)
        np.testing.assert_allclose(g, 0.0, atol=DIST_ATOL)
    np.testing.assert_array_equal(got[2], np.broadcast_to(np.arange(64), (2, 64)))
    np.testing.assert_array_equal(got[3], want[3])


def test_gradients_match_jax_grad():
    x, y = _clouds(11, 2, 60, 50, 3)

    def jloss(a, b):
        d1, d2, _, _ = jch.chamfer_distance(a, b)
        return d1.mean() + d2.mean()

    jgx, jgy = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx = torch.from_numpy(x).requires_grad_()
    ty = torch.from_numpy(y).requires_grad_()
    d1, d2, i1, i2 = tch.chamfer_distance(tx, ty)
    assert not i1.requires_grad and not i2.requires_grad
    (d1.mean() + d2.mean()).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(jgy), atol=1e-5, rtol=0)


def test_one_direction_gradient_and_aliases():
    """A loss on dist1 alone leaves dist2's cotangent None; the D-checking
    aliases refuse other widths."""
    x, y = _clouds(12, 2, 30, 20, 2)
    tx = torch.from_numpy(x).requires_grad_()
    ty = torch.from_numpy(y).requires_grad_()
    d1, _, _, _ = tch.chamfer_2d(tx, ty)
    d1.sum().backward()
    jgx, jgy = jax.grad(lambda a, b: jch.chamfer_distance(a, b)[0].sum(), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(jgy), atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        tch.chamfer_3d(tx, ty)
    with pytest.raises(ValueError):
        tch.chamfer_5d(tx, ty)


def test_twin_is_the_kernels_arithmetic():
    """The twin's distances equal the JAX distance matrix's minima to
    rounding and never take a later index on a tie: duplicated y points
    give the first index."""
    x, y = _clouds(13, 2, 40, 30, 3)
    y = np.concatenate([y, y], axis=1)                      # every point twice
    dist, idx = tch.directed_nn(torch.from_numpy(x), torch.from_numpy(y))
    assert int(idx.max()) < 30
    od = np.asarray(jch.pairwise_sqdist(jnp.asarray(x), jnp.asarray(y))).min(axis=2)
    np.testing.assert_allclose(dist.numpy(), od, atol=DIST_ATOL, rtol=0)


def test_wrapper_refuses_bad_inputs():
    x = torch.zeros(2, 5, 3)
    with pytest.raises(ValueError):                        # batch mismatch
        tch.directed_nn(x, torch.zeros(3, 5, 3))
    with pytest.raises(ValueError):                        # D mismatch
        tch.directed_nn(x, torch.zeros(2, 5, 2))
    with pytest.raises(ValueError):                        # empty cloud
        tch.directed_nn(x, torch.zeros(2, 0, 3))
    with pytest.raises(ValueError):                        # neither cpu nor cuda: no fallback
        tch.directed_nn(x.to("meta"), torch.zeros(2, 5, 3, device="meta"))
    before = tch.directed_nn.launches
    tch.directed_nn(x, x)
    assert tch.directed_nn.launches == before              # the CPU twin is no launch


def test_fscore_matches_jax():
    x, _ = _clouds(14, 2, 128, 1, 3)
    jd1, jd2, _, _ = jch.chamfer_distance(jnp.asarray(x), jnp.asarray(x + 1e-2))
    td1, td2, _, _ = tch.chamfer_distance(torch.from_numpy(x), torch.from_numpy(x + 1e-2))
    for shift in (0.0, 10.0):
        want = jch.fscore(jd1 + shift, jd2 + shift, threshold=0.01)
        got = tch.fscore(td1 + shift, td2 + shift, threshold=0.01)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
            assert np.isfinite(g.numpy()).all()


@pytest.mark.parametrize("D,k,jax_chunk", [(3, 8, None), (4, 5, 32), (64, 16, None)])
def test_knn_neighbour_sets_match_jax(D, k, jax_chunk):
    """top_k and topk may order equal entries differently: compare the sets.
    The port always forms the whole similarity matrix; the JAX side is also
    run in query chunks."""
    rng = np.random.default_rng(D)
    x = rng.normal(size=(2, 100, D)).astype(np.float32)
    want = np.asarray(jknn.knn_indices(jnp.asarray(x), k, chunk=jax_chunk))
    got = tknn.knn_indices(torch.from_numpy(x), k).numpy()
    assert got.shape == want.shape == (2, 100, k)
    np.testing.assert_array_equal(np.sort(got, axis=-1), np.sort(want, axis=-1))
    assert (got == np.arange(100)[None, :, None]).any(-1).all()   # self included


def test_gather_neighbors_matches_jax():
    rng = np.random.default_rng(15)
    x = rng.normal(size=(2, 6, 3)).astype(np.float32)
    idx = rng.integers(0, 6, size=(2, 4, 3))
    want = np.asarray(jknn.gather_neighbors(jnp.asarray(x), jnp.asarray(idx, jnp.int32)))
    got = tknn.gather_neighbors(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    assert got.shape == (2, 4, 3, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("M,cluster", [(1, 1), (64, 1), (65, 2), (777, 2), (2025, 2),
                                       (2048, 2), (100_003, 2)])
def test_launch_plan_slices_cover_m(M, cluster):
    """The kernel's y slices are contiguous, non-empty, in order, and cover
    [0, M) exactly, also where S does not divide M."""
    plan = tch.launch_plan(16, 2048, M)
    assert plan.cluster == cluster == len(plan.slices)
    assert plan.slices[0][0] == 0 and plan.slices[-1][1] == M
    assert all(a[1] == b[0] for a, b in zip(plan.slices, plan.slices[1:]))
    assert all(hi > lo for lo, hi in plan.slices)
    assert plan.x_blocks == 2048 // (plan.threads * plan.points_per_thread)
    assert plan.ctas == 16 * plan.x_blocks * plan.cluster


@pytest.mark.gpu
def test_cuda_kernel_ties_across_slices_take_the_lower_index():
    """Exact ties between copies of a y point in two slices of the kernel's
    sweep: the query on that point takes the lower index, as the twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    x, y = (torch.from_numpy(a).cuda() for a in _clouds(17, 4, 2048, 2025, 3))
    slices = tch.launch_plan(4, 2048, 2025).slices
    ties = [(k, c, slices[k][0] + 3 + c) for k in range(len(slices) - 1) for c in range(8)]
    for i, (k, c, lo) in enumerate(ties):
        y[:, slices[k + 1][0] + 5 + c] = y[:, lo]
        x[:, i] = y[:, lo]
    dist, idx = tch.directed_nn(x, y)
    want_d, want_i = tch.directed_nn_reference(x, y)
    torch.cuda.synchronize()
    assert torch.equal(dist, want_d) and torch.equal(idx, want_i)
    for i, (_, _, lo) in enumerate(ties):
        assert bool((idx[:, i] == lo).all()) and bool((dist[:, i] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M,D", [(16, 2048, 2025, 3), (3, 1000, 777, 5)])
def test_cuda_kernel_matches_plain_version(B, N, M, D):
    """The CUDA kernel against its twin on the card: equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    x, y = (torch.from_numpy(a).cuda() for a in _clouds(16, B, N, M, D))
    before = tch.directed_nn.launches
    for a, b in ((x, y), (y, x)):
        dist, idx = tch.directed_nn(a, b)
        want_d, want_i = tch.directed_nn_reference(a, b)
        torch.cuda.synchronize()
        assert torch.equal(dist, want_d) and torch.equal(idx, want_i)
    assert tch.directed_nn.launches == before + 2
