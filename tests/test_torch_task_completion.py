"""Scene completion of both packages, the RePaint splice chain through
``SceneDiffusion.sample(partial_boxes=...)`` on the same weights and the
JAX noise stream replayed, completion's three-way key split included
(tests/test_torch_tasks.py's models, noise streams and tolerance; its
docstring states them).  A file of its own so that the test runner's file
scheduler starts these cases beside the long JAX files, not before them.
"""
import jax
import numpy as np
import pytest
import torch

from test_torch_tasks import (B, N, P, SAMPLE_ATOL, _complete_stream, _models, _packed,
                              _replay)
from test_torch_threads import below_the_longest_file  # noqa: F401 (autouse)
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


@pytest.mark.parametrize("fused,task", [(False, None), (True, None), (True, "partial")])
def test_completion_matches_jax(fused, task):
    """The RePaint splice chain on the same weights and noise stream, the
    unconditional model through the module and the 3-D engine, and the
    partial head's model (its zero-padded partial input) through the
    engine: atol 1e-4, the first P slots the partial boxes bit for bit."""
    T = 4
    jscene, params, scene = _models(task, T)
    partial = _packed(np.random.default_rng(1))[:, :P]
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax.jit(lambda p, k, pb: jscene.sample(
        p, k, batch_size=B, partial_boxes=pb, clip_denoised=True, fused=fused))(
            params, key, partial))
    noises = _complete_stream(key, (B, N, 62), partial.shape, T)
    got = scene.sample(B, clip_denoised=True, fused=fused, noise_fn=_replay(noises),
                       partial_boxes=torch.from_numpy(partial)).numpy()
    assert not noises
    assert got.shape == (B, N, 62) and np.isfinite(got).all()
    assert np.array_equal(got[:, :P], partial)
    np.testing.assert_allclose(got, want, atol=SAMPLE_ATOL, rtol=0)

