"""The whole-chain sampler cases of tests/test_torch_sampling.py (whose
docstring states the method and the tolerance): ``SceneDiffusion.sample``
of both packages on the same converted weights, the rows engine with DDPM
and the 3-D engine with DDPM, DDIM and DPM-Solver++, the JAX noise stream
replayed.  A file of its own so that the test runner's file scheduler
starts these cases beside the long JAX files, not before them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sampling import _sample_matches_jax
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


def test_rows_sample_chain_matches_jax():
    scene, jscene, got = _sample_matches_jax(5, "rows", 5)
    parts = scene.split_samples(torch.from_numpy(got))
    jparts = jscene.split_samples(jnp.asarray(got))
    assert parts.keys() == jparts.keys()
    for k_ in parts:
        assert np.array_equal(parts[k_].numpy(), np.asarray(jparts[k_])), k_


@pytest.mark.parametrize("sampler,time_num,n_draws,kwargs", [
    ("ddpm", 5, 5, {}),
    # DDIM walks a strided subsequence: the FiLM-table gather at
    # non-contiguous t (JAX tests/test_fused_engine.py:134); one draw a step
    ("ddim", 8, 4, dict(ddim=True, ddim_steps=4)),
    # DPM-Solver++ draws x_T only
    ("dpm", 8, 0, dict(dpm=True, dpm_steps=4)),
])
def test_engine_samplers_match_jax(sampler, time_num, n_draws, kwargs):
    _sample_matches_jax(time_num, True, n_draws, **kwargs)

