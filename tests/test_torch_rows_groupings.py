"""The port's rows engine (models/inference.py, its chains on the CPU's
plain B4) in 4 and 16 GroupNorm groups against the JAX rows engine with its
chains on the Pallas kernel in interpret mode.  A file of its own so that
the test runner's file scheduler starts these slow cases beside the long
JAX files, not before them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuscene_tpu_torch.models import Unet1D
from diffuscene_tpu_torch.models.inference import (fused_unet1d_forward_rows,
                                                   precompute_conditioning,
                                                   prepare_chain_params,
                                                   prepare_inference_params)
from diffuscene_tpu_torch.utils.convert import denoiser_tree, flax_to_torch_denoiser
from test_torch_denoiser import KW as ROWS_KW
from test_torch_denoiser import N as ROWS_N
from test_torch_denoiser import _flax_params
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


# the rows engine against the JAX rows engine, the JAX chains on the Pallas
# kernel (interpret mode): tests/test_torch_inference.py's bounds, f32 the
# same math summed in another order, bf16 rounding at other places in the
# two frameworks over 19 chains
ROWS_TOL = {torch.float32: 2e-4, torch.bfloat16: 1.5e-1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("groups", [4, 16])
def test_rows_engine_in_other_groupings_matches_the_jax_rows_engine(groups, dtype):
    """A dim-64 [1, 1, 1, 1] Unet1D in 4 and 16 GroupNorm groups (the
    groupings B4 took on), the same Flax weights on both: the port's rows
    engine (its chains on the CPU's plain version) against the JAX rows
    engine with its chains on the Pallas kernel, one forward at 4 timesteps
    of B=4 scenes (one 48-row tile of the Pallas tiling)."""
    jnet, params = _flax_params(seed=4)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jnet = jnet.clone(compute_dtype=jdt, resnet_block_groups=groups)
    net = Unet1D(**ROWS_KW, resnet_block_groups=groups, compute_dtype=dtype)
    net.load_state_dict(flax_to_torch_denoiser(params))
    rng = np.random.default_rng(groups)
    x = rng.normal(size=(4, ROWS_N, 62)).astype(np.float32)
    t = np.array([0, 1, 3, 5], np.int32)
    cond = rng.normal(size=(4, ROWS_N, 32)).astype(np.float32)

    from diffuscene_tpu.models import inference as jinf
    jprep = jinf.prepare_inference_params(jnet, params, num_timesteps=6)
    jctx = jinf.precompute_conditioning(jnet, jprep, jnp.asarray(cond), None)
    jchains = jinf.prepare_chain_params(jnet, jprep, frozenset(jctx["film_c"]))
    jrows = {"film_c2": {k: v.reshape(-1, v.shape[-1]) for k, v in jctx["film_c"].items()},
             "cross": {}}
    want = np.asarray(jax.jit(lambda x, t: jinf.fused_unet1d_forward_rows(
        jnet, jprep, jchains, x, t, jrows, chain_backend="pallas"))(x, t))
    prep = prepare_inference_params(net, denoiser_tree(net), num_timesteps=6)
    ctx = precompute_conditioning(net, prep, torch.from_numpy(cond))
    chains = prepare_chain_params(net, prep, frozenset(ctx["film_c"]))
    rows = {"film_c2": {k: v.reshape(-1, v.shape[-1]) for k, v in ctx["film_c"].items()}}
    got = fused_unet1d_forward_rows(net, prep, chains, torch.from_numpy(x),
                                    torch.from_numpy(t).long(), rows).numpy()
    assert got.shape == (4, ROWS_N, 62)
    np.testing.assert_allclose(got, want, atol=ROWS_TOL[dtype], rtol=0)

