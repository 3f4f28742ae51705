"""Parity of the port's rows-layout serving forward
(diffuscene_tpu_torch/models/inference.py:fused_unet1d_forward_rows) with the
JAX package's rows forward, its chains in plain XLA (``chain_backend="xla"``),
on the same Flax-converted weights and numpy inputs.

Small sizes (dim 64, 4 levels, B=4).  Tolerances: f32 atol 2e-4, the JAX
package's own rows-vs-engine f32 tolerance (tests/test_rows_engine.py);
bf16 atol 1.5e-1, its bf16 tolerance there: bf16 rounds at other places in
the two frameworks and the differences add up over 19 chains.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuscene_tpu.models import inference as jinf
from diffuscene_tpu_torch.models import Unet1D
from diffuscene_tpu_torch.models import inference as tinf
from diffuscene_tpu_torch.utils.convert import denoiser_tree, flax_to_torch_denoiser

from test_torch_denoiser import KW, N, _flax_params
from test_torch_threads import below_the_longest_file  # noqa: F401 (autouse)
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


B, T = 4, 6


def _jax_rows(jnet, params, x, t, cond):
    prep = jinf.prepare_inference_params(jnet, params, num_timesteps=T)
    ctx = jinf.precompute_conditioning(jnet, prep, jnp.asarray(cond), None)
    chains = jinf.prepare_chain_params(jnet, prep, frozenset(ctx["film_c"]))
    rows = {"film_c2": {k: v.reshape(-1, v.shape[-1]) for k, v in ctx["film_c"].items()},
            "cross": {}}
    fn = jax.jit(lambda x, t: jinf.fused_unet1d_forward_rows(
        jnet, prep, chains, x, t, rows, chain_backend="xla"))
    return np.asarray(fn(jnp.asarray(x), jnp.asarray(t)))


def _torch_rows(net, x, t, cond):
    prep = tinf.prepare_inference_params(net, denoiser_tree(net), num_timesteps=T)
    ctx = tinf.precompute_conditioning(net, prep, torch.from_numpy(cond))
    chains = tinf.prepare_chain_params(net, prep, frozenset(ctx["film_c"]))
    rows = {"film_c2": {k: v.reshape(-1, v.shape[-1]) for k, v in ctx["film_c"].items()}}
    return tinf.fused_unet1d_forward_rows(net, prep, chains, torch.from_numpy(x),
                                          torch.from_numpy(t).long(), rows).numpy()


@pytest.mark.parametrize("dtype,atol", [("f32", 2e-4), ("bf16", 1.5e-1)])
def test_rows_forward_matches_jax(dtype, atol):
    jnet, params = _flax_params(seed=4)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jnet = jnet.clone(compute_dtype=jdt)
    net = Unet1D(**KW, compute_dtype=tdt)
    net.load_state_dict(flax_to_torch_denoiser(params))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, N, 62)).astype(np.float32)
    t = np.array([0, 1, 3, 5], np.int32)
    cond = rng.normal(size=(B, N, 32)).astype(np.float32)
    want = _jax_rows(jnet, params, x, t, cond)
    got = _torch_rows(net, x, t, cond)
    assert got.shape == (B, N, 62) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_rows_forward_matches_module_forward_f32():
    """Inside the port: the rows engine with exact GELU equals the plain
    module forward (the engine's time MLP is exact in both)."""
    _, params = _flax_params(seed=6)
    net = Unet1D(**KW)
    net.load_state_dict(flax_to_torch_denoiser(params))
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(B, N, 62)).astype(np.float32))
    t = torch.tensor([0, 2, 4, 5])
    cond = torch.from_numpy(rng.normal(size=(B, N, 32)).astype(np.float32))
    prep = tinf.prepare_inference_params(net, denoiser_tree(net), num_timesteps=T)
    ctx = tinf.precompute_conditioning(net, prep, cond)
    chains = tinf.prepare_chain_params(net, prep, frozenset(ctx["film_c"]))
    rows = {"film_c2": {k: v.reshape(-1, v.shape[-1]) for k, v in ctx["film_c"].items()}}
    got = tinf.fused_unet1d_forward_rows(net, prep, chains, x, t, rows, exact_gelu=True)
    with torch.no_grad():
        want = net(x, t, cond)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=0)
