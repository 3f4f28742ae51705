"""Parity of the port's 3-D serving engine
(diffuscene_tpu_torch/models/inference.py:fused_unet1d_forward, every
ResnetBlock on ``fused_resnet_block`` and mid_attn on ``fused_set_attention``)
with the JAX package's 3-D engine (diffuscene_tpu/models/inference.py:
fused_unet1d_forward), on the same Flax-converted weights and numpy inputs.

Small sizes (dim 64, 4 levels, B=4).  Tolerances: f32 atol 5e-4, the JAX
package's own engine-vs-module tolerance (tests/test_fused_engine.py:95):
the port's blocks and attention take B1's and B2's roundings, which in f32
differ from the engine's plain ops by summation order only; bf16 atol
1.5e-1, as for the rows engine (tests/test_torch_inference.py): bf16 rounds
at other places in the two (B1 keeps the dense output in f32 where the JAX
engine rounds it) and the differences add up over 28 blocks.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuscene_tpu.models import Unet1D as JUnet1D
from diffuscene_tpu.models import inference as jinf
from diffuscene_tpu_torch.models import Unet1D
from diffuscene_tpu_torch.models import inference as tinf
from diffuscene_tpu_torch.ops import attention as tat
from diffuscene_tpu_torch.ops import fused_resblock as trb
from diffuscene_tpu_torch.utils.convert import denoiser_tree, flax_to_torch_denoiser

from test_torch_denoiser import KW, N, _flax_params
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


B, T = 4, 6
UNCOND = {**KW, "instanclass_dim": 0}


@functools.lru_cache(maxsize=None)
def _uncond_shapes():
    """The unconditioned Unet1D's init tree shapes, traced once a process."""
    return jax.eval_shape(JUnet1D(**UNCOND).init, jax.random.PRNGKey(0), jnp.zeros((2, N, 62)),
                          jnp.zeros((2,), jnp.int32))["params"]


def _uncond_params(seed):
    """Random Flax params of the unconditioned Unet1D (no cond-FiLM mlps)."""
    net = JUnet1D(**UNCOND)
    shapes = _uncond_shapes()
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        if path[-1].key == "kernel":
            return (rng.normal(size=a.shape) / np.sqrt(a.shape[0])).astype(np.float32)
        base = 1.0 if path[-1].key in ("scale", "g") else 0.0
        return (base + rng.normal(size=a.shape) * 0.1).astype(np.float32)

    return net, jax.tree_util.tree_map_with_path(leaf, shapes)


def _inputs(seed, cond=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, 62)).astype(np.float32)
    t = np.array([0, 1, 3, 5], np.int32)
    c = rng.normal(size=(B, N, 32)).astype(np.float32) if cond else None
    return x, t, c


def _jax_engine(jnet, params, x, t, cond, exact_gelu):
    prep = jinf.prepare_inference_params(jnet, params, num_timesteps=T)
    c = None if cond is None else jnp.asarray(cond)
    fn = jax.jit(lambda x, t: jinf.fused_unet1d_forward(jnet, prep, x, t, c, None,
                                                         exact_gelu=exact_gelu))
    return np.asarray(fn(jnp.asarray(x), jnp.asarray(t)))


def _torch_engine(net, x, t, cond, exact_gelu):
    prep = tinf.prepare_inference_params(net, denoiser_tree(net), num_timesteps=T)
    c = None if cond is None else torch.from_numpy(cond)
    return tinf.fused_unet1d_forward(net, prep, torch.from_numpy(x), torch.from_numpy(t).long(),
                                     condition=c, exact_gelu=exact_gelu)


@pytest.mark.parametrize("dtype,exact_gelu,atol", [
    ("f32", True, 5e-4), ("f32", False, 5e-4), ("bf16", False, 1.5e-1)])
def test_engine_matches_jax_engine(dtype, exact_gelu, atol):
    jnet, params = _flax_params(seed=8)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    net = Unet1D(**KW, compute_dtype=tdt)
    net.load_state_dict(flax_to_torch_denoiser(params))
    x, t, cond = _inputs(9)
    want = _jax_engine(jnet.clone(compute_dtype=jdt), params, x, t, cond, exact_gelu)
    got = _torch_engine(net, x, t, cond, exact_gelu)
    assert got.shape == (B, N, 62) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


def test_unconditioned_engine_matches_jax_engine():
    """No cond-FiLM mlps: the block0s run FiLM-free (zero film rows)."""
    jnet, params = _uncond_params(seed=10)
    net = Unet1D(**UNCOND)
    net.load_state_dict(flax_to_torch_denoiser(params))
    x, t, _ = _inputs(11, cond=False)
    want = _jax_engine(jnet, params, x, t, None, True)
    got = _torch_engine(net, x, t, None, True)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=0)


def test_engine_matches_module_and_rows_engine_f32():
    """Inside the port, f32 with exact GELU: the 3-D engine equals the plain
    module forward and the rows engine; one forward makes 28 ResnetBlock and
    1 set-attention calls, none of them a kernel launch on the CPU."""
    _, params = _flax_params(seed=12)
    net = Unet1D(**KW)
    net.load_state_dict(flax_to_torch_denoiser(params))
    x, t, cond = (torch.from_numpy(a) for a in _inputs(13))
    t = t.long()
    prep = tinf.prepare_inference_params(net, denoiser_tree(net), num_timesteps=T)
    ctx = tinf.precompute_conditioning(net, prep, cond)
    calls = {"rb": 0, "attn": 0}
    rb, at = tinf.fused_resnet_block, tinf.fused_set_attention

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    launches = (trb.fused_resnet_block.launches, tat.fused_set_attention.launches)
    tinf.fused_resnet_block, tinf.fused_set_attention = count("rb", rb), count("attn", at)
    try:
        got = tinf.fused_unet1d_forward(net, prep, x, t, cond_ctx=ctx, exact_gelu=True)
    finally:
        tinf.fused_resnet_block, tinf.fused_set_attention = rb, at
    assert calls == {"rb": 28, "attn": 1}
    assert (trb.fused_resnet_block.launches, tat.fused_set_attention.launches) == launches
    with torch.no_grad():
        module = net(x, t, cond)
    chains = tinf.prepare_chain_params(net, prep, frozenset(ctx["film_c"]))
    rows = tinf.fused_unet1d_forward_rows(
        net, prep, chains, x, t,
        {"film_c2": {k: v.reshape(-1, v.shape[-1]) for k, v in ctx["film_c"].items()}},
        exact_gelu=True)
    torch.testing.assert_close(got, module, atol=2e-4, rtol=0)
    torch.testing.assert_close(got, rows, atol=2e-4, rtol=0)
