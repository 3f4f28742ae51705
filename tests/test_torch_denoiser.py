"""Parity of the port's Unet1D (diffuscene_tpu_torch/models/denoiser.py) with
the Flax Unet1D, through the weight bridge (diffuscene_tpu_torch/utils/convert.py).

Small sizes (dim 64, 4 levels, B=4); inputs from numpy with a fixed seed;
f32 atol 2e-4 on the forward (the same f32 math, summed in another order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuscene_tpu.models import Unet1D as JUnet1D
from diffuscene_tpu.models.denoiser import seg_softmax_heads as j_seg_softmax
from diffuscene_tpu.models.denoiser import sinusoidal_pos_emb as j_sinusoidal
from diffuscene_tpu.utils.convert import convert_denoiser
from diffuscene_tpu_torch.models import Unet1D
from diffuscene_tpu_torch.models.denoiser import seg_softmax_heads, sinusoidal_pos_emb
from diffuscene_tpu_torch.utils.convert import denoiser_tree, flax_to_torch_denoiser
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


KW = dict(dim=64, dim_mults=(1, 1, 1, 1), channels=62, objectness_dim=0, class_dim=22,
          angle_dim=2, objfeat_dim=32, context_dim=0, instanclass_dim=32)
B, N = 4, 12


@functools.lru_cache(maxsize=None)
def _flax_shapes(seperate_all):
    """The Flax Unet1D init tree's shapes, traced once a process."""
    return jax.eval_shape(JUnet1D(seperate_all=seperate_all, **KW).init, jax.random.PRNGKey(0),
                          jnp.zeros((2, N, 62)), jnp.zeros((2,), jnp.int32),
                          jnp.zeros((2, N, 32)))["params"]


def _flax_params(seperate_all=True, seed=0):
    """Random Flax Unet1D params with every leaf randomized (biases and norm
    scales too, so every tensor kind of the bridge is exercised), in the tree
    structure and shapes of the Flax module's own init."""
    net = JUnet1D(seperate_all=seperate_all, **KW)
    shapes = _flax_shapes(seperate_all)
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == "kernel":  # N(0, 1/fan_in)
            return (rng.normal(size=a.shape) / np.sqrt(a.shape[0])).astype(np.float32)
        base = 1.0 if name in ("scale", "g") else 0.0
        return (base + rng.normal(size=a.shape) * 0.1).astype(np.float32)

    return net, jax.tree_util.tree_map_with_path(leaf, shapes)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("seperate_all", [True, False])
def test_bridge_round_trip_is_exact(seperate_all):
    """convert_denoiser (the JAX package's reference-checkpoint reader) inverts
    flax_to_torch_denoiser bit for bit, and the port module loads the dict."""
    _, params = _flax_params(seperate_all)
    sd = flax_to_torch_denoiser(params)
    back = convert_denoiser(sd)
    want = dict(_leaves(params))
    got = dict(_leaves(back))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k
    net = Unet1D(seperate_all=seperate_all, **KW)
    net.load_state_dict(sd, strict=True)
    tree = dict(_leaves({k: v for k, v in denoiser_tree(net).items()}))
    assert tree.keys() == want.keys()
    for k in want:
        assert np.array_equal(tree[k].numpy(), want[k]), k


def test_unet_forward_matches_flax_f32():
    jnet, params = _flax_params(seed=1)
    net = Unet1D(**KW)
    net.load_state_dict(flax_to_torch_denoiser(params))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, N, 62)).astype(np.float32)
    t = np.array([0, 3, 250, 999], np.int32)
    cond = rng.normal(size=(B, N, 32)).astype(np.float32)
    want = np.asarray(jax.jit(jnet.apply)({"params": params}, x, t, cond))
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(cond)).numpy()
    assert got.shape == (B, N, 62)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_attention_helpers_match_jax():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(5, 7, 128)) * 30).astype(np.float32)  # heads far apart
    np.testing.assert_allclose(seg_softmax_heads(torch.from_numpy(x), 4, 32).numpy(),
                               np.asarray(j_seg_softmax(jnp.asarray(x), 4, 32)),
                               atol=1e-6, rtol=1e-5)
    t = np.array([0, 1, 17, 999])
    np.testing.assert_allclose(sinusoidal_pos_emb(torch.from_numpy(t), 64).numpy(),
                               np.asarray(j_sinusoidal(jnp.asarray(t), 64)), atol=1e-4)


def test_unsupported_configs_raise():
    """Unequal dim_mults and the Fourier time embeddings are ported (held
    against Flax in tests/test_torch_model_extras.py) and build here; the
    JAX package's timing-ablation options are not (ROADMAP, "Do not port")
    and raise.  The name is the one the test had when all of these raised."""
    assert Unet1D(**{**KW, "dim_mults": (1, 2)}).mid_block1.dim_out == 2 * KW["dim"]
    assert Unet1D(**KW, learned_sinusoidal_cond=True).sinu_pos_emb.weights.shape == (8,)
    for ablation in ("weight_standardize", "ablate_attention", "ablate_norms"):
        with pytest.raises(TypeError, match=ablation):
            Unet1D(**KW, **{ablation: False})
