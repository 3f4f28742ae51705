"""The port's 3-D engine on the widths and GroupNorm groupings the card's
kernels took on in their widening (models/inference.py, on the CPU the
plain B1 and B2), against the JAX 3-D engine: one forward and a 5-step
DDPM through ``SceneDiffusion.sample(fused=True)`` with the JAX noise
stream replayed (tests/test_torch_sampling.py's ``_sample_matches_jax``).
A file of its own so that the test runner's file scheduler starts these
slow cases beside the long JAX files, not before them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuscene_tpu.models.denoiser import Unet1D as JUnet1D
from diffuscene_tpu_torch.models.inference import fused_unet1d_forward, prepare_inference_params
from diffuscene_tpu_torch.utils.convert import denoiser_tree
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


# the widths and groupings the card's kernels took on in their widening,
# at small size: the [1, 1, 2, 2] Unet1D at dim 64 (levels 64 and 128
# wide), the [1, 1, 1, 1] one at dim 128 in 4 and in 16 groups, in f32 and
# (the "bf16_" cases, the b512 recipes' serving dtype) in bf16
WIDE = {"mults1122": dict(dim=64, dim_mults=(1, 1, 2, 2)),
        "groups4": dict(dim=128, resnet_block_groups=4),
        "groups16": dict(dim=128, resnet_block_groups=16),
        "bf16_mults1122": dict(dim=64, dim_mults=(1, 1, 2, 2), compute_dtype="bfloat16"),
        "bf16_groups16": dict(dim=128, resnet_block_groups=16, compute_dtype="bfloat16")}
# engine vs the JAX engine: f32 the same math summed in another order; bf16
# tests/test_torch_engine.py's bf16 bound (the two round at other places)
WIDE_TOL = {"f32": 1e-4, "bf16": 1.5e-1}


@pytest.mark.parametrize("name", list(WIDE))
def test_wide_models_match_the_jax_3d_engine(name):
    """A scene model of WIDE's widths, weights from one seed carried from
    the Flax tree by the port's utils/convert.py (load_jax_params): the
    port's 3-D engine (on the CPU, the plain B1 and B2) against the JAX 3-D
    engine, within WIDE_TOL of the model's dtype, on one forward at 4
    timesteps; its 28 blocks at the shapes inference.block_shapes gives;
    then a 5-step DDPM through SceneDiffusion.sample(fused=True) on both,
    the JAX noise stream replayed, within the same bound."""
    from diffuscene_tpu.models import inference as jinf
    from diffuscene_tpu_torch.models import inference as tinf
    from test_torch_sampling import _random_params, _sample_matches_jax

    atol = WIDE_TOL["bf16" if name.startswith("bf16_") else "f32"]
    scene, jscene, _ = _sample_matches_jax(5, True, 5, net=WIDE[name], atol=atol)
    jparams = _random_params(jscene)["params"]["denoiser"]
    net = scene.denoiser
    rng = np.random.default_rng(21)
    x = rng.normal(size=(4, 12, 62)).astype(np.float32)
    t = np.array([0, 1, 3, 4], np.int32)
    cond = rng.normal(size=(4, 12, 32)).astype(np.float32)
    kw = dict(scene.cfg.net_kwargs)
    if "compute_dtype" in kw:
        kw["compute_dtype"] = jnp.bfloat16
    jnet = JUnet1D(**kw)
    jprep = jinf.prepare_inference_params(jnet, jparams, num_timesteps=5)
    want = np.asarray(jax.jit(lambda x, t, c: jinf.fused_unet1d_forward(
        jnet, jprep, x, t, c, None, exact_gelu=True))(x, t, cond))
    prep = prepare_inference_params(net, denoiser_tree(net), num_timesteps=5)
    shapes = []
    rb = tinf.fused_resnet_block

    def recorded(h, film, w1, *a, skip=None, **k):
        shapes.append((w1.shape[1], h.shape[1], 0 if skip is None else skip.shape[1]))
        return rb(h, film, w1, *a, skip=skip, **k)

    tinf.fused_resnet_block = recorded
    try:
        got = fused_unet1d_forward(net, prep, torch.from_numpy(x), torch.from_numpy(t).long(),
                                   torch.from_numpy(cond), exact_gelu=True).numpy()
    finally:
        tinf.fused_resnet_block = rb
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    assert shapes == tinf.block_shapes(net)

