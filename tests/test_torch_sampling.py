"""Parity of the port's diffusion core, samplers and scene model
(diffuscene_tpu_torch/diffusion, models/scene_model.py) with the JAX package.

The whole-chain tests drive both ``SceneDiffusion.sample`` with the same
converted weights, f32: the rows engine (``fused="rows"``, the JAX side in
Pallas interpret mode) and the 3-D engine (``fused=True``) with DDPM, DDIM
and DPM-Solver++; the port replays the JAX sampler's noise stream through
``noise_fn`` (the key splits of diffusion/samplers.py).  Tolerance atol
1e-4: f32 math summed in another order, over 4-5 steps.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffuscene_tpu.diffusion import gaussian as jg
from diffuscene_tpu.diffusion import make_schedule as j_make_schedule
from diffuscene_tpu.models import SceneDiffusion as JSceneDiffusion
from diffuscene_tpu.models import SceneModelConfig as JSceneModelConfig
from diffuscene_tpu_torch.diffusion import gaussian as tg
from diffuscene_tpu_torch.diffusion import make_schedule
from diffuscene_tpu_torch.models import SceneDiffusion, SceneModelConfig
from diffuscene_tpu_torch.utils.convert import load_jax_params
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_YAML = os.path.join(REPO, "configs/uncond/diffusion_bedrooms_instancond_lat32_v.yaml")


@pytest.mark.parametrize("schedule", ["linear", "warm0.1", "cosine"])
@pytest.mark.parametrize("mean_type", ["eps", "v"])
def test_schedule_coefficients_equal_jax(schedule, mean_type):
    """Both round the same float64 numpy precompute to float32: equal."""
    js = j_make_schedule(schedule, 1e-4, 0.02, 1000, model_mean_type=mean_type)
    ts = make_schedule(schedule, 1e-4, 0.02, 1000, model_mean_type=mean_type)
    for f in ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
              "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
              "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
              "posterior_variance", "posterior_log_variance_clipped",
              "posterior_mean_coef1", "posterior_mean_coef2", "loss_weight",
              "fixedlarge_log_variance"):
        want = np.asarray(getattr(js, f))
        got = getattr(ts, f).numpy()
        assert got.dtype == np.float32 and np.array_equal(got, want), f
    assert ts.num_timesteps == js.num_timesteps


@pytest.mark.parametrize("mean_type", ["eps", "x0", "v"])
@pytest.mark.parametrize("var_type", ["fixedsmall", "fixedlarge"])
@pytest.mark.parametrize("clip", [False, True])
def test_p_mean_variance_matches_jax(mean_type, var_type, clip):
    js = j_make_schedule("linear", 1e-4, 0.02, 50, model_mean_type=mean_type)
    ts = make_schedule("linear", 1e-4, 0.02, 50, model_mean_type=mean_type)
    rng = np.random.default_rng(0)
    out = rng.normal(size=(6, 12, 62)).astype(np.float32)
    x = rng.normal(size=(6, 12, 62)).astype(np.float32)
    t = np.array([0, 1, 7, 20, 48, 49], np.int32)
    want = jg.p_mean_variance(js, mean_type, var_type, jnp.asarray(out), jnp.asarray(x),
                              jnp.asarray(t), clip)
    got = tg.p_mean_variance(ts, mean_type, var_type, torch.from_numpy(out),
                             torch.from_numpy(x), torch.from_numpy(t).long(), clip)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def _cfgs(time_num=5, **net):
    """The JAX and port scene configs at small size; ``net`` overrides the
    network's keyword arguments."""
    nk = {**dict(dim=64, dim_mults=(1, 1, 1, 1), channels=62, objectness_dim=0, class_dim=22,
                 angle_dim=2, objfeat_dim=32, context_dim=0, instanclass_dim=32,
                 seperate_all=True), **net}
    kw = dict(point_dim=62, class_dim=22, angle_dim=2, objectness_dim=0, objfeat_dim=32,
              sample_num_points=12, room_mask_condition=False, instance_condition=True,
              learnable_embedding=True, instance_emb_dim=32, model_mean_type="v",
              model_var_type="fixedsmall", schedule_type="linear", beta_start=1e-4,
              beta_end=0.02, time_num=time_num, loss_separate=True, loss_iou=False,
              net_kwargs=tuple(sorted(nk.items())))
    return JSceneModelConfig(**kw), SceneModelConfig(**kw)


@functools.lru_cache(maxsize=None)
def _init_shapes(jcfg):
    """The JAX init tree's shapes of a config, traced once a process."""
    return jax.eval_shape(JSceneDiffusion(jcfg).init, jax.random.PRNGKey(0))


def _random_params(jscene):
    shapes = _init_shapes(jscene.cfg)
    rng = np.random.default_rng(11)

    def leaf(path, a):
        name = path[-1].key
        if name == "kernel":
            return (rng.normal(size=a.shape) / np.sqrt(a.shape[0])).astype(np.float32)
        base = 1.0 if name in ("scale", "g") else 0.0
        width = 1.0 if name == "positional_embedding" else 0.1
        return (base + rng.normal(size=a.shape) * width).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_noise(key, shape, n_draws):
    """The JAX samplers' noise stream: x_T from the first split, then one
    split per drawing step (diffusion/samplers.py)."""
    k, init_key = jax.random.split(key)
    noises = [np.asarray(jax.random.normal(init_key, shape, jnp.float32))]
    for _ in range(n_draws):
        k, sub = jax.random.split(k)
        noises.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return noises


def _sample_matches_jax(time_num, fused, n_draws, net=None, atol=1e-4, **kwargs):
    jcfg, cfg = _cfgs(time_num=time_num, **(net or {}))
    jscene = JSceneDiffusion(jcfg)
    params = _random_params(jscene)
    B, shape = 4, (4, 12, 62)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax.jit(lambda p, k: jscene.sample(
        p, k, batch_size=B, clip_denoised=True, fused=fused, **kwargs))(params, key))
    noises = _jax_noise(key, shape, n_draws)

    def noise_fn(shp):
        a = noises.pop(0)
        assert tuple(shp) == a.shape
        return torch.from_numpy(a.copy())

    scene = SceneDiffusion(cfg, device="cpu")
    load_jax_params(scene, params)
    got = scene.sample(B, clip_denoised=True, fused=fused, noise_fn=noise_fn, **kwargs).numpy()
    assert not noises  # the port drew exactly the JAX stream
    assert got.shape == shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    return scene, jscene, got


def test_scene_config_from_flagship_yaml_matches_jax():
    with open(FLAGSHIP_YAML) as f:
        network = yaml.safe_load(f)["network"]
    want = JSceneModelConfig.from_config(network)
    got = SceneModelConfig.from_config(network)
    for field in want.__dataclass_fields__:
        assert getattr(got, field) == getattr(want, field), field
    # the port also keeps the config's feature_extractor section, which the
    # JAX package does not read (it always builds resnet18, 64, 1)
    extractor = {"feature_extractor", "room_feature_size", "room_input_channels"}
    assert got.__dataclass_fields__.keys() == want.__dataclass_fields__.keys() | extractor
    assert (got.feature_extractor, got.room_feature_size, got.room_input_channels) == \
        ("resnet18", 64, 1)


def test_sampler_needs_one_noise_source_and_rejects_unported_paths():
    _, cfg = _cfgs(time_num=2)
    scene = SceneDiffusion(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        scene.sample(2)
    out = scene.sample(2, generator=torch.Generator().manual_seed(1))
    again = scene.sample(2, generator=torch.Generator().manual_seed(1))
    assert torch.equal(out, again)
    # completion and arrangement run their own ancestral chains only
    tasks = (dict(partial_boxes=torch.zeros(2, 3, 62)), dict(input_boxes=torch.zeros(2, 12, 62)))
    for task in tasks:
        for fast in (dict(ddim=True), dict(dpm=True)):
            with pytest.raises(ValueError, match="ancestral"):
                scene.sample(2, generator=torch.Generator(), **task, **fast)
    # room-mask conditioning needs fc_room_f's width, as in the JAX package
    with pytest.raises(ValueError, match="latent_dim"):
        SceneDiffusion(dataclasses.replace(cfg, room_mask_condition=True), device="cpu")
