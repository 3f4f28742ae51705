"""Parity of the port's room-mask conditioning with the JAX package: the
frozen-BN feature extractors (models/feature_extractors.py) against the
JAX modules on shared weights, the reference-checkpoint loader against the
functional torch oracle of tests/test_room_mask.py (the frozen eps taken
out), ``fc_room_f`` in the condition and the bridge both ways; in
tests/test_torch_room_mask_model.py, on this file's models and
tolerances, ``get_loss`` with its gradients, one Adam step (the frozen
statistics untouched) and a DDPM sample through the module and both
engines' CPU twins with JAX's noise replayed.

Small sizes: the extractors at (2, 1, 64, 64) and F=32; the scene model is
tests/test_room_mask.py's (dim 32, 2 levels, N=12, latent_dim 64, a
ResNet18 of 64 features over 64x64 masks), B=4.  Tolerances: the
extractors atol and rtol 1e-4 (f32 convolutions summed in other orders,
17 deep), the loss relative 1e-5 and each gradient relative L2 1e-4, the
sample atol 1e-4 (tests/test_torch_tasks.py's).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuscene_tpu.models import SceneDiffusion as JSceneDiffusion
from diffuscene_tpu.models import SceneModelConfig as JSceneModelConfig
from diffuscene_tpu.models import feature_extractors as jfe
from diffuscene_tpu.utils import convert_feature_extractor
from diffuscene_tpu_torch.models import SceneDiffusion, SceneModelConfig
from diffuscene_tpu_torch.models import feature_extractors as fe
from diffuscene_tpu_torch.utils.convert import (load_jax_extractor, load_jax_params,
                                                reference_to_scene_state_dict,
                                                scene_batch_stats, scene_tree)

from test_room_mask import _random_resnet18_state_dict, _torch_resnet18_forward
from test_torch_losses import _flat, _scene_batch
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


B, N, T = 4, 12, 5
EXTRACTOR_TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_RTOL, GRAD_REL_L2, SAMPLE_ATOL = 1e-5, 1e-4, 1e-4
TRAINING = {"optimizer": "Adam", "lr": 1e-4, "schedule": "step", "lr_step": 1000,
            "lr_decay": 0.5, "max_grad_norm": 10.0}


def _fill(shapes, seed):
    """Numpy leaves in the shapes of a JAX variable tree: convolution
    kernels N(0, 2 / fan_in), other kernels N(0, 1 / fan_in), running
    means N(0, 0.1), running variances U(0.5, 1.5), norm scales around 1,
    biases around 0."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            std = np.sqrt((2.0 if len(a.shape) == 4 else 1.0) / fan_in)
            return (rng.normal(size=a.shape) * std).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        base = 1.0 if name in ("scale", "g") else 0.0
        return (base + rng.normal(size=a.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _masks(seed, batch=B, size=64):
    """Room masks in [0, 1], (batch, 1, size, size): a filled rectangle a
    scene, its edges softened as a resized mask's are."""
    rng = np.random.default_rng(seed)
    out = np.zeros((batch, 1, size, size), np.float32)
    for m in out:
        y0, x0 = rng.integers(2, size // 3, 2)
        y1, x1 = rng.integers(2 * size // 3, size - 2, 2)
        m[0, y0:y1, x0:x1] = 1.0
        m[0, y0, x0:x1] = m[0, y0:y1, x0] = 0.5
    return out


@pytest.mark.parametrize("name", ["frozen_bn", "resnet18", "alexnet"])
def test_extractors_match_jax(name):
    """FrozenBatchNorm (8 channels), ResNet18 and AlexNet (F=32) on JAX
    variables loaded through the bridge, at (2, 1, 64, 64) (NCHW for the
    port, NHWC for the JAX modules): atol and rtol 1e-4; the frozen
    statistics are the port's buffers, not parameters."""
    rng = np.random.default_rng(1)
    if name == "frozen_bn":
        jmod, mod = jfe.FrozenBatchNorm(8), fe.FrozenBatchNorm(8)
        x = rng.normal(size=(2, 8, 16, 16)).astype(np.float32)
    else:
        jmod = jfe.get_feature_extractor(name, feature_size=32)
        mod = fe.get_feature_extractor(name, feature_size=32)
        x = _masks(2, batch=2)
    xj = np.transpose(x, (0, 2, 3, 1))
    variables = _fill(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), xj), seed=3)
    if name == "frozen_bn":
        p, s = variables["params"], variables["batch_stats"]
        with torch.no_grad():
            for t, a in ((mod.weight, p["scale"]), (mod.bias, p["bias"]),
                         (mod.running_mean, s["mean"]), (mod.running_var, s["var"])):
                t.copy_(torch.from_numpy(a))
    else:
        load_jax_extractor(mod, variables)
    want = np.asarray(jax.jit(jmod.apply)(variables, xj))
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    if name == "frozen_bn":
        got = np.transpose(got, (0, 2, 3, 1))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **EXTRACTOR_TOL)
    stats = {n for n, _ in mod.named_buffers()}
    assert stats == ({n for n in mod.state_dict() if n.endswith(("running_mean", "running_var"))})
    assert not stats & {n for n, _ in mod.named_parameters()}
    assert bool(stats) == (name != "alexnet")


@pytest.mark.parametrize("k,stride,pad,bias", [(7, 2, 3, False), (3, 1, 1, False),
                                                (1, 2, 0, False), (11, 4, 2, True)])
def test_unfolded_conv_is_the_convolution(k, stride, pad, bias):
    """The extractor's Conv2d (the input's windows and one matmul) against
    nn.Conv2d on the same weights, f32: the output and the input, weight
    and bias gradients within 1e-4 (atol and rtol: the weight gradients
    sum ~1000 products of O(1) in another order); an input window of zeros
    gives exactly 0 before the bias."""
    torch.manual_seed(k)
    conv = fe.Conv2d(3, 4, k, stride=stride, padding=pad, bias=bias)
    ref = torch.nn.Conv2d(3, 4, k, stride=stride, padding=pad, bias=bias)
    ref.load_state_dict(conv.state_dict())
    x = torch.randn(2, 3, 23, 23, requires_grad=True)
    out = conv(x)
    torch.testing.assert_close(out, ref(x), atol=1e-4, rtol=1e-4)
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, [x, *conv.parameters()], g)
    want = torch.autograd.grad(ref(x), [x, *ref.parameters()], g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    zeros = torch.zeros(1, 3, 23, 23)
    with torch.no_grad():
        z = conv(zeros) - (conv.bias[:, None, None] if bias else 0)
    assert torch.equal(z, torch.zeros_like(z))


def _alexnet_reference_state_dict(seed):
    """A reference AlexNet wrapper state_dict (feature_extractors.py:47-68),
    with torchvision's unused classifier, random weights."""
    rng = np.random.default_rng(seed)
    sd = {}
    for idx, cout, k, _, _ in fe._ALEXNET:
        cin = 1 if idx == 0 else {3: 64, 6: 192, 8: 384, 10: 256}[idx]
        sd[f"_feature_extractor.features.{idx}.weight"] = rng.normal(
            0, 1.0 / np.sqrt(cin * k * k), (cout, cin, k, k)).astype(np.float32)
        sd[f"_feature_extractor.features.{idx}.bias"] = rng.normal(0, 0.05, cout).astype(np.float32)
    sd["_feature_extractor.classifier.1.weight"] = np.zeros((8, 9216), np.float32)
    sd["_fc.weight"] = rng.normal(0, 1.0 / np.sqrt(9216), (32, 9216)).astype(np.float32)
    sd["_fc.bias"] = rng.normal(0, 0.05, 32).astype(np.float32)
    return sd


def _alexnet_oracle(sd, x):
    """The reference AlexNet.forward (feature_extractors.py:63-68) as
    functional torch."""
    import torch.nn.functional as F

    y = x
    for idx, _, _, stride, pad in fe._ALEXNET:
        y = F.relu(F.conv2d(y, torch.from_numpy(sd[f"_feature_extractor.features.{idx}.weight"]),
                            torch.from_numpy(sd[f"_feature_extractor.features.{idx}.bias"]),
                            stride=stride, padding=pad))
        if idx in (0, 3, 10):
            y = F.max_pool2d(y, 3, 2)
    y = F.adaptive_avg_pool2d(y, (6, 6)).reshape(y.shape[0], -1)
    return F.linear(y, torch.from_numpy(sd["_fc.weight"]), torch.from_numpy(sd["_fc.bias"]))


def _load_reference(mod, sd):
    scene_sd = reference_to_scene_state_dict({"feature_extractor." + k: v for k, v in sd.items()})
    mod.load_state_dict({k[len("feature_extractor."):]: torch.as_tensor(v)
                         for k, v in scene_sd.items()}, strict=True)


@pytest.mark.parametrize("name", ["resnet18", "alexnet"])
def test_reference_loader_matches_torch_oracle(name):
    """A reference checkpoint's extractor keys (ResNet18's frozen BNs with
    the eps baked into running_var; AlexNet's features and _fc) through
    ``reference_to_scene_state_dict`` into the port's module, against the
    reference forward replayed functionally (tests/test_room_mask.py's
    oracle): atol and rtol 1e-4, and against the JAX package's converter
    on the same state_dict."""
    x = np.random.default_rng(4).uniform(0, 1, (2, 1, 64, 64)).astype(np.float32)
    if name == "resnet18":
        sd = _random_resnet18_state_dict(seed=3, feature_size=32, frozen=True)
        oracle = functools.partial(_torch_resnet18_forward, sd)
    else:
        sd = _alexnet_reference_state_dict(seed=5)
        oracle = functools.partial(_alexnet_oracle, sd)
    mod = fe.get_feature_extractor(name, feature_size=32)
    _load_reference(mod, sd)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
        want = oracle(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **EXTRACTOR_TOL)
    jvars = convert_feature_extractor(sd, name)
    jwant = np.asarray(getattr(jfe, {"resnet18": "ResNet18", "alexnet": "AlexNet"}[name])(
        feature_size=32).apply(jvars, np.transpose(x, (0, 2, 3, 1))))
    np.testing.assert_allclose(got, jwant, **EXTRACTOR_TOL)


def test_frozen_eps_is_taken_out_of_running_var():
    """The hazard of FrozenBatchNorm2d.freeze: the reference bakes eps 1e-5
    into running_var and its forward adds none; the port's forward adds
    1e-5, so the loader subtracts it (in f64, clamped at 0, as the JAX
    converter does).  A channel whose true variance is 1e-5: taken out,
    the port's scale equals the reference's; left in, it is off by
    sqrt(1.5)."""
    sd = _random_resnet18_state_dict(seed=6, feature_size=32, frozen=True)
    key = "_feature_extractor.bn1.running_var"
    sd[key][:3] = np.array([2e-5, 1e-5, 4e-6], np.float32)    # baked: true 1e-5, 0, < 0
    mod = fe.ResNet18(feature_size=32)
    _load_reference(mod, sd)
    want = np.maximum(sd[key].astype(np.float64) - 1e-5, 0.0).astype(np.float32)
    assert np.array_equal(mod.bn1.running_var.numpy(), want)
    assert (mod.bn1.running_var[1:3] == 0).all()
    bn = mod.bn1
    x = torch.ones(1, 64, 1, 1)
    with torch.no_grad():
        got = bn(x)[0, 0, 0, 0].item()
        ref_scale = sd["_feature_extractor.bn1.weight"][0] / np.sqrt(np.float32(2e-5))
        ref = ref_scale + sd["_feature_extractor.bn1.bias"][0] - \
            sd["_feature_extractor.bn1.running_mean"][0] * ref_scale
        bn.running_var.copy_(torch.from_numpy(sd[key]))          # the eps left in
        left_in = bn(x)[0, 0, 0, 0].item()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert abs(left_in - ref) > 0.1 * abs(ref)


@pytest.mark.parametrize("out", [3, 6, 9])
def test_adaptive_avg_pool_matches_jax(out):
    """torch's adaptive pool against the JAX package's bin rule on 7x7,
    out=9 > H included: atol 1e-6."""
    x = np.random.default_rng(out).normal(size=(2, 5, 7, 7)).astype(np.float32)
    want = np.asarray(jfe.adaptive_avg_pool_2d(jnp.asarray(np.transpose(x, (0, 2, 3, 1))), out))
    got = fe.adaptive_avg_pool_2d(torch.from_numpy(x), out).numpy()
    np.testing.assert_allclose(np.transpose(got, (0, 2, 3, 1)), want, atol=1e-6, rtol=0)


def _cfgs(time_num=T):
    """tests/test_room_mask.py's room-mask config in both packages."""
    nk = dict(dim=32, dim_mults=(1, 1), channels=62, objectness_dim=0, class_dim=22,
              angle_dim=2, objfeat_dim=32, context_dim=64, instanclass_dim=16,
              seperate_all=True)
    kw = dict(point_dim=62, class_dim=22, angle_dim=2, objectness_dim=0, objfeat_dim=32,
              sample_num_points=N, room_mask_condition=True, latent_dim=64,
              instance_condition=True, learnable_embedding=True, instance_emb_dim=16,
              model_mean_type="v", model_var_type="fixedsmall", time_num=time_num,
              loss_separate=True, loss_iou=False, net_kwargs=tuple(sorted(nk.items())))
    return JSceneModelConfig(**kw), SceneModelConfig(**kw)


@functools.lru_cache(maxsize=None)
def _shapes(time_num):
    return jax.eval_shape(JSceneDiffusion(_cfgs(time_num)[0]).init, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _variables(time_num, seed):
    """The JAX variables of a seed (shared between tests; none mutates them)."""
    return _fill(_shapes(time_num), seed)


def _models(time_num=T, seed=11):
    jcfg, cfg = _cfgs(time_num)
    jscene = JSceneDiffusion(jcfg)
    variables = _variables(time_num, seed)
    scene = SceneDiffusion(cfg, device="cpu")
    load_jax_params(scene, variables)
    return jscene, variables, scene


def test_bridge_round_trip_with_batch_stats():
    """load_jax_params then scene_tree and scene_batch_stats give the JAX
    variables back bit for bit, the extractor's params, its batch_stats and
    fc_room_f included; the frozen statistics are buffers."""
    _, variables, scene = _models()
    back = {"params": scene_tree(scene), "batch_stats": scene_batch_stats(scene)}
    got = _flat(jax.tree.map(lambda a: a.numpy(), back))
    want = _flat(variables)
    assert got.keys() == want.keys()
    assert any("fc_room_f" in k for k in got) and any("batch_stats" in k for k in got)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    buffers = dict(scene.networks.named_buffers())
    assert len(buffers) == 2 * 20 and all(k.startswith("feature_extractor.") for k in buffers)


@pytest.mark.parametrize("sampler", [{}, {"ddim": True, "ddim_steps": 3},
                                     {"dpm": True, "dpm_steps": 3}])
def test_inverted_masks_give_other_samples(sampler):
    """The same noise with the masks inverted (1 - mask) through DDPM, DDIM
    and DPM-Solver++ on the 3-D engine's twin: finite samples that differ;
    with room_feat given, the extractor does not run."""
    _, _, scene = _models(seed=18)
    rl = torch.from_numpy(_masks(19))

    def run(**cond):
        return scene.sample(B, generator=torch.Generator().manual_seed(20), clip_denoised=True,
                            fused=True, **sampler, **cond)

    a, b = run(room_layout=rl), run(room_layout=1.0 - rl)
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    assert (a - b).abs().max().item() > 1e-3
    with torch.no_grad():
        feat = scene.feature_extractor(rl)
    scene.feature_extractor.register_forward_hook(lambda *x: pytest.fail("extractor ran"))
    assert torch.equal(run(room_feat=feat), a)


def test_room_mask_model_needs_its_masks():
    """A room-mask model raises ValueError without room_layout or room_feat
    (sample and get_loss); latent_dim 0 raises as in the JAX package;
    freeze_bn: false raises."""
    _, _, scene = _models()
    with pytest.raises(ValueError, match="room_layout"):
        scene.sample(B, generator=torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _scene_batch(np.random.default_rng(0)).items()}
    with pytest.raises(ValueError, match="room_layout"):
        scene.get_loss(batch)
    _, cfg = _cfgs()
    import dataclasses

    with pytest.raises(ValueError, match="latent_dim"):
        SceneDiffusion(dataclasses.replace(cfg, latent_dim=0), device="cpu")
    with pytest.raises(ValueError, match="freeze_bn"):
        SceneModelConfig.from_config({"room_mask_condition": True, "latent_dim": 64},
                                     {"name": "resnet18", "freeze_bn": False})
