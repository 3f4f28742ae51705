"""The port's export to the reference state_dict layout
(diffuscene_tpu_torch/utils/export.py) and its network factory
(models/factory.py) against the JAX package's (diffuscene_tpu/utils/export.py,
models/factory.py).

Each export case takes two random reference-layout state_dicts of one
model: ``source`` is carried into each package by its own loader (the
port's ``reference_to_scene_state_dict`` family, the JAX converters), and
both export those weights into the layout of ``template``.  Held:

- reference layout -> port -> reference layout is the identity, bit for
  bit on every key (the frozen eps is taken out and baked back in float64);
  keys the loaders skip (frozen text encoders, ``num_batches_tracked``,
  AlexNet's classifier) come from the template;
- the port's export equals the JAX package's, bit for bit on every key but
  the frozen ``running_var``: the JAX export reads the eps it bakes back off
  a float32 probe (1.00136e-5 for 1e-5), so there the two differ by up to
  2e-8 (atol 2e-8).
"""
import numpy as np
import pytest
import torch

from diffuscene_tpu.models.factory import build_network as j_build_network
from diffuscene_tpu.utils import export as jexport
from diffuscene_tpu.utils.convert import (convert_autoencoder, convert_denoiser,
                                          convert_feature_extractor, convert_scene_model)
from diffuscene_tpu_torch.models import KLAutoEncoder, SceneDiffusion, Unet1D
from diffuscene_tpu_torch.models import feature_extractors as fe
from diffuscene_tpu_torch.models.factory import build_network
from diffuscene_tpu_torch.utils import export as texport
from diffuscene_tpu_torch.utils.convert import (reference_to_extractor_state_dict,
                                                reference_to_scene_state_dict)
from test_room_mask import _random_resnet18_state_dict
from test_torch_room_mask import _alexnet_reference_state_dict, _cfgs
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


VAR_ATOL = 2e-8      # the JAX export's float32 eps probe


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _randomized(sd, seed):
    """Every float tensor of ``sd`` replaced by random values (running
    variances positive, above the frozen eps); integer counters kept."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sd.items():
        a = _np(v)
        if a.dtype.kind != "f":
            out[k] = torch.as_tensor(a)
        elif k.endswith("running_var"):
            out[k] = torch.from_numpy(rng.uniform(0.5, 1.5, a.shape).astype(np.float32))
        else:
            out[k] = torch.from_numpy(rng.normal(0, 0.5, a.shape).astype(np.float32))
    return out


def _with_counters(sd, value):
    """A torch BatchNorm's num_batches_tracked beside each running_var."""
    out = dict(sd)
    for k in list(sd):
        if k.endswith("running_var"):
            out[k[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(value)
    return out


def _scene_reference(seed):
    """A reference DiffusionSceneLayout_DDPM state_dict of the room-mask
    config (ResNet18 frozen, eps in running_var), with one frozen BERT key."""
    cfg = _cfgs()[1]
    scene = SceneDiffusion(cfg, device="cpu")
    sd = {}
    for k, v in scene.networks.state_dict().items():
        if k.startswith("denoiser."):
            sd["diffusion.model." + k[len("denoiser."):]] = v
        elif k.startswith("conditioner."):
            sd[k[len("conditioner."):]] = v
    sd = _randomized(sd, seed)
    ext = _random_resnet18_state_dict(seed=seed, feature_size=cfg.room_feature_size, frozen=True)
    sd.update({"feature_extractor." + k: torch.as_tensor(v)
               for k, v in _with_counters(ext, 3).items()})
    sd["bertmodel.embeddings.word_embeddings.weight"] = torch.full((4, 8), float(seed))
    return sd


def _denoiser_reference(seed):
    net = Unet1D(dim=32, dim_mults=(1, 1), instanclass_dim=16, text_condition=True,
                 text_dim=24, device="cpu")
    return _randomized(net.state_dict(), seed)


def _autoencoder_reference(seed):
    sd = _randomized(KLAutoEncoder(latent_dim=32, device="cpu").state_dict(), seed)
    return {k: (torch.tensor(7) if k.endswith("num_batches_tracked") else v)
            for k, v in sd.items()}


def _resnet18_reference(seed):
    return {k: torch.as_tensor(v) for k, v in _with_counters(
        _random_resnet18_state_dict(seed=seed, feature_size=32, frozen=True), 5).items()}


def _alexnet_reference(seed):
    return {k: torch.from_numpy(v) for k, v in _alexnet_reference_state_dict(seed).items()}


def _scene_loader(sd):
    """The port's loader of a scene checkpoint, which raises on the frozen
    text encoders' keys (the port does not carry them)."""
    return reference_to_scene_state_dict({k: v for k, v in sd.items()
                                          if not k.startswith("bertmodel.")})


# model -> (reference state_dict of a seed, port loader, port export,
#           JAX converter, JAX export)
CASES = {
    "scene": (_scene_reference, _scene_loader, texport.export_scene_model,
              convert_scene_model, jexport.export_scene_model),
    "denoiser": (_denoiser_reference, dict, texport.export_denoiser,
                 convert_denoiser, jexport.export_denoiser),
    "autoencoder": (_autoencoder_reference, dict, texport.export_autoencoder,
                    convert_autoencoder, jexport.export_autoencoder),
    "resnet18": (_resnet18_reference, reference_to_extractor_state_dict,
                 texport.export_feature_extractor,
                 lambda sd: convert_feature_extractor(sd, "resnet18"),
                 lambda v, t: jexport.export_feature_extractor(v, t, "resnet18")),
    "alexnet": (_alexnet_reference, reference_to_extractor_state_dict,
                texport.export_feature_extractor,
                lambda sd: convert_feature_extractor(sd, "alexnet"),
                lambda v, t: jexport.export_feature_extractor(v, t, "alexnet")),
}


@pytest.mark.parametrize("model", list(CASES))
def test_export_round_trip_and_equals_jax(model):
    make, load, export, jconvert, jexp = CASES[model]
    template, source = make(1), make(2)
    # identity: reference -> port -> reference
    back = export(load(template), template)
    assert back.keys() == template.keys()
    for k, v in template.items():
        assert torch.equal(back[k], torch.as_tensor(v)), k
    # the port's export of the source weights against the JAX package's
    got = export(load(source), template)
    want = jexp(jconvert({k: _np(v) for k, v in source.items()}), template)
    assert got.keys() == want.keys()
    for k in want:
        g, w = _np(got[k]), _np(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k.endswith("running_var"):
            np.testing.assert_allclose(g, w, atol=VAR_ATOL, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    if model == "scene":
        assert torch.equal(got["bertmodel.embeddings.word_embeddings.weight"],
                           template["bertmodel.embeddings.word_embeddings.weight"])


def test_export_loads_into_the_port_and_rejects_other_shapes():
    """An exported scene checkpoint is a reference checkpoint: the port's
    loader takes it back into a SceneDiffusion whose weights are the ones
    exported; a template of another width raises."""
    template = _scene_reference(1)
    scene = SceneDiffusion(_cfgs()[1], device="cpu")
    scene.networks.load_state_dict(_scene_loader(_scene_reference(2)))
    exported = texport.export_scene_model(scene.networks.state_dict(), template)
    again = SceneDiffusion(_cfgs()[1], device="cpu")
    again.networks.load_state_dict(_scene_loader(exported))
    for k, v in scene.networks.state_dict().items():
        assert torch.equal(again.networks.state_dict()[k], v), k
    wide = {k: (torch.zeros(3, 3) if k == "diffusion.model.init_conv.bias" else v)
            for k, v in template.items()}
    with pytest.raises(ValueError, match="init_conv.bias"):
        texport.export_scene_model(scene.networks.state_dict(), wide)


SCENE_NETWORK = {"type": "diffusion_scene_layout_ddpm", "point_dim": 62, "class_dim": 22,
                 "angle_dim": 2, "objectness_dim": 0, "objfeat_dim": 32,
                 "sample_num_points": 12, "room_mask_condition": False,
                 "net_kwargs": {"dim": 16, "dim_mults": [1], "channels": 62, "class_dim": 22,
                                "angle_dim": 2, "objfeat_dim": 32, "instanclass_dim": 8}}


@pytest.mark.parametrize("net_type", ["diffusion_scene_layout_ddpm", "objautoencoder",
                                      "autoencoder", "kl_autoencoder", "unknown"])
def test_build_network_dispatch(net_type, tmp_path):
    """tests/test_parity_extras.py's dispatch cases, in both packages: the
    scene model (and its weights from a reference .pt), the three
    autoencoder names, and an unknown type raising."""
    cfg = ({"network": SCENE_NETWORK} if net_type == "diffusion_scene_layout_ddpm" else
           {"network": {"type": net_type, "objfeat_dim": 32, "kl_weight": 1e-3}})
    if net_type == "unknown":
        for build in (j_build_network, lambda *a: build_network(*a, device="cpu")):
            with pytest.raises(NotImplementedError, match="unknown"):
                build(24, cfg)
        return
    model, state = build_network(24, cfg, device="cpu")
    jmodel, jparams = j_build_network(24, cfg)
    assert state is None and jparams is None and type(model).__name__ == type(jmodel).__name__
    if net_type != "diffusion_scene_layout_ddpm":
        assert model.latent_dim == jmodel.latent_dim == 32 and model.kl_weight == 1e-3
        return
    assert model.cfg.point_dim == jmodel.cfg.point_dim == 62
    ref = {("diffusion.model." + k[len("denoiser."):] if k.startswith("denoiser.")
            else k[len("conditioner."):]): v
           for k, v in _randomized(model.networks.state_dict(), 4).items()}
    path = str(tmp_path / "model.pt")
    torch.save(ref, path)
    loaded, state = build_network(24, cfg, weight_file=path, device="cpu")
    _, jparams = j_build_network(24, cfg, weight_file=path)
    assert state.keys() == loaded.networks.state_dict().keys()
    for k, v in reference_to_scene_state_dict(ref).items():
        assert torch.equal(loaded.networks.state_dict()[k], v), k
    np.testing.assert_array_equal(
        jparams["params"]["denoiser"]["init_conv"]["kernel"],
        ref["diffusion.model.init_conv.weight"][:, :, 0].numpy().T)
