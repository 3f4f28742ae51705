"""Weight bridge between the port's ``Unet1D`` and the Flax param tree.

The port's modules carry the reference DiffuScene state_dict layout
(``models/denoiser.py``), which ``diffuscene_tpu.utils.convert.convert_denoiser``
turns into the Flax ``Unet1D`` tree.  This module is its inverse:

- :func:`flax_to_torch_denoiser` maps a Flax tree of numpy arrays to a port
  state_dict (``convert_denoiser`` of the result gives the tree back, bit
  for bit);
- :func:`denoiser_tree` maps a port module's tensors to the Flax layout the
  serving engine reads (``models/inference.py``), on the module's device;
- :func:`load_jax_params` loads a JAX ``SceneNetworks`` variable tree, as
  numpy arrays, into a port ``SceneDiffusion``, and :func:`scene_tree` maps
  a port ``SceneDiffusion``'s parameters (or any tensors named like them,
  such as their gradients) the other way, a room-mask model's feature
  extractor among them (its frozen BatchNorm statistics in the
  ``batch_stats`` collection);
- :func:`flax_to_torch_autoencoder` is the inverse of
  ``convert_autoencoder`` for the shape autoencoder, and
  :func:`load_jax_autoencoder` loads JAX variables into a port
  ``KLAutoEncoder``.

Tensor rules: Conv1d (O, I, 1) <-> Dense kernel (I, O); Linear (O, I) <->
(I, O); GroupNorm weight/bias <-> scale/bias; LayerNorm g (1, C, 1) <-> (C,);
Conv2d (O, I, kH, kW) <-> (kH, kW, I, O); FrozenBatchNorm weight/bias <->
params scale/bias, running_mean/running_var <-> batch_stats mean/var.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

_SLOTS = {"block0": 0, "block1": 1, "attncross": 2, "block2": 3, "attn": 4, "proj": 5}
_SLOT_NAMES = {v: k for k, v in _SLOTS.items()}

Path = Tuple[str, ...]


def _resblock_to_torch(sub: Path) -> Tuple[str, str]:
    """ResnetBlock-internal flax subpath -> (torch key suffix, kind)."""
    if sub[0] == "mlp":
        return f"mlp.1.{'weight' if sub[1] == 'kernel' else 'bias'}", "linear"
    if sub[0] in ("block1", "block2"):
        if sub[1] == "proj":
            return f"{sub[0]}.proj.{'weight' if sub[2] == 'kernel' else 'bias'}", "conv"
        return f"{sub[0]}.norm.{'weight' if sub[2] == 'scale' else 'bias'}", "vec"
    if sub[0] == "res_conv":
        return f"res_conv.{'weight' if sub[1] == 'kernel' else 'bias'}", "conv"
    raise KeyError(sub)


def _attn_to_torch(sub: Path, full: bool) -> Tuple[str, str]:
    """Attention-internal flax subpath -> (key under ``fn.fn.``, kind)."""
    if sub[0] in ("to_qkv", "to_q", "to_kv"):
        return f"{sub[0]}.weight", "conv"
    if sub[0] == "to_out":
        kind = "weight" if sub[1] == "kernel" else "bias"
        return (f"to_out.{kind}" if full else f"to_out.0.{kind}"), "conv"
    if sub == ("out_norm", "g"):
        return "to_out.1.g", "g"
    raise KeyError(sub)


def _flax_to_torch_key(path: Path) -> Tuple[str, str]:
    """Flax Unet1D param path -> (torch state_dict key, tensor kind)."""
    name, sub = path[0], path[1:]
    leaf = "weight" if sub[-1] == "kernel" else "bias"
    m = re.match(r"(bbox|class|objectness|objfeat)_(embedf|hidden2output)$", name)
    if m:
        return f"{name}.{2 * int(sub[0][2:])}.{leaf}", "conv"
    if name in ("init_conv", "final_conv"):
        return f"{name}.{leaf}", "conv"
    if name in ("time_mlp_1", "time_mlp_2"):
        return f"time_mlp.{1 if name == 'time_mlp_1' else 3}.{leaf}", "linear"
    if name == "sinu_pos_emb":                      # the Fourier time features
        return "sinu_pos_emb.weights", "vec"
    m = re.match(r"(down|up)(\d+)_(block[012]|proj|attn|attncross)(_norm)?$", name)
    if m:
        stack, lvl, slot, norm = m.groups()
        base = f"{stack}s.{lvl}.{_SLOTS[slot]}"
        if norm:
            return f"{base}.fn.norm.g", "g"
        if slot == "proj":
            return f"{base}.{leaf}", "conv"
        if slot.startswith("block"):
            key, kind = _resblock_to_torch(sub)
            return f"{base}.{key}", kind
        key, kind = _attn_to_torch(sub, full=False)
        return f"{base}.fn.fn.{key}", kind
    if name in ("mid_block0", "mid_block1", "mid_block2", "final_res_block"):
        key, kind = _resblock_to_torch(sub)
        return f"{name}.{key}", kind
    if name == "mid_attn_norm":
        return "mid_attn.fn.norm.g", "g"
    if name == "mid_attn":
        key, kind = _attn_to_torch(sub, full=True)
        return f"mid_attn.fn.fn.{key}", kind
    # the text models' mid cross-attention (reference name mid_attn_cross)
    if name == "mid_attncross_norm":
        return "mid_attn_cross.fn.norm.g", "g"
    if name == "mid_attncross":
        key, kind = _attn_to_torch(sub, full=False)
        return f"mid_attn_cross.fn.fn.{key}", kind
    raise KeyError(f"unmapped flax denoiser path: {path}")


def _torch_to_flax_key(key: str) -> Tuple[Path, str]:
    """Torch state_dict key -> (flax param path, tensor kind)."""
    parts = key.split(".")
    leaf = parts[-1]
    m = re.match(r"(bbox|class|objectness|objfeat)_(embedf|hidden2output)$", parts[0])
    if m:
        fc = f"fc{int(parts[1]) // 2}"
        return (parts[0], fc, "kernel" if leaf == "weight" else "bias"), "conv"
    if parts[0] in ("init_conv", "final_conv"):
        return (parts[0], "kernel" if leaf == "weight" else "bias"), "conv"
    if parts[0] == "time_mlp":
        name = "time_mlp_1" if parts[1] == "1" else "time_mlp_2"
        return (name, "kernel" if leaf == "weight" else "bias"), "linear"
    if parts[0] == "sinu_pos_emb":
        return ("sinu_pos_emb", "weights"), "vec"
    if parts[0] in ("downs", "ups"):
        prefix = "down" if parts[0] == "downs" else "up"
        slot = _SLOT_NAMES[int(parts[2])]
        name = f"{prefix}{parts[1]}_{slot}"
        rest = parts[3:]
    elif parts[0] in ("mid_block0", "mid_block1", "mid_block2", "final_res_block", "mid_attn",
                      "mid_attn_cross"):
        slot = "block" if parts[0].startswith(("mid_block", "final")) else "attn"
        name = "mid_attncross" if parts[0] == "mid_attn_cross" else parts[0]
        rest = parts[1:]
    else:
        raise KeyError(f"unmapped torch denoiser key: {key}")
    if slot == "proj":
        return (name, "kernel" if leaf == "weight" else "bias"), "conv"
    if slot.startswith("block"):
        if rest[0] == "mlp":
            return (name, "mlp", "kernel" if leaf == "weight" else "bias"), "linear"
        if rest[0] in ("block1", "block2"):
            if rest[1] == "proj":
                return (name, rest[0], "proj", "kernel" if leaf == "weight" else "bias"), "conv"
            return (name, rest[0], "norm", "scale" if leaf == "weight" else "bias"), "vec"
        return (name, "res_conv", "kernel" if leaf == "weight" else "bias"), "conv"
    # attention: Residual(PreNorm(fn)) -> fn.norm.g / fn.fn.*
    if rest[:2] == ["fn", "norm"]:
        return (f"{name}_norm", "g"), "g"
    inner = rest[2:]
    if inner[0] in ("to_qkv", "to_q", "to_kv"):
        return (name, inner[0], "kernel"), "conv"
    if inner[:2] == ["to_out", "1"]:
        return (name, "out_norm", "g"), "g"
    return (name, "to_out", "kernel" if leaf == "weight" else "bias"), "conv"


def _to_torch_layout(a, kind: str):
    if kind == "conv":
        return a.T[:, :, None]
    if kind == "linear":
        return a.T
    if kind == "g":
        return a.reshape(1, -1, 1)
    return a


def _to_flax_layout(t, kind: str):
    if kind == "conv":
        return t[:, :, 0].t()
    if kind == "linear":
        return t.t()
    if kind == "g":
        return t.reshape(-1)
    return t


def _flatten(tree: Dict[str, Any], prefix: Path = ()) -> Iterator[Tuple[Path, Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set(tree: Dict, path: Path, leaf) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = leaf


def flax_to_torch_denoiser(np_tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``Unet1D`` params (numpy leaves) -> port ``Unet1D`` state_dict
    (CPU float32 tensors)."""
    out = {}
    for path, a in _flatten(np_tree):
        key, kind = _flax_to_torch_key(path)
        if path[-1] == "bias":
            kind = "vec"
        arr = np.ascontiguousarray(_to_torch_layout(np.asarray(a, np.float32), kind))
        out[key] = torch.from_numpy(arr)
    return out


def denoiser_tree(net: torch.nn.Module,
                  values: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, Any]:
    """A port ``Unet1D``'s parameters in the Flax tree layout ((in, out)
    kernels), as tensors on the module's device.  ``values`` (keyed by the
    module's state_dict names, e.g. the parameters' gradients) replaces the
    parameters themselves."""
    tree: Dict[str, Any] = {}
    for key, t in (net.state_dict() if values is None else values).items():
        path, kind = _torch_to_flax_key(key)
        if path[-1] == "bias":
            kind = "vec"
        _set(tree, path, _to_flax_layout(t.detach(), kind))
    return tree


# conditioner: port state_dict key -> (flax path under "conditioner", kind)
_CONDITIONER = {
    "positional_embedding": (("positional_embedding",), "vec"),
    "fc_instance_condition.0.weight": (("fc_instance_0", "kernel"), "linear"),
    "fc_instance_condition.2.weight": (("fc_instance_1", "kernel"), "linear"),
    "fc_partial_condition.0.weight": (("fc_partial_0", "kernel"), "linear"),
    "fc_partial_condition.2.weight": (("fc_partial_1", "kernel"), "linear"),
    "fc_arrange_condition.0.weight": (("fc_arrange_0", "kernel"), "linear"),
    "fc_arrange_condition.2.weight": (("fc_arrange_1", "kernel"), "linear"),
    "fc_text_f.weight": (("fc_text_f", "kernel"), "linear"),
    "fc_text_f.bias": (("fc_text_f", "bias"), "vec"),
    "fc_room_f.weight": (("fc_room_f", "kernel"), "linear"),
    "fc_room_f.bias": (("fc_room_f", "bias"), "vec"),
}

_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}


def _extractor_key(key: str) -> Tuple[str, Path, str]:
    """A port feature-extractor state_dict key -> (flax collection, path,
    kind): the module names of ``models/feature_extractors.py`` against
    the JAX modules' (``layer1.0.downsample.1`` <-> ``layer1_0/downsample_bn``,
    ``fc.2`` <-> ``fc_2``, AlexNet's ``features.6`` <-> ``conv3``)."""
    parts = key.split(".")
    leaf = parts[-1]
    if parts[0] == "features":                                  # AlexNet
        name = f"conv{(0, 3, 6, 8, 10).index(int(parts[1])) + 1}"
        return "params", (name, "kernel" if leaf == "weight" else "bias"), \
            "conv2d" if leaf == "weight" else "vec"
    if parts[0] == "fc":                   # ResNet18's fc.0 / fc.2, AlexNet's fc
        name = "fc" if len(parts) == 2 else f"fc_{parts[1]}"
        return "params", (name, "kernel" if leaf == "weight" else "bias"), \
            "linear" if leaf == "weight" else "vec"
    if parts[0].startswith("layer"):                            # layerL.b.<module>
        block, rest = f"{parts[0]}_{parts[1]}", parts[2:-1]
        if rest[0] == "downsample":
            rest = ["downsample_conv" if rest[1] == "0" else "downsample_bn"]
        path = (block, *rest)
    else:
        path = tuple(parts[:-1])
    if path[-1].startswith(("conv", "downsample_conv")):
        return "params", (*path, "kernel"), "conv2d"
    collection, name = _BN_LEAVES[leaf]
    return collection, (*path, name), "vec"


def _conv2d_to_torch(a):
    return np.transpose(a, (3, 2, 0, 1))


def load_jax_extractor(extractor: torch.nn.Module, variables: Dict[str, Any]) -> None:
    """JAX feature-extractor variables (``{"params": ..., "batch_stats":
    ...}``, numpy leaves; AlexNet has no statistics) into a port
    ``ResNet18`` or ``AlexNet``."""
    sd = {}
    for key in extractor.state_dict():
        collection, path, kind = _extractor_key(key)
        a = np.asarray(_get(variables[collection], path), np.float32)
        a = _conv2d_to_torch(a) if kind == "conv2d" else _to_torch_layout(a, kind)
        sd[key] = torch.from_numpy(np.ascontiguousarray(a))
    extractor.load_state_dict(sd, strict=True)


def load_jax_params(scene, np_params: Dict[str, Any]) -> None:
    """Load a JAX ``SceneNetworks`` variable tree (numpy leaves:
    ``params.denoiser`` and ``params.conditioner``, the learnable
    ``positional_embedding`` or the one-hot heads ``fc_instance_0/1``, the
    partial and arrange heads ``fc_partial_0/1``, ``fc_arrange_0/1``, and
    the text projection ``fc_text_f``, the room projection ``fc_room_f``;
    and a room-mask model's ``params.feature_extractor`` with its
    ``batch_stats.feature_extractor``) into a port ``SceneDiffusion``, so
    both packages compute the same thing."""
    p = np_params["params"]
    scene.denoiser.load_state_dict(flax_to_torch_denoiser(p["denoiser"]), strict=True)
    cond = p.get("conditioner", {})
    sd = {}
    for key, (path, kind) in _CONDITIONER.items():
        if path[0] in cond:
            a = np.asarray(_get(cond, path), np.float32)
            sd[key] = torch.from_numpy(np.ascontiguousarray(_to_torch_layout(a, kind)))
    scene.conditioner.load_state_dict(sd, strict=True)
    if scene.feature_extractor is not None:
        load_jax_extractor(scene.feature_extractor, {
            c: np_params[c]["feature_extractor"] for c in ("params", "batch_stats")
            if "feature_extractor" in np_params.get(c, {})})


def scene_tree(scene, values: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, Any]:
    """A port ``SceneDiffusion``'s parameters as the JAX ``SceneNetworks``
    params tree ({"denoiser": ..., "conditioner": ...}, with a room-mask
    model's {"feature_extractor": ...}; Flax layouts).  ``values`` (keyed
    by ``scene.networks`` state_dict names, e.g. ``{n: p.grad for n, p in
    scene.networks.named_parameters()}``) replaces the parameters, so
    gradients can be held against ``jax.grad``'s.  The extractor's frozen
    statistics are not parameters: :func:`scene_batch_stats` gives them."""
    if values is None:
        values = scene.networks.state_dict()
    den = {k[len("denoiser."):]: v for k, v in values.items() if k.startswith("denoiser.")}
    tree = {"denoiser": denoiser_tree(scene.denoiser, den), "conditioner": {}}
    for k, v in values.items():
        if k.startswith("conditioner."):
            path, kind = _CONDITIONER[k[len("conditioner."):]]
            _set(tree["conditioner"], path, _to_flax_layout(v.detach(), kind))
        elif k.startswith("feature_extractor."):
            collection, path, kind = _extractor_key(k[len("feature_extractor."):])
            if collection == "params":
                a = v.detach().permute(2, 3, 1, 0) if kind == "conv2d" else \
                    _to_flax_layout(v.detach(), kind)
                _set(tree.setdefault("feature_extractor", {}), path, a)
    return tree


def scene_batch_stats(scene) -> Dict[str, Any]:
    """A port room-mask model's frozen BatchNorm statistics as the JAX
    ``batch_stats`` collection ({"feature_extractor": {...: {"mean",
    "var"}}}); empty without an extractor."""
    tree: Dict[str, Any] = {}
    if scene.feature_extractor is not None:
        for k, v in scene.feature_extractor.state_dict().items():
            collection, path, _ = _extractor_key(k)
            if collection == "batch_stats":
                _set(tree.setdefault("feature_extractor", {}), path, v.detach())
    return tree


def _autoencoder_layers():
    """(flax path, torch prefix, kind) of every layer of ``KLAutoEncoder``;
    kind is conv, linear or bn.  The same table as ``convert_autoencoder``
    of the JAX package, read the other way."""
    layers = []
    for i in range(1, 5):
        layers.append((("encoder", f"conv{i}"), f"encoder.conv{i}", "conv"))
        layers.append((("encoder", f"bn{i}"), f"encoder.bn{i}", "bn"))
    for g in (1, 2):
        layers.append((("encoder", f"graph_layer{g}", "conv"), f"encoder.graph_layer{g}.conv", "conv"))
        layers.append((("encoder", f"graph_layer{g}", "bn"), f"encoder.graph_layer{g}.bn", "bn"))
    for name in ("mean_fc", "logvar_fc", "fc"):
        layers.append(((name,), name, "linear"))
    for f in (1, 2):
        # Sequential indices: 0 conv, 1 bn, 3 conv, 4 bn, 6 out conv
        for flax_name, idx, kind in (("conv0", 0, "conv"), ("bn0", 1, "bn"), ("conv1", 3, "conv"),
                                     ("bn1", 4, "bn"), ("out", 6, "conv")):
            layers.append((("decoder", f"fold{f}", flax_name), f"decoder.fold{f}.layers.{idx}", kind))
    return layers


def _get(tree: Dict[str, Any], path: Path):
    for p in path:
        tree = tree[p]
    return tree


def flax_to_torch_autoencoder(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``KLAutoEncoder`` or ``AutoEncoder`` variables (``params`` and
    ``batch_stats``, numpy leaves) -> the port module's state_dict (CPU
    float32 tensors; ``num_batches_tracked`` 0); the plain ``AutoEncoder``
    has no ``mean_fc``, ``logvar_fc`` or ``fc``.  ``convert_autoencoder``
    of a KL result gives the variables back, bit for bit."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, torch.Tensor] = {}

    def put(key, a):
        out[key] = torch.from_numpy(np.array(a, np.float32, order="C"))

    for path, prefix, kind in _autoencoder_layers():
        if path[0] not in params:           # the plain AutoEncoder's missing heads
            continue
        p = _get(params, path)
        if kind == "bn":
            s = _get(stats, path)
            put(f"{prefix}.weight", p["scale"])
            put(f"{prefix}.bias", p["bias"])
            put(f"{prefix}.running_mean", s["mean"])
            put(f"{prefix}.running_var", s["var"])
            out[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
        else:
            k = np.asarray(p["kernel"]).T
            put(f"{prefix}.weight", k[:, :, None] if kind == "conv" else k)
            put(f"{prefix}.bias", p["bias"])
    return out


def load_jax_autoencoder(model: torch.nn.Module, variables: Dict[str, Any]) -> None:
    """Load JAX ``KLAutoEncoder`` (or ``AutoEncoder``) variables (numpy
    leaves) into the port's module of that name; num_batches_tracked is
    kept as the module has it."""
    sd = flax_to_torch_autoencoder(variables)
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
    model.load_state_dict(sd, strict=True)


# FrozenBatchNorm2d.freeze bakes the BatchNorm eps into running_var and the
# reference's frozen forward adds none; the port's forward adds 1e-5
_FBN_EPS = 1e-5


def reference_to_extractor_state_dict(state_dict: Mapping[str, Any],
                                      frozen_source: bool = True) -> Dict[str, Any]:
    """A reference room-mask extractor wrapper's state_dict
    (feature_extractors.py:19-68: ResNet18's ``_feature_extractor.*``,
    AlexNet's ``_feature_extractor.features.*`` and ``_fc.*``; keys may carry
    a scene checkpoint's ``feature_extractor.`` prefix) -> the port
    extractor's keys.  With ``frozen_source`` each ``running_var`` has the
    eps its freeze baked in taken out (minus 1e-5 in f64, clamped at 0, as
    the JAX package's ``convert_feature_extractor`` does; float64 values
    stay float64, others come out float32), so the port's forward, which
    adds 1e-5, computes the reference's affine.  ``num_batches_tracked``
    and torchvision's unused AlexNet ``classifier`` are dropped."""
    out = {}
    for key, val in state_dict.items():
        sub = key[len("feature_extractor."):] if key.startswith("feature_extractor.") else key
        sub = sub[len("_feature_extractor."):] if sub.startswith("_feature_extractor.") \
            else sub.replace("_fc.", "fc.", 1)
        if sub.endswith("num_batches_tracked") or sub.startswith("classifier."):
            continue
        if frozen_source and sub.endswith("running_var"):
            src = torch.as_tensor(val).cpu().numpy()
            var = np.asarray(src, np.float64) - _FBN_EPS
            dtype = np.float64 if src.dtype == np.float64 else np.float32
            val = torch.from_numpy(np.maximum(var, 0.0).astype(dtype))
        out[sub] = val
    return out


def reference_to_scene_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference DiffusionSceneLayout_DDPM state_dict -> ``scene.networks``
    keys: ``diffusion.model.*`` -> ``denoiser.*`` (the port's Unet1D carries
    the reference names), the instance, partial and arrange heads and the
    text and room projections ``fc_text_f``, ``fc_room_f`` ->
    ``conditioner.*``, and the room-mask extractor's
    ``feature_extractor._feature_extractor.*`` (ResNet18; AlexNet's
    ``features.*``) and ``feature_extractor._fc.*`` (AlexNet) ->
    ``feature_extractor.*`` through :func:`reference_to_extractor_state_dict`
    (the frozen eps taken out of each ``running_var``).  Other keys (frozen
    text encoders) raise: those are not ported."""
    out = {}
    extractor = {}
    for key, val in state_dict.items():
        if key.startswith("diffusion.model."):
            out["denoiser." + key[len("diffusion.model."):]] = val
        elif key in _CONDITIONER:
            out["conditioner." + key] = val
        elif key.startswith("feature_extractor."):
            extractor[key] = val
        else:
            raise KeyError(f"unmapped scene-model key: {key}")
    for key, val in reference_to_extractor_state_dict(extractor).items():
        out["feature_extractor." + key] = val
    return out
