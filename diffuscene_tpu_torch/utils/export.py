"""The port's weights -> the reference's state_dict layout (the inverse of the
reference loaders in ``utils/convert.py``).

Port of ``diffuscene_tpu/utils/export.py``: a scene model, a denoiser, a
shape autoencoder or a room-mask extractor trained by the port flows back
into the reference implementation's ``DiffusionSceneLayout_DDPM``
(``scene_synthesis/networks/diffusion_scene_layout_ddpm.py:14-129``),
``Unet1D``, ``KLAutoEncoder`` or feature-extractor wrapper
(``feature_extractors.py:19-68``), through ``model.load_state_dict``.

The inverse is derived from the forward loader, as the JAX package derives
it, so the two cannot drift:

1. the caller gives a *template*, the reference model's ``state_dict()``,
   which fixes the keys and shapes;
2. each template tensor is replaced by a constant tag (its index + 1) and
   run through the forward loader once, which tells each port key the
   template key it came from; a second run with every tensor 1.0 reads off
   the additive shift the forward applies (the frozen BatchNorm eps it takes
   out of ``running_var``).  Both runs are float64, so the shift is read
   exactly and baked back in float64;
3. the port's modules carry the reference names and layouts, so every
   tensor goes back as it is (a shape mismatch raises).

Template keys the forward loader skips (the frozen ``bertmodel.*`` /
``clip_model.*`` text encoders, BatchNorm ``num_batches_tracked``,
torchvision's unused AlexNet ``classifier``) pass through from the template
unchanged.  Every function returns CPU tensors.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from .convert import reference_to_extractor_state_dict, reference_to_scene_state_dict

# template keys of frozen text encoders: the forward loader does not map them
_TEXT_ENCODERS = ("bertmodel.", "clip_model.")


def _as_tensor(v) -> torch.Tensor:
    return v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


def _export(values: Mapping[str, Any], template: Mapping[str, Any],
            forward: Callable[[Dict[str, torch.Tensor]], Mapping[str, Any]]
            ) -> Dict[str, torch.Tensor]:
    keys = list(template)
    shapes = {k: tuple(_as_tensor(template[k]).shape) for k in keys}
    mapped = [k for k in keys if not k.startswith(_TEXT_ENCODERS)]
    # tag i + 1 for key i (0 would be ambiguous with the eps clamp at 0)
    tags = forward({k: torch.full(shapes[k], float(i + 1), dtype=torch.float64)
                    for i, k in enumerate(keys) if k in mapped})
    ones = forward({k: torch.ones(shapes[k], dtype=torch.float64) for k in mapped})
    source: Dict[str, tuple] = {}           # template key -> (port key, shift)
    for port_key, leaf in tags.items():
        leaf = _as_tensor(leaf).double()
        v = float(leaf.reshape(-1)[0])
        if leaf.numel() and bool((leaf != v).any()):
            raise AssertionError(f"{port_key} mixes template keys")
        key = keys[int(round(v)) - 1]
        if key in source:
            raise AssertionError(f"template key {key!r} maps to two port keys")
        source[key] = (port_key, float(_as_tensor(ones[port_key]).double().reshape(-1)[0]) - 1.0)

    out: Dict[str, torch.Tensor] = {}
    for k in keys:
        if k not in source:
            out[k] = _as_tensor(template[k]).cpu()
            continue
        port_key, shift = source[k]
        if port_key not in values:
            raise KeyError(f"the weights lack {port_key!r} (for {k!r})")
        t = _as_tensor(values[port_key]).cpu()
        if tuple(t.shape) != shapes[k]:
            raise ValueError(f"{port_key}: shape {tuple(t.shape)}, the template's {k!r} "
                             f"is {shapes[k]}")
        if shift:
            # forward: port = reference + shift  =>  reference = port - shift, in f64
            t = (t.double() - shift).to(t.dtype)
        out[k] = t.clone()
    return out


def export_scene_model(state_dict: Mapping[str, Any],
                       template: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A port ``scene.networks`` state_dict -> the reference
    DiffusionSceneLayout_DDPM state_dict of ``template``: the inverse of
    :func:`~.convert.reference_to_scene_state_dict`, the frozen eps baked
    back into a room-mask extractor's ``running_var``, frozen BERT/CLIP
    weights copied from the template."""
    return _export(state_dict, template, reference_to_scene_state_dict)


def export_denoiser(state_dict: Mapping[str, Any],
                    template: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A port ``Unet1D`` state_dict -> the reference ``Unet1D`` state_dict of
    ``template`` (keys without the ``diffusion.model.`` prefix)."""
    return _export(state_dict, template, lambda sd: dict(sd))


def export_autoencoder(state_dict: Mapping[str, Any],
                       template: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A port ``KLAutoEncoder`` state_dict -> the reference KLAutoEncoder
    state_dict of ``template``; its ``num_batches_tracked`` counters pass
    through from the template."""
    return _export(state_dict, template, lambda sd: {
        k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")})


def export_feature_extractor(state_dict: Mapping[str, Any], template: Mapping[str, Any],
                             frozen_target: bool = True) -> Dict[str, torch.Tensor]:
    """A port room-mask extractor state_dict (``ResNet18`` or ``AlexNet``)
    -> the reference wrapper state_dict of ``template``.  ``frozen_target``
    bakes the frozen eps back into ``running_var`` (the layout of the
    reference's checkpoints, frozen_batchnorm.py:30)."""
    return _export(state_dict, template,
                   lambda sd: reference_to_extractor_state_dict(sd, frozen_target))
