"""Network factory: config dict -> model.

Port of ``diffuscene_tpu/models/factory.py`` (reference ``build_network``,
``scene_synthesis/networks/__init__.py:37-68``), dispatching on
``network.type``.  The optimizer and schedule factories live in
``train/optim.py``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .autoencoder import KLAutoEncoder
from .scene_model import SceneDiffusion, SceneModelConfig

AUTOENCODER_TYPES = ("objautoencoder", "autoencoder", "kl_autoencoder")


def build_network(n_classes: int, config: Dict[str, Any], weight_file: Optional[str] = None,
                  bounds: Optional[Dict[str, np.ndarray]] = None,
                  device: torch.device | str = "cuda"
                  ) -> Tuple[torch.nn.Module, Optional[Dict[str, torch.Tensor]]]:
    """The model ``config['network']['type']`` names, on the card unless
    ``device`` says otherwise:

    - "diffusion_scene_layout_ddpm" -> :class:`SceneDiffusion` (its
      extractor from the config's ``feature_extractor`` section); a
      reference ``.pt``/``.pth`` ``weight_file`` is converted by
      ``utils/convert.py:reference_to_scene_state_dict`` and loaded;
    - "objautoencoder", "autoencoder" or "kl_autoencoder" ->
      :class:`KLAutoEncoder` (``objfeat_dim``, ``kl_weight``), as the JAX
      package maps all three.

    Returns (model, the loaded ``scene.networks`` state_dict or None).
    ``n_classes`` is unused, as in the JAX package (the config carries the
    class width).  Another type raises."""
    del n_classes
    network = config["network"]
    net_type = network.get("type", "diffusion_scene_layout_ddpm")

    if net_type == "diffusion_scene_layout_ddpm":
        cfg = SceneModelConfig.from_config(network, config.get("feature_extractor"))
        model = SceneDiffusion(cfg, bounds=bounds, device=device)
        state = None
        if weight_file and weight_file.endswith((".pt", ".pth")):
            from ..utils.checkpoint import load_model_weights
            from ..utils.convert import reference_to_scene_state_dict

            state = reference_to_scene_state_dict(load_model_weights(weight_file))
            model.networks.load_state_dict(state)
        return model, state

    if net_type in AUTOENCODER_TYPES:
        model = KLAutoEncoder(latent_dim=int(network.get("objfeat_dim", 64)),
                              kl_weight=float(network.get("kl_weight", 0.001)), device=device)
        return model, None

    raise NotImplementedError(f"unknown network type: {net_type}")
