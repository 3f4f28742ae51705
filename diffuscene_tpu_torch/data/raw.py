"""The 3D-FUTURE furniture records that a pickled catalog holds, point-cloud
part only.

Copy of the parts of ``diffuscene_tpu/data/raw.py`` (reference
``scene_synthesis/datasets/threed_front_scene.py:21-345``) that the shape
autoencoder's CLIs read from a catalog pickled by the JAX package:
``Asset``, ``BaseThreedFutureModel`` and ``ThreedFutureModel`` with their
attributes, label, paths and the cached per-model point cloud and latents.
Mesh parsing and transforms, bounding boxes and sizes, and the scene walkers
are not copied yet (``cli/pickle_threed_future_pointcloud.py`` stays
queued, ROADMAP A7).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class Asset:
    """3D-FUTURE model metadata.  (threed_front_scene.py:33-44)"""

    super_category: str
    category: str
    style: str
    theme: str
    material: str

    @property
    def label(self):
        return self.category


class BaseThreedFutureModel:
    """(threed_front_scene.py:134-184)"""

    def __init__(self, model_uid, model_jid, position, rotation, scale):
        self.model_uid = model_uid
        self.model_jid = model_jid
        self.position = position
        self.rotation = rotation
        self.scale = scale


class ThreedFutureModel(BaseThreedFutureModel):
    """One furniture instance (threed_front_scene.py:187-345), point-cloud
    part."""

    def __init__(self, model_uid, model_jid, model_info, position, rotation,
                 scale, path_to_models):
        super().__init__(model_uid, model_jid, position, rotation, scale)
        self.model_info = model_info
        self.path_to_models = path_to_models
        self._label: Optional[str] = None
        self._size: Optional[np.ndarray] = None

    @property
    def raw_model_norm_pc_path(self):
        return os.path.join(self.path_to_models, self.model_jid, "raw_model_norm_pc.npz")

    @property
    def raw_model_norm_pc_lat_path(self):
        return os.path.join(self.path_to_models, self.model_jid, "raw_model_norm_pc_lat.npz")

    @property
    def raw_model_norm_pc_lat32_path(self):
        return os.path.join(self.path_to_models, self.model_jid, "raw_model_norm_pc_lat32.npz")

    def raw_model_norm_pc(self):
        return np.load(self.raw_model_norm_pc_path)["points"].astype(np.float32)

    def raw_model_norm_pc_lat(self):
        return np.load(self.raw_model_norm_pc_lat_path)["latent"].astype(np.float32)

    def raw_model_norm_pc_lat32(self):
        return np.load(self.raw_model_norm_pc_lat32_path)["latent"].astype(np.float32)

    @property
    def label(self):
        if self._label is None:
            self._label = self.model_info.label
        return self._label

    @label.setter
    def label(self, value):
        self._label = value
