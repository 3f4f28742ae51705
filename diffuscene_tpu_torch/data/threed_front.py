"""Cached 3D-FRONT dataset reader (on-disk compatible with the reference).

Copy of ``diffuscene_tpu/data/threed_front.py``, so the port does not import
the JAX package; the room mask's resize is Pillow's BILINEAR without
Pillow (``utils/image.py``).

Reads the preprocessed per-room directories produced by `preprocess_data.py`
(reference `scripts/preprocess_data.py:257-294`): each room dir holds
``boxes.npz`` (class_labels / translations / sizes / angles / objfeats[_32] /
room_layout / floor plan) and the base dir holds ``dataset_stats.txt`` with
bounds and class metadata (reference `threed_front.py:274-440`).  Keeping the
format identical means preprocessed reference datasets are directly reusable.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils.image import pillow_bilinear_resize
from .encoding import Bounds

MAX_LENGTH_BY_ROOM = {"bed": 12, "living": 21, "dining": 21, "library": 11}


class CachedThreedFront:
    """Cached scene dataset: one preprocessed directory per room.

    Mirrors reference CachedThreedFront (threed_front.py:274-440), minus the
    torch Dataset machinery — samples are plain numpy dicts.
    """

    def __init__(self, base_dir: str, config: Dict, scene_ids: Sequence[str]):
        self._base_dir = base_dir
        self.config = config
        # in-memory memoization of decompressed boxes.npz samples — the
        # cached datasets are small (tens of MB) while per-epoch npz
        # re-reads dominate the host loop (measured ~1 s/step at batch 128)
        self._cache_in_memory = bool(config.get("cache_in_memory", True))
        self._sample_cache: Dict[int, Dict[str, np.ndarray]] = {}
        self._parse_train_stats(config.get("train_stats", "dataset_stats.txt"))

        scene_ids = set(scene_ids)
        self._tags = sorted(
            d for d in os.listdir(base_dir)
            if os.path.isdir(os.path.join(base_dir, d))
            and (d.split("_")[1] if "_" in d else d) in scene_ids
        )
        self._path_to_rooms = [os.path.join(base_dir, t, "boxes.npz") for t in self._tags]

        render_name = None
        if self._tags:
            for cand in (
                "rendered_scene_256.png",
                "rendered_scene_256_no_lamps.png",
                "rendered_scene_notexture_256.png",
            ):
                if os.path.isfile(os.path.join(base_dir, self._tags[0], cand)):
                    render_name = cand
                    break
        self._path_to_renders = (
            [os.path.join(base_dir, t, render_name) for t in self._tags]
            if render_name
            else [None] * len(self._tags)
        )

    # ------------------------------------------------------------------
    def _parse_train_stats(self, train_stats: str):
        with open(os.path.join(self._base_dir, train_stats), "r") as f:
            stats = json.load(f)
        self.train_stats = stats
        self.bounds = Bounds.from_train_stats(stats)
        self._class_labels = stats["class_labels"]
        self._object_types = stats["object_types"]
        self._class_frequencies = stats["class_frequencies"]
        self._class_order = stats.get("class_order", {})
        self._count_furniture = stats.get("count_furniture", {})
        self._max_length = self.config.get("max_length", 12)

    @property
    def class_labels(self) -> List[str]:
        return self._class_labels

    @property
    def object_types(self) -> List[str]:
        return self._object_types

    @property
    def class_frequencies(self) -> Dict[str, float]:
        return self._class_frequencies

    @property
    def n_classes(self) -> int:
        return len(self._class_labels)

    @property
    def max_length(self) -> int:
        return self._max_length

    def __len__(self):
        return len(self._path_to_rooms)

    # ------------------------------------------------------------------
    def _room_layout(self, room_layout: np.ndarray) -> np.ndarray:
        """Resize the (H, W, 1) 8-bit mask to ``room_layout_size`` as the
        JAX package does, Pillow's BILINEAR then / 255
        (threed_front.py:311-319), through ``utils/image.py`` (the same
        computation with or without Pillow): within one level of Pillow's
        result."""
        size = tuple(int(x) for x in self.config.get("room_layout_size", "64,64").split(","))
        img = torch.from_numpy(np.ascontiguousarray(room_layout[:, :, 0]))
        return pillow_bilinear_resize(img, size).numpy() / np.float32(255)

    def get_room_params(self, i: int) -> Dict[str, np.ndarray]:
        """(threed_front.py:349-373)"""
        if self._cache_in_memory and i in self._sample_cache:
            return dict(self._sample_cache[i])
        D = np.load(self._path_to_rooms[i])
        room = self._room_layout(D["room_layout"])
        room = np.transpose(room[:, :, None], (2, 0, 1))
        out = {
            "room_layout": room,
            "class_labels": np.asarray(D["class_labels"], np.float32),
            "translations": np.asarray(D["translations"], np.float32),
            "sizes": np.asarray(D["sizes"], np.float32),
            "angles": np.asarray(D["angles"], np.float32),
        }
        for k in ("objfeats", "objfeats_32"):
            if k in D:
                out[k] = np.asarray(D[k], np.float32)
        if self._cache_in_memory:
            self._sample_cache[i] = out
            return dict(out)
        return out

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return self.get_room_params(i)

    def get_floor_plan(self, i: int) -> Dict[str, np.ndarray]:
        """Floor-plan arrays of room ``i`` (vertices/faces/centroid), as
        stored by preprocess_data — the reference reads the same keys for
        floor_plan_from_scene (scripts/utils.py:65-120)."""
        D = np.load(self._path_to_rooms[i])
        return {
            "floor_plan_vertices": np.asarray(D["floor_plan_vertices"], np.float64),
            "floor_plan_faces": np.asarray(D["floor_plan_faces"], np.int64),
            "floor_plan_centroid": np.asarray(D["floor_plan_centroid"], np.float64),
        }

    @property
    def scene_ids(self) -> List[str]:
        return [t.split("_")[1] if "_" in t else t for t in self._tags]

    @property
    def render_paths(self) -> List[Optional[str]]:
        return self._path_to_renders
