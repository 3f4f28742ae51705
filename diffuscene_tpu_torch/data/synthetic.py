"""Synthetic cached-dataset fixture generator.

Copy of ``diffuscene_tpu/data/synthetic.py`` (numpy only), so the port does not
import the JAX package.

Writes a directory tree byte-compatible with the reference preprocessing
output (boxes.npz per room + dataset_stats.txt, see
`scripts/preprocess_data.py:180-294`), populated with plausible random
bedrooms, so that the full train/sample/eval pipeline can run without the
(licensed, non-redistributable) 3D-FRONT download.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

BEDROOM_TYPES = [
    "armchair", "bookshelf", "cabinet", "ceiling_lamp", "chair",
    "children_cabinet", "coffee_table", "desk", "double_bed", "dressing_chair",
    "dressing_table", "kids_bed", "nightstand", "pendant_lamp", "shelf",
    "single_bed", "sofa", "stool", "table", "tv_stand", "wardrobe",
]


def make_synthetic_cached_dataset(
    out_dir: str,
    n_scenes: int = 32,
    max_objects: int = 12,
    objfeat_dim: int = 32,
    seed: int = 0,
    room_type: str = "bedroom",
    object_types: Optional[List[str]] = None,
) -> str:
    """Create a synthetic cached dataset + splits CSV; returns ``out_dir``."""
    rng = np.random.default_rng(seed)
    object_types = object_types or BEDROOM_TYPES
    class_labels = list(object_types) + ["start", "end"]
    n_classes = len(class_labels)

    os.makedirs(out_dir, exist_ok=True)

    all_trans, all_sizes, all_angles, all_feats = [], [], [], []
    counts = {t: 0 for t in object_types}
    scene_rows = []
    for i in range(n_scenes):
        n_obj = int(rng.integers(3, max_objects + 1))
        cls_idx = rng.integers(0, len(object_types), size=n_obj)
        class_onehot = np.zeros((n_obj, n_classes), np.float32)
        class_onehot[np.arange(n_obj), cls_idx] = 1.0
        for ci in cls_idx:
            counts[object_types[ci]] += 1
        translations = np.stack(
            [
                rng.uniform(-2.7, 2.7, n_obj),
                rng.uniform(0.0, 3.6, n_obj),
                rng.uniform(-2.7, 2.7, n_obj),
            ],
            axis=-1,
        ).astype(np.float32)
        sizes = rng.uniform(0.04, 1.8, (n_obj, 3)).astype(np.float32)
        angles = rng.uniform(-np.pi, np.pi, (n_obj, 1)).astype(np.float32)
        objfeats_32 = rng.normal(0, 1.0, (n_obj, objfeat_dim)).astype(np.float32)
        room_layout = (rng.random((64, 64, 1)) < 0.7).astype(np.uint8) * 255

        scene_id = f"{i:08x}-0000-0000-0000-000000000000"
        tag = f"SynthRoom_{scene_id}"
        room_dir = os.path.join(out_dir, tag)
        os.makedirs(room_dir, exist_ok=True)
        np.savez(
            os.path.join(room_dir, "boxes.npz"),
            scene_id=scene_id,
            class_labels=class_onehot,
            translations=translations,
            sizes=sizes,
            angles=angles,
            objfeats_32=objfeats_32,
            room_layout=room_layout,
            floor_plan_vertices=rng.random((8, 3)).astype(np.float32),
            floor_plan_faces=np.arange(6, dtype=np.int64).reshape(2, 3),
            floor_plan_centroid=np.zeros(3, np.float32),
        )
        all_trans.append(translations)
        all_sizes.append(sizes)
        all_angles.append(angles)
        all_feats.append(objfeats_32)
        split = "train" if i < int(n_scenes * 0.8) else ("val" if i < int(n_scenes * 0.9) else "test")
        scene_rows.append((scene_id, split))

    trans = np.concatenate(all_trans)
    sizes = np.concatenate(all_sizes)
    angles = np.concatenate(all_angles)
    feats = np.concatenate(all_feats)
    total = sum(counts.values())
    stats = {
        "bounds_translations": list(map(float, np.concatenate([trans.min(0), trans.max(0)]))),
        "bounds_sizes": list(map(float, np.concatenate([sizes.min(0), sizes.max(0)]))),
        "bounds_angles": [float(angles.min()), float(angles.max())],
        "bounds_objfeats_32": [float(feats.std()), float(feats.min()), float(feats.max())],
        "class_labels": class_labels,
        "object_types": object_types,
        "class_frequencies": {t: counts[t] / max(total, 1) for t in object_types},
        "class_order": {t: i for i, t in enumerate(object_types)},
        "count_furniture": counts,
    }
    with open(os.path.join(out_dir, "dataset_stats.txt"), "w") as f:
        json.dump(stats, f)

    with open(os.path.join(out_dir, "splits.csv"), "w") as f:
        for sid, split in scene_rows:
            f.write(f"{sid},{split}\n")
    return out_dir
