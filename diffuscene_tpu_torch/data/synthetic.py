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


def _write_box_obj(model_dir: str, half: np.ndarray, colour: np.ndarray) -> None:
    """A textured box: raw_model.obj (6 quads with UVs), model.mtl and a
    16x16 checker texture.png in ``colour``."""
    from ..eval.png import write_png

    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
                       np.float64) * half
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    lines = ["mtllib model.mtl"]
    lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in corners]
    lines += ["vt 0 0", "vt 1 0", "vt 1 1", "vt 0 1", "usemtl box"]
    lines += ["f " + " ".join(f"{v + 1}/{k + 1}" for k, v in enumerate(q)) for q in quads]
    with open(os.path.join(model_dir, "raw_model.obj"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(model_dir, "model.mtl"), "w") as f:
        f.write("newmtl box\nKd 1 1 1\nmap_Kd texture.png\n")
    checker = (np.indices((16, 16)).sum(0) // 4) % 2
    tex = np.where(checker[..., None] == 1, colour, colour // 2).astype(np.uint8)
    write_png(os.path.join(model_dir, "texture.png"), tex)


def make_synthetic_catalog(out_dir: str, labels: List[str], per_label: int = 2,
                           seed: int = 0) -> str:
    """A 3D-FUTURE-style furniture catalog for mesh retrieval: for each label,
    ``per_label`` textured boxes of random half-extents (``<jid>/raw_model.obj``,
    ``model.mtl``, ``texture.png``, a 32-d ``raw_model_norm_pc_lat32.npz``),
    their sizes computed and kept, pickled as a ``ThreedFutureDataset`` at
    ``out_dir/threed_future_model.pkl``; returns the pickle's path."""
    from .raw import Asset, ThreedFutureModel
    from .threed_future import ThreedFutureDataset

    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    objects = []
    for li, label in enumerate(labels):
        colour = rng.integers(64, 256, 3)
        for k in range(per_label):
            jid = f"synth-{li:03d}-{k:02d}"
            model_dir = os.path.join(out_dir, jid)
            os.makedirs(model_dir, exist_ok=True)
            _write_box_obj(model_dir, rng.uniform(0.1, 1.0, 3), colour)
            np.savez(os.path.join(model_dir, "raw_model_norm_pc_lat32.npz"),
                     latent=rng.normal(0, 1, 32).astype(np.float32))
            model = ThreedFutureModel(
                model_uid=f"{jid}-uid", model_jid=jid,
                model_info=Asset(label, label, None, None, None),
                position=np.zeros(3), rotation=np.array([0.0, 0.0, 0.0, 1.0]),
                scale=np.ones(3), path_to_models=out_dir)
            model.size                              # computed once, kept in the pickle
            objects.append(model)
    path = os.path.join(out_dir, "threed_future_model.pkl")
    ThreedFutureDataset(objects).pickle(path)
    return path
