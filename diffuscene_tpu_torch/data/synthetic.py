"""Synthetic cached-dataset fixture generator.

Copy of ``diffuscene_tpu/data/synthetic.py`` (numpy only), so the port does not
import the JAX package.

Writes a directory tree byte-compatible with the reference preprocessing
output (boxes.npz per room + dataset_stats.txt, see
`scripts/preprocess_data.py:180-294`), populated with plausible random
bedrooms, so that the full train/sample/eval pipeline can run without the
(licensed, non-redistributable) 3D-FRONT download.  ``make_synthetic_catalog``
writes a furniture catalog of textured boxes for mesh retrieval, and
``make_synthetic_raw_front`` a raw 3D-FRONT / 3D-FUTURE tree for the
pickle and preprocessing CLIs; the port's own fixture writers, which the
tests feed to both packages.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

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


def _floor_mesh(rng: np.random.Generator, centre: np.ndarray):
    """A floor of at most 6 x 6 m around ``centre`` (x, z): a rectangle or
    an L (the rectangle less one corner), as flat 3D-FRONT ``xyz`` and
    ``faces`` lists, and the rectangle's (x0, z0, x1, z1)."""
    w, d = rng.uniform(3.0, 5.8, 2)
    x0, z0 = centre[0] - w / 2, centre[1] - d / 2
    x1, z1 = x0 + w, z0 + d
    if rng.random() < 0.5:
        rects = [(x0, z0, x1, z1)]
    else:   # an L: a full-depth strip and the part of the rest away from the cut
        xm = x0 + w * rng.uniform(0.5, 0.7)
        zm = z0 + d * rng.uniform(0.3, 0.5)
        rects = [(x0, z0, xm, z1), (xm, zm, x1, z1)]
    xyz, faces = [], []
    for a0, b0, a1, b1 in rects:
        base = len(xyz) // 3
        xyz += [a0, 0.0, b0, a1, 0.0, b0, a1, 0.0, b1, a0, 0.0, b1]
        faces += [base, base + 1, base + 2, base, base + 2, base + 3]
    return [float(v) for v in xyz], faces, (x0, z0, x1, z1)


def make_synthetic_raw_front(out_dir: str, n_rooms: int = 8, seed: int = 0,
                             max_objects: int = 12, models_per_category: int = 2,
                             rooms_per_file: int = 4) -> Dict[str, str]:
    """A small raw 3D-FRONT / 3D-FUTURE tree, the input of the pickle and
    preprocessing CLIs, made from ``seed``:

    - ``3D-FUTURE-model/``: ``models_per_category`` textured boxes (OBJ,
      MTL, texture) for each 3D-FUTURE category of the bedroom furniture
      map, and ``model_info.json``;
    - ``3D-FRONT/*.json``: ``n_rooms`` bedrooms, ``rooms_per_file`` a
      scene file, each with a floor mesh (a rectangle or an L shape, at
      most 6 x 6 m, off the origin) and 3 to ``max_objects`` pieces of
      furniture standing on it, a bed first, the others walking every
      category in a seeded order (so the train rooms hold every bedroom
      class once they hold 30 pieces besides their beds); plus one room
      with a furniture scale out of range, which the parsers drop;
    - ``splits.csv``: the rooms 80/10/10 in train, val and test.

    Returns the paths: ``root``, ``front``, ``future``, ``model_info``,
    ``splits``."""
    from .filters import load_furniture_map

    rng = np.random.default_rng(seed)
    front = os.path.join(out_dir, "3D-FRONT")
    future = os.path.join(out_dir, "3D-FUTURE-model")
    os.makedirs(front, exist_ok=True)
    os.makedirs(future, exist_ok=True)

    categories = sorted(load_furniture_map("bedroom"))
    beds = [c for c in categories if c.endswith(" bed")]
    models: Dict[str, List[tuple]] = {}       # category -> [(jid, half extents)]
    model_info = []
    for ci, cat in enumerate(categories):
        colour = rng.integers(64, 256, 3)
        for k in range(models_per_category):
            jid = f"{ci:04x}{k:04x}-0000-4000-8000-{seed:012x}"
            half = rng.uniform([0.15, 0.1, 0.15], [1.0, 1.0, 1.1])
            os.makedirs(os.path.join(future, jid), exist_ok=True)
            _write_box_obj(os.path.join(future, jid), half, colour)
            models.setdefault(cat, []).append((jid, half))
            model_info.append({"model_id": jid, "super-category": "Furniture",
                               "category": cat, "style": "Modern", "theme": None,
                               "material": "Wood"})
    with open(os.path.join(future, "model_info.json"), "w") as f:
        json.dump(model_info, f)

    def child(ref, pos, angle=0.0, scale=(1.0, 1.0, 1.0)):
        rot = [0.0, float(np.sin(angle / 2)), 0.0, float(np.cos(angle / 2))]
        return {"ref": ref, "pos": [float(p) for p in pos], "rot": rot,
                "scale": [float(s) for s in scale]}

    # the furniture after each room's bed walks every category in a seeded
    # order, so the first rooms (the train split) hold every class
    order, n_drawn = rng.permutation(len(categories)), 0
    splits = []
    n_files = -(-n_rooms // rooms_per_file)
    for fi in range(n_files):
        name = f"{fi:08x}-{seed:04x}-4000-8000-000000000000"
        furniture, meshes, rooms = {}, [], []
        room_ids = range(fi * rooms_per_file, min((fi + 1) * rooms_per_file, n_rooms))
        for r in (*room_ids, *((-1,) if fi == 0 else ())):
            centre = rng.uniform(-4.0, 4.0, 2)
            xyz, faces, (x0, z0, x1, z1) = _floor_mesh(rng, centre)
            floor_uid = f"{name}/floor{len(meshes)}"
            meshes.append({"uid": floor_uid, "jid": "", "type": "Floor", "xyz": xyz,
                           "faces": faces})
            n_obj = int(rng.integers(3, max_objects + 1))
            cats = [beds[int(rng.integers(len(beds)))]]
            for _ in range(n_obj - 1):
                cats.append(categories[order[n_drawn % len(order)]])
                n_drawn += 1
            children = [child(floor_uid, (0.0, 0.0, 0.0))]
            for k, cat in enumerate(cats):
                jid, half = models[cat][int(rng.integers(models_per_category))]
                uid = f"{name}/{jid}"
                furniture[uid] = {"uid": uid, "jid": jid, "valid": True}
                pos = (rng.uniform(x0, x1), half[1], rng.uniform(z0, z1))
                angle = float(rng.choice([0.0, 0.5, 1.0, -0.5])) * np.pi
                # the out-of-range room: its first piece scaled 9x
                scale = (9.0, 9.0, 9.0) if r < 0 and k == 0 else (1.0, 1.0, 1.0)
                children.append(child(uid, pos, angle, scale))
            room_id = f"Bedroom-{r:04d}" if r >= 0 else f"Bedroom-bad{fi}"
            rooms.append({"instanceid": room_id, "type": "Bedroom", "children": children})
            split = ("train" if r < 0 or r < int(0.8 * n_rooms)
                     else "val" if r < int(0.9 * n_rooms) else "test")
            splits.append(f"{room_id},{split}")
        scene = {"furniture": list(furniture.values()), "mesh": meshes,
                 "scene": {"room": rooms}}
        with open(os.path.join(front, name + ".json"), "w") as f:
            json.dump(scene, f)
    path_splits = os.path.join(out_dir, "splits.csv")
    with open(path_splits, "w") as f:
        f.write("\n".join(splits) + "\n")
    return {"root": out_dir, "front": front, "future": future,
            "model_info": os.path.join(future, "model_info.json"), "splits": path_splits}
