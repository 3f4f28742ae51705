"""Sample normalized surface point clouds for every 3D-FUTURE model.

Port of ``diffuscene_tpu/cli/pickle_threed_future_pointcloud.py`` (reference
``scripts/pickle_threed_fucture_pointcloud.py:21-187``), with the same
flags: per object, normalize the raw mesh to the unit cube (bbox-centered,
longest side scaled to ``1 - bbox_padding``), sample surface points and
normals (area-weighted triangle sampling in numpy, in place of
trimesh.sample), and write ``raw_model_norm_pc.npz`` (points and normals
float16, loc, scale) next to the model, a PLY copy and train/val/test lst
files.  These feed the shape AE's training.  The points are drawn from one
``np.random.default_rng(--seed)`` in the JAX CLI's order, so the same seed
gives the same clouds.  Host work only.

Two catalog modes, as in the reference:
- with ``--annotation_file``: walk the scene dataset per split through
  ``filter_function`` (reference :105-131), so the lst files reflect real
  split membership and only filtered rooms' objects are sampled;
- without: sample every model under the 3D-FUTURE directory and write
  shuffled 80/10/10 lst files.

    python -m diffuscene_tpu_torch.cli.pickle_threed_future_pointcloud OUT \
        3D-FRONT 3D-FUTURE-model 3D-FUTURE-model/model_info.json \
        --annotation_file configs/splits/bedroom_threed_front_splits.csv
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def sample_surface(vertices: np.ndarray, faces: np.ndarray, n: int,
                   rng: np.random.Generator, return_normals: bool = False):
    """Area-weighted uniform surface sampling (numpy trimesh.sample port).

    With ``return_normals`` also returns the unit face normal per sampled
    point (reference :162-163 keeps ``mesh.face_normals[face_idx]``).
    """
    tri = vertices[faces]  # (F, 3, 3)
    cross = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = 0.5 * np.linalg.norm(cross, axis=1)
    total = area.sum()
    if total <= 0:
        idx = rng.integers(0, len(vertices), n)
        pts = vertices[idx]
        if return_normals:
            return pts, np.tile(np.array([0.0, 1.0, 0.0]), (n, 1))
        return pts
    probs = area / total
    choice = rng.choice(len(faces), n, p=probs)
    u = rng.random((n, 1))
    v = rng.random((n, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    t = tri[choice]
    pts = t[:, 0] + u * (t[:, 1] - t[:, 0]) + v * (t[:, 2] - t[:, 0])
    if return_normals:
        norms = np.linalg.norm(cross, axis=1, keepdims=True)
        unit = cross / np.maximum(norms, 1e-12)
        return pts, unit[choice]
    return pts


def normalize_to_unit_cube(vertices: np.ndarray, bbox_padding: float = 0.0,
                           return_loc_scale: bool = False):
    """Center at the bbox centroid and scale the longest side to
    ``1 - bbox_padding`` (pickle_threed_fucture_pointcloud.py:150-158:
    ``scale = extent.max() / (1 - bbox_padding)``)."""
    lo, hi = vertices.min(0), vertices.max(0)
    loc = (lo + hi) / 2
    scale = (hi - lo).max() / max(1.0 - bbox_padding, 1e-12)
    out = (vertices - loc) / max(scale, 1e-12)
    if return_loc_scale:
        return out, loc, scale
    return out


def _write_model(obj, n_points: int, bbox_padding: float,
                 rng: np.random.Generator, ply_path: str = None,
                 skip_existing: bool = True) -> None:
    """Sample + save one model's npz (reference :142-179 npz layout)."""
    out_path = obj.raw_model_norm_pc_path
    if skip_existing and os.path.isfile(out_path):
        return
    v, f = obj.raw_model()
    v, loc, scale = normalize_to_unit_cube(v, bbox_padding, return_loc_scale=True)
    points, normals = sample_surface(v, f, n_points, rng, return_normals=True)
    np.savez(out_path, points=points.astype(np.float16),
             normals=normals.astype(np.float16), loc=loc, scale=scale)
    if ply_path:
        from ..data.utils_io import export_pointcloud

        export_pointcloud(points.astype(np.float32), ply_path, as_text=False)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Sample normalized point clouds per model (PyTorch port)")
    parser.add_argument("output_directory")
    parser.add_argument("path_to_3d_front_dataset_directory")
    parser.add_argument("path_to_3d_future_dataset_directory")
    parser.add_argument("path_to_model_info")
    parser.add_argument("--pointcloud_size", "--n_points", type=int,
                        default=30000, dest="pointcloud_size",
                        help="points sampled per model (reference "
                        "--pointcloud_size; --n_points kept as an alias)")
    parser.add_argument("--bbox_padding", type=float, default=0.0,
                        help="normalize the longest side to 1 - padding "
                        "(reference :74-79, occnet convention)")
    parser.add_argument("--annotation_file", default=None,
                        help="scene_id,split CSV; when given, objects are "
                        "collected per split through the scene filter like "
                        "the reference (:105-131) and lst files reflect real "
                        "split membership")
    parser.add_argument("--dataset_filtering", default="threed_front_bedroom",
                        choices=["threed_front_bedroom", "threed_front_livingroom",
                                 "threed_front_diningroom", "threed_front_library"])
    parser.add_argument("--path_to_invalid_scene_ids", default=None)
    parser.add_argument("--path_to_invalid_bbox_jids", default=None)
    parser.add_argument("--without_lamps", action="store_true")
    parser.add_argument("--export_ply", action="store_true",
                        help="(fixture mode) also write raw_model_norm_pc.ply "
                        "per model; the split mode always writes the "
                        "reference's threed_future_pointcloud_<room>/<jid>.ply")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    os.makedirs(args.output_directory, exist_ok=True)

    if args.annotation_file:
        # reference mode: per-split scene filtering (:105-131)
        from ..data.filters import filter_function
        from ..data.raw import ThreedFront

        filter_cfg = {
            "filter_fn": args.dataset_filtering,
            "min_n_boxes": -1,
            "max_n_boxes": -1,
            "path_to_invalid_scene_ids": args.path_to_invalid_scene_ids,
            "path_to_invalid_bbox_jids": args.path_to_invalid_bbox_jids,
            "annotation_file": args.annotation_file,
        }
        room_type = args.dataset_filtering.split("_")[-1]
        pc_dir = os.path.join(args.output_directory,
                              f"threed_future_pointcloud_{room_type}")
        os.makedirs(pc_dir, exist_ok=True)
        for split in ["train", "val", "test"]:
            try:
                scenes = ThreedFront.from_dataset_directory(
                    args.path_to_3d_front_dataset_directory, args.path_to_model_info,
                    args.path_to_3d_future_dataset_directory,
                    filter_fn=filter_function(filter_cfg, [split], args.without_lamps),
                )
                rooms = scenes.scenes
            except AssertionError:
                # empty split: the reference writes an empty lst and moves on
                rooms = []
            print(f"{split}: {len(rooms)} rooms")
            objects = {}
            for room in rooms:
                for obj in room.bboxes:
                    objects[obj.model_jid] = obj
            names = []
            for jid, obj in objects.items():
                names.append(jid)
                _write_model(obj, args.pointcloud_size, args.bbox_padding, rng,
                             ply_path=os.path.join(pc_dir, f"{jid}.ply"),
                             skip_existing=False)
            with open(os.path.join(pc_dir, f"{split}.lst"), "w") as fh:
                fh.writelines(name + "\n" for name in names)
            print(f"{split}: wrote {len(names)} models")
        return

    # fixture mode: every model under the 3D-FUTURE dir, shuffled splits
    from ..data.raw import parse_threed_future_models

    models = parse_threed_future_models(
        args.path_to_3d_front_dataset_directory,
        args.path_to_3d_future_dataset_directory,
        args.path_to_model_info,
    )
    names = []
    for i, obj in enumerate(models):
        names.append(obj.model_jid)
        ply = (obj.raw_model_norm_pc_path.replace(".npz", ".ply")
               if args.export_ply else None)
        _write_model(obj, args.pointcloud_size, args.bbox_padding, rng,
                     ply_path=ply)
        if (i + 1) % 100 == 0:
            print(f"{i + 1}/{len(models)}")

    # split lst files (pickle_threed_fucture_pointcloud.py:181-187)
    rng.shuffle(names)
    n = len(names)
    splits = {"train": names[: int(0.8 * n)],
              "val": names[int(0.8 * n): int(0.9 * n)],
              "test": names[int(0.9 * n):]}
    for split, ids in splits.items():
        with open(os.path.join(args.output_directory, f"{split}.lst"), "w") as fh:
            fh.write("\n".join(ids))
    print(f"done: {n} models")


if __name__ == "__main__":
    main()
