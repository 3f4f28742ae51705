"""Preprocess raw 3D-FRONT scenes into the cached training format.

Port of ``diffuscene_tpu/cli/preprocess_data.py`` (reference
``scripts/preprocess_data.py:28-350``), with the same flags: a directory a
room with ``boxes.npz`` (class_labels, translations, sizes, angles,
objfeats and objfeats_32 with ``--add_objfeats``, the 8-bit
``room_layout`` mask and the floor plan), ``room_mask.png`` and the scene's
top-down render, and ``dataset_stats.txt`` with the train split's bounds
and class statistics; concurrent jobs share the work through ``DirLock``.
The mask is the floor plan's triangles filled on a
``--room_mask_size``-square grid (``render_room_mask``), the renders come
from the port's rasterizer, PNG codec and mesh retrieval
(``eval/render.py``, ``eval/png.py``, ``eval/retrieval.py``).  Host work
only, numpy; no Pillow.

    python -m diffuscene_tpu_torch.cli.preprocess_data OUT 3D-FRONT \
        3D-FUTURE-model 3D-FUTURE-model/model_info.json \
        --annotation_file configs/splits/bedroom_threed_front_splits.csv \
        --add_objfeats
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


class DirLock:
    """mkdir-based mutex for concurrent preprocessing jobs
    (scripts/utils.py:24-58)."""

    def __init__(self, dirpath: str):
        self._dirpath = dirpath
        self._acquired = False

    @property
    def is_acquired(self):
        return self._acquired

    def acquire(self):
        if self._acquired:
            return
        try:
            os.mkdir(self._dirpath)
            self._acquired = True
        except FileExistsError:
            pass

    def release(self):
        if not self._acquired:
            return
        try:
            os.rmdir(self._dirpath)
        except FileNotFoundError:
            pass
        self._acquired = False

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *args):
        self.release()


def render_room_mask(room, size: int = 512, extent: float = None) -> np.ndarray:
    """Binary floor-plan occupancy mask rendered top-down (replaces the
    simple_3dviz ortho render at preprocess_data.py:249-255).  ``extent``
    is the world half-side of the ortho view (--room_side); default keeps
    the per-room-type heuristic."""
    vertices, faces = room.floor_plan
    vertices = vertices - room.floor_plan_centroid
    if extent is None:
        extent = 3.1 if "bed" in room.scene_type else 6.2
    img = np.zeros((size, size), np.uint8)
    scale = size / (2 * extent)
    for tri in faces:
        pts = vertices[tri][:, [0, 2]] * scale + size / 2
        _fill_triangle(img, pts)
    return img


def _fill_triangle(img: np.ndarray, pts: np.ndarray):
    size = img.shape[0]
    lo = np.clip(np.floor(pts.min(0)).astype(int), 0, size - 1)
    hi = np.clip(np.ceil(pts.max(0)).astype(int), 0, size - 1)
    if (hi <= lo).any():
        return
    ys, xs = np.mgrid[lo[1] : hi[1] + 1, lo[0] : hi[0] + 1]
    p = np.stack([xs + 0.5, ys + 0.5], -1).reshape(-1, 2)
    a, b, c = pts[0], pts[1], pts[2]
    v0, v1, v2 = b - a, c - a, p - a
    d00, d01, d11 = v0 @ v0, v0 @ v1, v1 @ v1
    d20, d21 = v2 @ v0, v2 @ v1
    denom = d00 * d11 - d01 * d01
    if abs(denom) < 1e-12:
        return
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    inside = (v >= 0) & (w >= 0) & (v + w <= 1)
    img[ys.reshape(-1)[inside], xs.reshape(-1)[inside]] = 255


def main(argv=None):
    parser = argparse.ArgumentParser(description="Preprocess 3D-FRONT into the cached format (PyTorch port)")
    parser.add_argument("output_directory")
    parser.add_argument("path_to_3d_front_dataset_directory")
    parser.add_argument("path_to_3d_future_dataset_directory")
    parser.add_argument("path_to_model_info")
    parser.add_argument("--path_to_invalid_scene_ids", default=None)
    parser.add_argument("--path_to_invalid_bbox_jids", default=None)
    parser.add_argument("--annotation_file", required=True)
    parser.add_argument("--dataset_filtering", default="threed_front_bedroom")
    parser.add_argument("--without_lamps", action="store_true")
    parser.add_argument("--add_objfeats", action="store_true")
    parser.add_argument("--room_mask_size", type=int, default=512)
    parser.add_argument("--room_side", type=float, default=None,
                        help="world half-side of the top-down ortho views "
                        "(reference preprocess_data.py:70 parses 3.1 but "
                        "never uses it; here it overrides the per-room-type "
                        "default of 3.1 bedrooms / 6.2 otherwise)")
    parser.add_argument("--background", type=lambda s: tuple(
        float(x) for x in s.split(",")), default=None,
                        help="accepted for reference drop-in compatibility "
                        "(preprocess_data.py:98 parses it but never uses it)")
    csv_floats = lambda s: tuple(float(x) for x in s.split(","))
    parser.add_argument("--window_size", type=lambda s: tuple(
        int(x) for x in s.split(",")), default=(256, 256),
                        help="scene render size; also names the output file "
                        "rendered_scene_<W>.png (preprocess_data.py:116,"
                        "299-323)")
    parser.add_argument("--no_texture", action="store_true",
                        help="render flat class colors and write "
                        "rendered_scene_notexture_<W>.png "
                        "(preprocess_data.py:122,297-317)")
    parser.add_argument("--without_floor", action="store_true",
                        help="omit the floor plan from scene renders "
                        "(preprocess_data.py:127,335-341)")
    parser.add_argument("--path_to_floor_plan_textures", default=None,
                        help="directory of floor texture images "
                        "(preprocess_data.py:50)")
    parser.add_argument("--up_vector", type=csv_floats, default=(0.0, 0.0, -1.0),
                        help="accepted for reference drop-in compatibility "
                        "(preprocess_data.py:92); the native rasterizer is "
                        "fixed top-down orthographic, which is the "
                        "reference's default camera")
    parser.add_argument("--camera_target", type=csv_floats, default=(0.0, 0.0, 0.0),
                        help="accepted for compatibility (see --up_vector)")
    parser.add_argument("--camera_position", type=csv_floats, default=(0.0, 4.0, 0.0),
                        help="accepted for compatibility (see --up_vector)")
    args = parser.parse_args(argv)

    from ..data.filters import filter_function
    from ..data.raw import ThreedFront
    from ..eval.render import class_colors, render_meshes_topdown, render_topdown, save_image
    from ..eval.retrieval import floor_plan_from_scene, scene_meshes_from_room

    floor_textures = []
    if args.path_to_floor_plan_textures and os.path.isdir(args.path_to_floor_plan_textures):
        floor_textures = sorted(
            os.path.join(args.path_to_floor_plan_textures, f)
            for f in os.listdir(args.path_to_floor_plan_textures)
            if f.lower().endswith((".png", ".jpg", ".jpeg")))
    floor_rng = np.random.default_rng(0)

    os.makedirs(args.output_directory, exist_ok=True)

    filter_cfg = {
        "filter_fn": args.dataset_filtering,
        "path_to_invalid_scene_ids": args.path_to_invalid_scene_ids,
        "path_to_invalid_bbox_jids": args.path_to_invalid_bbox_jids,
        "annotation_file": args.annotation_file,
    }
    # train-split bounds (preprocess_data.py:180-206)
    train_dataset = ThreedFront.from_dataset_directory(
        args.path_to_3d_front_dataset_directory, args.path_to_model_info,
        args.path_to_3d_future_dataset_directory,
        filter_fn=filter_function(filter_cfg, ["train", "val"], args.without_lamps),
    )
    bounds = train_dataset.bounds
    stats = {
        "bounds_translations": list(map(float, np.concatenate(bounds["translations"]))),
        "bounds_sizes": list(map(float, np.concatenate(bounds["sizes"]))),
        "bounds_angles": [float(bounds["angles"][0][0]), float(bounds["angles"][1][0])],
        "bounds_objfeats": list(map(float, np.concatenate(bounds["objfeats"]))),
        "bounds_objfeats_32": list(map(float, np.concatenate(bounds["objfeats_32"]))),
        "class_labels": train_dataset.class_labels,
        "object_types": train_dataset.object_types,
        "class_frequencies": train_dataset.class_frequencies,
        "class_order": train_dataset.class_order,
        "count_furniture": train_dataset.count_furniture,
    }
    with open(os.path.join(args.output_directory, "dataset_stats.txt"), "w") as f:
        json.dump(stats, f)
    print(f"train stats over {len(train_dataset)} scenes written")

    # full split for the cached dirs (preprocess_data.py:210-350)
    dataset = ThreedFront.from_dataset_directory(
        args.path_to_3d_front_dataset_directory, args.path_to_model_info,
        args.path_to_3d_future_dataset_directory,
        filter_fn=filter_function(filter_cfg, ["train", "val", "test"], args.without_lamps),
    )
    class_labels = train_dataset.class_labels
    for room in dataset.scenes:
        room_dir = os.path.join(args.output_directory, room.uid)
        with DirLock(room_dir + ".lock") as lock:
            if not lock.is_acquired:
                continue
            if os.path.exists(os.path.join(room_dir, "boxes.npz")):
                continue
            os.makedirs(room_dir, exist_ok=True)
            mask = render_room_mask(room, args.room_mask_size,
                                    extent=args.room_side)
            save_image(np.repeat(mask[:, :, None], 3, -1),
                       os.path.join(room_dir, "room_mask.png"))
            classes, translations, sizes, angles = [], [], [], []
            objfeats, objfeats_32 = [], []
            for f in room.bboxes:
                classes.append(f.one_hot_label(class_labels))
                translations.append(f.centroid(-room.centroid))
                sizes.append(f.size)
                angles.append([f.z_angle])
                if args.add_objfeats:
                    objfeats.append(f.raw_model_norm_pc_lat())
                    objfeats_32.append(f.raw_model_norm_pc_lat32())
            fv, ff = room.floor_plan
            arrays = dict(
                scene_id=room.scene_id,
                class_labels=np.asarray(classes, np.float32),
                translations=np.asarray(translations, np.float32),
                sizes=np.asarray(sizes, np.float32),
                angles=np.asarray(angles, np.float32),
                room_layout=mask[:, :, None],
                floor_plan_vertices=fv,
                floor_plan_faces=ff,
                floor_plan_centroid=room.floor_plan_centroid,
            )
            if args.add_objfeats:
                arrays["objfeats"] = np.asarray(objfeats, np.float32)
                arrays["objfeats_32"] = np.asarray(objfeats_32, np.float32)
            np.savez_compressed(os.path.join(room_dir, "boxes.npz"), **arrays)
            # scene render (preprocess_data.py:297-350): textured meshes of
            # the room's own furniture when their OBJ files load, flat class
            # colors under --no_texture; box rasterization as the fallback
            size = int(args.window_size[0])
            render_name = (f"rendered_scene_notexture_{size}.png"
                           if args.no_texture else f"rendered_scene_{size}.png")
            extent = args.room_side or (3.1 if "bed" in room.scene_type else 6.2)
            try:
                meshes = scene_meshes_from_room(room, ignore_lamps=args.without_lamps)
                pal = class_colors(len(class_labels))
                colors = pal[[np.argmax(c) for c in classes]]
                if args.without_lamps:
                    keep = [i for i, f in enumerate(room.bboxes)
                            if f.label not in ("ceiling_lamp", "pendant_lamp")]
                    colors = colors[keep]
                if not args.without_floor:
                    floor = floor_plan_from_scene(room, floor_textures, rng=floor_rng)
                    meshes = [floor] + meshes
                    colors = np.concatenate(
                        [np.array([[230, 230, 230]], np.uint8), colors])
                render = render_meshes_topdown(
                    meshes, image_size=size, room_extent=extent, colors=colors,
                    use_textures=not args.no_texture)
            except (OSError, ValueError):
                render = render_topdown(
                    arrays["translations"], arrays["sizes"], arrays["angles"],
                    arrays["class_labels"], image_size=size, room_extent=extent,
                    floor_mask=mask[:, :, None],
                )
            save_image(render, os.path.join(room_dir, render_name))
    print(f"cached {len(dataset)} rooms under {args.output_directory}")


if __name__ == "__main__":
    main()
