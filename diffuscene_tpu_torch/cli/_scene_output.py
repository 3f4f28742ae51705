"""Shared per-scene render/export plumbing for the sampling CLIs.

Copy of ``diffuscene_tpu/cli/_scene_output.py``: the flags, the catalog
(the port's ``ThreedFutureDataset``), the renders (``eval/render.py``) and
the mesh export (``eval/retrieval.py``) are the port's own.

The reference funnels generate/completion/rearrange output through one
helper (`scripts/utils.py render_scene_from_bbox_params:460-560`): retrieve
textured catalog meshes for the sampled boxes, add the floor plan, render
top-down, and optionally export mesh files.  This module is that funnel for
the sampling CLIs — `generate_diffusion` and `completion_rearrange` both feed
their post-processed boxes through a `SceneOutput`.
"""
from __future__ import annotations

import json
import os

import numpy as np


def add_scene_output_args(parser):
    """Mesh-retrieval / render / export flags shared by the sampling CLIs
    (reference argument set: generate_diffusion.py:60-160,
    completion_rearrange.py:100-160).  The catalog pickle is accepted both
    as the reference's third positional and as a flag; call
    :func:`resolve_scene_output_args` after parsing to merge them."""
    parser.add_argument("pickled_models_pos", nargs="?", default=None,
                        metavar="path_to_pickled_3d_futute_models",
                        help="the reference's third positional: pickled "
                        "3D-FUTURE catalog for mesh retrieval "
                        "(generate_diffusion.py:56-59); the flag form below "
                        "wins when both are given")
    parser.add_argument("--retrive_objfeats", action="store_true",
                        help="retrieve meshes by latent shape codes")
    parser.add_argument("--path_to_pickled_3d_futute_models", default=None)
    parser.add_argument("--no_texture", action="store_true",
                        help="render flat class colors instead of sampling the "
                        "catalog diffuse textures (reference --no_texture)")
    parser.add_argument("--path_to_floor_plan_textures", default=None,
                        help="directory of floor texture images; when given, "
                        "renders include a textured floor plan picked from the "
                        "eval split (reference generate_diffusion.py:66-68,305-309)")
    parser.add_argument("--without_floor", action="store_true",
                        help="skip the floor plan in renders (reference :142-144)")
    parser.add_argument("--save_mesh", action="store_true",
                        help="write the merged scene mesh + per-object textured "
                        "OBJ/MTL/texture triples under scene_mesh/ "
                        "(reference generate_diffusion.py:431-444)")
    parser.add_argument("--mesh_format", default=".obj",
                        choices=[".obj", ".ply"],
                        help="format of the merged scene mesh written by "
                        "--save_mesh (reference --mesh_format, "
                        "generate_diffusion.py:157-162; default there .ply, "
                        "here .obj so textures survive)")
    # perspective / orbiting camera (reference generate_diffusion.py:82-127;
    # rendered there with simple_3dviz, here eval/render.py's numpy
    # perspective rasterizer).  --render stays top-down orthographic (the
    # metric-comparable view); these add the qualitative-viz surface.
    csv_floats = lambda s: tuple(float(x) for x in s.split(","))
    parser.add_argument("--background", type=csv_floats, default=(1.0, 1.0, 1.0, 1.0),
                        help="render background RGBA in [0,1] (the reference "
                        "parses this flag but hardcodes white/black by "
                        "--no_texture, generate_diffusion.py:82,253-255; the "
                        "native rasterizers honor it)")
    parser.add_argument("--without_screen", action="store_true",
                        help="accepted for reference drop-in compatibility "
                        "(generate_diffusion.py:127); the native rasterizer "
                        "is always offscreen")
    parser.add_argument("--render_perspective", action="store_true",
                        help="also save a perspective render per scene "
                        "(*_persp.png) using the camera flags below")
    parser.add_argument("--up_vector", type=csv_floats, default=(0.0, 1.0, 0.0))
    parser.add_argument("--camera_position", type=csv_floats,
                        default=(-0.10923499, 1.9325259, -7.19009))
    parser.add_argument("--camera_target", type=csv_floats, default=(0.0, 0.0, 0.0))
    parser.add_argument("--window_size", type=lambda s: tuple(
        int(x) for x in s.split(",")), default=(512, 512))
    parser.add_argument("--with_rotating_camera", action="store_true",
                        help="render an orbit of --n_frames frames per scene "
                        "(reference generate_diffusion.py:104-127)")
    parser.add_argument("--save_frames", default=None,
                        help="directory for the orbit frames (default: "
                        "<output>/frames)")
    parser.add_argument("--n_frames", type=int, default=360)


def resolve_scene_output_args(args):
    """Merge the positional catalog path into the flag dest (flag wins)."""
    if getattr(args, "pickled_models_pos", None) and not getattr(
            args, "path_to_pickled_3d_futute_models", None):
        args.path_to_pickled_3d_futute_models = args.pickled_models_pos
    return args


class SceneOutput:
    """Per-scene render + mesh export against a retrieved catalog.

    Construct once per CLI run; call :meth:`render` / :meth:`export` per
    post-processed scene.  When no catalog pickle was given, renders fall
    back to oriented-box rasterization and exports are skipped.
    """

    def __init__(self, args, raw, seed: int = 0):
        self.args = args
        self.raw = raw
        bg = getattr(args, "background", (1.0, 1.0, 1.0, 1.0)) or (1.0, 1.0, 1.0, 1.0)
        self.background = tuple(
            min(255, max(0, int(round(255 * c)))) for c in bg[:3])
        self.floor_rng = np.random.default_rng(seed)
        self.objects_dataset = None
        if getattr(args, "path_to_pickled_3d_futute_models", None):
            from ..data.threed_future import ThreedFutureDataset

            self.objects_dataset = ThreedFutureDataset.from_pickled_dataset(
                args.path_to_pickled_3d_futute_models)

        self.floor_textures = []
        if getattr(args, "path_to_floor_plan_textures", None):
            if not os.path.isdir(args.path_to_floor_plan_textures):
                raise SystemExit(
                    f"--path_to_floor_plan_textures: no such directory "
                    f"{args.path_to_floor_plan_textures!r}")
            self.floor_textures = sorted(
                os.path.join(args.path_to_floor_plan_textures, f)
                for f in os.listdir(args.path_to_floor_plan_textures)
                if f.lower().endswith((".png", ".jpg", ".jpeg")))
            if not self.floor_textures:
                print(f"WARNING: no texture images in "
                      f"{args.path_to_floor_plan_textures!r}; floors render flat")

    def retrieve(self, boxes):
        """Retrieved, world-transformed SceneMesh list for one scene
        (scene_synthesis/utils.py:10-165)."""
        from ..eval.retrieval import (
            get_textured_objects, get_textured_objects_based_on_objfeats,
        )

        if self.args.retrive_objfeats:
            return get_textured_objects_based_on_objfeats(
                boxes, self.objects_dataset, self.raw.class_labels)
        return get_textured_objects(boxes, self.objects_dataset,
                                    self.raw.class_labels)

    def _scene_meshes(self, boxes, idx: int, floor_idx: int | None = None):
        """(meshes, colors) for one scene: retrieved catalog meshes plus the
        conditioning scene's floor plan (generate_diffusion.py:305-315)."""
        from ..eval.render import class_colors
        from ..eval.retrieval import floor_plan_from_scene

        meshes = self.retrieve(boxes)
        pal = class_colors(len(self.raw.class_labels))
        cls = np.asarray(boxes["class_labels"])
        cls = cls[0] if cls.ndim == 3 else cls
        colors = pal[cls.argmax(-1)]
        if not self.args.without_floor and hasattr(self.raw, "get_floor_plan") \
                and len(self.raw) > 0:
            # a floor plan from the eval split, textured when a texture dir
            # is given (generate_diffusion.py:305-309)
            floor = floor_plan_from_scene(
                self.raw.get_floor_plan(
                    (idx if floor_idx is None else floor_idx) % len(self.raw)),
                self.floor_textures, rng=self.floor_rng)
            meshes = [floor] + meshes
            colors = np.concatenate(
                [np.array([[230, 230, 230]], np.uint8), colors])
        return meshes, colors

    def render(self, boxes, idx: int, floor_idx: int | None = None) -> np.ndarray:
        """Top-down render of one scene: mesh-accurate with texture sampling
        when a catalog is loaded (generate_diffusion.py:251-264 path), else
        oriented boxes.  ``floor_idx`` selects which eval-split scene provides
        the floor plan (the conditioning scene under --scene_id/--fix_order,
        generate_diffusion.py:305-315); defaults to the output index."""
        if self.objects_dataset is None:
            from ..eval.render import render_scene_dict

            return render_scene_dict(boxes, floor_mask=None)

        from ..eval.render import render_meshes_topdown

        meshes, colors = self._scene_meshes(boxes, idx, floor_idx)
        return render_meshes_topdown(meshes, colors=colors,
                                     background=self.background,
                                     use_textures=not self.args.no_texture)

    def perspective_outputs(self, boxes, idx: int, output_directory: str,
                            floor_idx: int | None = None):
        """Perspective render (+ optional orbit frames) for one scene —
        the reference's default camera surface (--camera_position /
        --up_vector / --with_rotating_camera / --save_frames / --n_frames,
        generate_diffusion.py:82-127).  No-op without a retrieved catalog."""
        a = self.args
        if self.objects_dataset is None or not (
                getattr(a, "render_perspective", False)
                or getattr(a, "with_rotating_camera", False)):
            return
        from ..eval.render import (
            render_meshes_perspective, render_orbit_frames, save_image,
        )

        meshes, colors = self._scene_meshes(boxes, idx, floor_idx)
        cam = dict(camera_position=a.camera_position,
                   camera_target=a.camera_target, up_vector=a.up_vector,
                   window_size=a.window_size, colors=colors,
                   background=self.background,
                   use_textures=not a.no_texture)
        if getattr(a, "render_perspective", False):
            save_image(render_meshes_perspective(meshes, **cam),
                       os.path.join(output_directory, f"{idx:05d}_persp.png"))
        if getattr(a, "with_rotating_camera", False):
            frames_root = a.save_frames or os.path.join(output_directory, "frames")
            cam.pop("camera_position")
            render_orbit_frames(
                meshes, os.path.join(frames_root, f"{idx:05d}"),
                camera_position=a.camera_position, n_frames=a.n_frames, **cam)

    def export(self, boxes, idx: int, output_directory: str):
        """Mesh files + retrieval manifest for one scene, like the
        reference's --save_mesh (generate_diffusion.py:431-444 merged scene
        OBJ under scene_mesh/, per-object textured triples via export_scene,
        scripts/utils.py:257-291)."""
        if self.objects_dataset is None:
            return
        from ..eval.retrieval import export_scene, merge_meshes, write_obj, write_ply

        self._write_manifest(boxes, os.path.join(output_directory, f"{idx:05d}"))
        meshes = self.retrieve(boxes)
        scene_dir = os.path.join(output_directory, "scene_mesh")
        os.makedirs(scene_dir, exist_ok=True)
        merged = merge_meshes(meshes)
        if getattr(self.args, "mesh_format", ".obj") == ".ply":
            # reference default format (generate_diffusion.py:157-162)
            write_ply(merged, os.path.join(scene_dir, f"{idx:05d}.ply"))
        else:
            write_obj(merged, os.path.join(scene_dir, f"{idx:05d}.obj"))
        export_scene(os.path.join(scene_dir, f"{idx:05d}"), meshes)

    def _write_manifest(self, boxes, out_prefix: str):
        """JSON manifest of retrieved jids + transforms (the machine-readable
        counterpart of the reference's model_jids bookkeeping,
        scene_synthesis/utils.py:10-165)."""
        sq = lambda a: np.asarray(a)[0] if np.asarray(a).ndim == 3 else np.asarray(a)
        cls = sq(boxes["class_labels"])
        ds = self.objects_dataset
        manifest = []
        for i in range(len(cls)):
            label = self.raw.class_labels[int(cls[i].argmax())]
            if self.args.retrive_objfeats and "objfeats" in boxes:
                obj = ds.get_closest_furniture_to_objfeats_and_size(
                    label, sq(boxes["objfeats"])[i], sq(boxes["sizes"])[i])
            else:
                obj = ds.get_closest_furniture_to_box(label, sq(boxes["sizes"])[i])
            manifest.append({
                "label": label,
                "model_jid": getattr(obj, "model_jid", None),
                "translation": sq(boxes["translations"])[i].tolist(),
                "size": sq(boxes["sizes"])[i].tolist(),
                "angle": sq(boxes["angles"])[i].tolist(),
            })
        with open(out_prefix + "_scene.json", "w") as f:
            json.dump(manifest, f, indent=2)
