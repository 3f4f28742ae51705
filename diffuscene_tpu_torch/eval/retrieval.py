"""Mesh retrieval + scene assembly + OBJ export (host-side, numpy-only).

Copy of ``diffuscene_tpu/eval/retrieval.py``; the JAX package's equivalent
of `scene_synthesis/utils.py:10-165` (get_textured_objects[_based
_on_objfeats]) and the mesh utilities in `scripts/utils.py` (export_scene:257,
merge_meshes:294-329, floor_plan_from_scene:65-181).  trimesh/simple_3dviz are
not used, so meshes are plain (vertices, faces[, texture
path]) records via the numpy OBJ loader in data/raw.py; anything downstream
(renderers, simulators) can consume the exported OBJs.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass
class SceneMesh:
    """A retrieved, world-transformed furniture mesh.

    ``face_uvs`` is (F, 3, 2) per-corner texture coordinates (OBJ ``vt``
    convention: origin bottom-left, wrap allowed; NaN rows = face has no
    UVs); ``texture_path`` the primary diffuse image; ``kd`` a flat diffuse
    color fallback; multi-material OBJs additionally carry
    ``face_materials`` (F,) indices into ``materials``
    ([{"map_kd", "kd"}]) so each ``usemtl`` group samples its own map —
    together the diffuse channel of the reference's TexturedMesh
    (scene_synthesis/utils.py:36-38)."""

    vertices: np.ndarray
    faces: np.ndarray
    label: str
    model_jid: Optional[str] = None
    texture_path: Optional[str] = None
    face_uvs: Optional[np.ndarray] = None
    kd: Optional[np.ndarray] = None
    face_materials: Optional[np.ndarray] = None
    materials: Optional[list] = None

    @property
    def bounding_box(self) -> np.ndarray:
        """[x1, y1, z1, x2, y2, z2]"""
        return np.concatenate([self.vertices.min(0), self.vertices.max(0)])


def _rot_y(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float64)


def _transform_vertices(vertices, angle, translation, target_size=None):
    v = np.asarray(vertices, np.float64)
    if target_size is not None:
        # rescale the raw mesh so its half-extents match the predicted size
        # (scene_synthesis/utils.py:115-122)
        half = (v.max(0) - v.min(0)) / 2
        v = v * (np.asarray(target_size) / np.maximum(half, 1e-9))
    center = (v.max(0) + v.min(0)) / 2
    v = v - center
    v = v @ _rot_y(float(angle)).T
    return v + np.asarray(translation)


def _squeeze(boxes: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k: (np.asarray(v)[0] if np.asarray(v).ndim == 3 else np.asarray(v))
            for k, v in boxes.items() if not isinstance(v, (str, list))}


def _load_mesh(obj):
    """Mesh dict (load_obj_mesh schema) for a catalog object.

    Prefers the UV+MTL-aware loader on the raw OBJ path (so renders can
    texture-sample, like the reference's TexturedMesh.from_file,
    scene_synthesis/utils.py:36-38); falls back to the object's own
    ``raw_model()``/``texture_image_path`` for non-file-backed objects.
    """
    path = getattr(obj, "raw_model_path", None)
    if path and os.path.isfile(path):
        from ..data.raw import load_obj_mesh

        return load_obj_mesh(path)
    v, f = obj.raw_model()
    tex = getattr(obj, "texture_image_path", None)
    if tex is not None and not os.path.isfile(tex):
        tex = None
    return {"vertices": v, "faces": f, "face_uvs": None,
            "texture_path": tex, "kd": None,
            "face_materials": None, "materials": None}


def get_textured_objects(boxes: Dict[str, np.ndarray], objects_dataset,
                         class_labels: Sequence[str]) -> List[SceneMesh]:
    """Retrieve the closest catalog mesh per object by class + size.

    (scene_synthesis/utils.py:10-77).  ``boxes`` is a post-processed per-scene
    dict in world units.
    """
    b = _squeeze(boxes)
    angles = b["angles"]
    theta = np.arctan2(angles[:, 1], angles[:, 0]) if angles.shape[-1] == 2 else angles[:, 0]
    out = []
    for i in range(len(b["class_labels"])):
        label = class_labels[int(b["class_labels"][i].argmax())]
        obj = objects_dataset.get_closest_furniture_to_box(label, b["sizes"][i])
        m = _load_mesh(obj)
        v = m["vertices"] * getattr(obj, "scale", 1.0)
        out.append(SceneMesh(
            vertices=_transform_vertices(v, theta[i], b["translations"][i]),
            faces=m["faces"], label=label,
            model_jid=getattr(obj, "model_jid", None),
            texture_path=m["texture_path"], face_uvs=m["face_uvs"],
            kd=m["kd"], face_materials=m["face_materials"],
            materials=m["materials"],
        ))
    return out


def get_textured_objects_based_on_objfeats(
    boxes: Dict[str, np.ndarray], objects_dataset, class_labels: Sequence[str],
    combine_size: bool = True,
) -> List[SceneMesh]:
    """Retrieve by latent shape code (optionally lexsorted with size), then
    rescale the mesh to the predicted size.  (scene_synthesis/utils.py:80-165)
    """
    b = _squeeze(boxes)
    angles = b["angles"]
    theta = np.arctan2(angles[:, 1], angles[:, 0]) if angles.shape[-1] == 2 else angles[:, 0]
    feats = b["objfeats"] if "objfeats" in b else b["objfeats_32"]
    out = []
    for i in range(len(b["class_labels"])):
        label = class_labels[int(b["class_labels"][i].argmax())]
        if combine_size:
            obj = objects_dataset.get_closest_furniture_to_objfeats_and_size(
                label, feats[i], b["sizes"][i])
        else:
            obj = objects_dataset.get_closest_furniture_to_objfeats(label, feats[i])
        m = _load_mesh(obj)
        out.append(SceneMesh(
            vertices=_transform_vertices(m["vertices"], theta[i],
                                         b["translations"][i],
                                         target_size=b["sizes"][i]),
            faces=m["faces"], label=label,
            model_jid=getattr(obj, "model_jid", None),
            texture_path=m["texture_path"], face_uvs=m["face_uvs"],
            kd=m["kd"], face_materials=m["face_materials"],
            materials=m["materials"],
        ))
    return out


def scene_meshes_from_room(room, ignore_lamps: bool = False) -> List[SceneMesh]:
    """World-transformed textured meshes of a raw Room's own furniture,
    centered at the room centroid — the reference's
    ``get_textured_objects_in_scene`` (scripts/utils.py:184-217), used by
    preprocessing to render the "real" scene images that feed FID.
    """
    out = []
    for f in room.bboxes:
        label = getattr(f, "label", "")
        if ignore_lamps and label in ("ceiling_lamp", "pendant_lamp"):
            continue
        m = _load_mesh(f)
        # the furniture's own transform: scale, z-rotation, position
        # (threed_front_scene.py raw_model_transformed)
        v = f._transform(np.asarray(m["vertices"])) - np.asarray(room.centroid)
        out.append(SceneMesh(
            vertices=v, faces=m["faces"], label=label,
            model_jid=getattr(f, "model_jid", None),
            texture_path=m["texture_path"], face_uvs=m["face_uvs"],
            kd=m["kd"], face_materials=m["face_materials"],
            materials=m["materials"],
        ))
    return out


def floor_plan_from_scene(room, floor_textures: Sequence[str] = (),
                          rng: Optional[np.random.Generator] = None,
                          texture_scale: float = 2.0) -> SceneMesh:
    """Floor mesh of a cached/raw room, centered at its centroid.

    (scripts/utils.py:65-181 minus the simple_3dviz renderable wrapping.)
    Accepts anything exposing ``floor_plan`` and ``floor_plan_centroid`` —
    a raw `Room` or a cached boxes.npz record dict.  When a texture is
    chosen, the floor gets world-plane UVs tiled every ``texture_scale``
    meters (the reference tiles its floor texture over the plan the same
    way, scripts/utils.py:160-176); the renderer wraps UVs mod 1.
    """
    if isinstance(room, dict):
        vertices = np.asarray(room["floor_plan_vertices"])
        faces = np.asarray(room["floor_plan_faces"])
        centroid = np.asarray(room["floor_plan_centroid"])
    else:
        vertices, faces = room.floor_plan
        centroid = room.floor_plan_centroid
    texture = None
    if floor_textures:
        rng = rng or np.random.default_rng()
        texture = floor_textures[int(rng.integers(len(floor_textures)))]
    vertices = vertices - centroid
    face_uvs = None
    if texture is not None and len(faces):
        uv = vertices[:, [0, 2]] / float(texture_scale)
        face_uvs = uv[np.asarray(faces, np.int64)]  # (F, 3, 2)
    return SceneMesh(vertices=vertices, faces=faces,
                     label="floor", texture_path=texture, face_uvs=face_uvs)


def merge_meshes(meshes: Sequence[SceneMesh]) -> SceneMesh:
    """Concatenate meshes into one (scripts/utils.py:294-329, sans open3d).
    A scene with no objects merges to an empty mesh (the JAX package's
    ``np.vstack`` raises on it)."""
    vs, fs, off = [np.zeros((0, 3))], [np.zeros((0, 3), np.int64)], 0
    for m in meshes:
        vs.append(m.vertices)
        fs.append(np.asarray(m.faces) + off)
        off += len(m.vertices)
    return SceneMesh(vertices=np.vstack(vs), faces=np.vstack(fs), label="scene")


def _mesh_material_slots(mesh: SceneMesh):
    """(slots, face_slot) mirroring the renderer's binding: slot 0 is the
    mesh-level primary material, per-``usemtl`` slots follow, and
    ``face_slot[fi]`` indexes into ``slots`` (None = single-material mesh,
    every face uses slot 0)."""
    slots = [{"map_kd": mesh.texture_path,
              "kd": None if mesh.kd is None else np.asarray(mesh.kd)}]
    face_slot = None
    if mesh.materials is not None and mesh.face_materials is not None:
        for m in mesh.materials:
            slots.append({"map_kd": m.get("map_kd"),
                          "kd": None if m.get("kd") is None
                          else np.asarray(m["kd"])})
        face_slot = np.asarray(mesh.face_materials, np.int64) + 1
    return slots, face_slot


def write_obj(mesh: SceneMesh, path: str, write_materials: bool = True) -> List[str]:
    """Textured OBJ (+MTL + copied texture images) export.

    The reference exports per-object OBJ/MTL/texture triples through
    trimesh (scripts/utils.py:257-291); here the mesh's diffuse channel
    (UVs, per-``usemtl`` bindings, Kd fallbacks) is written directly so
    ``load_obj_mesh`` round-trips it.  Faces with NaN UVs are written
    without ``vt`` indices.  Returns every file path written.
    """
    stem = os.path.splitext(os.path.basename(path))[0]
    base = os.path.dirname(os.path.abspath(path))
    slots, face_slot = _mesh_material_slots(mesh)
    has_mat = write_materials and any(
        s["map_kd"] or s["kd"] is not None for s in slots)
    written = [path]

    # slot 0 (the mesh-level primary) is only bound by faces when there is
    # no per-face table, or for faces that predate any usemtl (-1 -> slot 0)
    slot_used = [face_slot is None or bool((face_slot == si).any())
                 if si == 0 else True for si in range(len(slots))]
    mtl_of_slot = {}
    if has_mat:
        import shutil

        mtl_path = os.path.join(base, stem + ".mtl")
        written.append(mtl_path)
        with open(mtl_path, "w") as f:
            for si, s in enumerate(slots):
                if not slot_used[si] or (not s["map_kd"] and s["kd"] is None):
                    continue
                name = f"{stem}_mat{si}"
                mtl_of_slot[si] = name
                kd = s["kd"] if s["kd"] is not None else np.ones(3)
                f.write(f"newmtl {name}\n")
                f.write(f"Kd {kd[0]:.6f} {kd[1]:.6f} {kd[2]:.6f}\n")
                if s["map_kd"] and os.path.isfile(s["map_kd"]):
                    ext = os.path.splitext(s["map_kd"])[1] or ".png"
                    tex_name = f"{name}{ext}"
                    tex_out = os.path.join(base, tex_name)
                    if os.path.abspath(s["map_kd"]) != os.path.abspath(tex_out):
                        shutil.copyfile(s["map_kd"], tex_out)
                    written.append(tex_out)
                    f.write(f"map_Kd {tex_name}\n")

    uvs = mesh.face_uvs
    with open(path, "w") as f:
        f.write(f"# diffuscene_tpu export: {mesh.label}\n")
        if mtl_of_slot:
            f.write(f"mtllib {stem}.mtl\n")
        for v in mesh.vertices:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        n_vt = 0
        cur = None
        for fi, face in enumerate(np.asarray(mesh.faces, np.int64)):
            si = int(face_slot[fi]) if face_slot is not None else 0
            si = si if si in mtl_of_slot else 0
            if mtl_of_slot and si != cur and si in mtl_of_slot:
                f.write(f"usemtl {mtl_of_slot[si]}\n")
                cur = si
            fuv = uvs[fi] if uvs is not None else None
            if fuv is not None and np.isfinite(fuv).all():
                for k in range(3):
                    f.write(f"vt {fuv[k, 0]:.6f} {fuv[k, 1]:.6f}\n")
                f.write(f"f {face[0] + 1}/{n_vt + 1} "
                        f"{face[1] + 1}/{n_vt + 2} "
                        f"{face[2] + 1}/{n_vt + 3}\n")
                n_vt += 3
            else:
                f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")
    return written


def export_scene(output_directory: str, meshes: Sequence[SceneMesh],
                 names: Optional[Sequence[str]] = None) -> List[str]:
    """One textured OBJ (+MTL/texture) per object (scripts/utils.py:257-291)."""
    os.makedirs(output_directory, exist_ok=True)
    paths = []
    for i, m in enumerate(meshes):
        name = names[i] if names else f"object_{i:03d}.obj"
        p = os.path.join(output_directory, name)
        write_obj(m, p)
        paths.append(p)
    return paths


def write_ply(mesh: SceneMesh, path: str) -> str:
    """ASCII PLY mesh export (vertices + triangle faces, no materials) —
    the reference's default --mesh_format .ply merged-scene export
    (generate_diffusion.py:157-162,431-444 via trimesh)."""
    v = np.asarray(mesh.vertices, np.float64)
    f = np.asarray(mesh.faces, np.int64).reshape(-1, 3)
    with open(path, "w") as fh:
        fh.write("ply\nformat ascii 1.0\n")
        fh.write(f"element vertex {len(v)}\n")
        fh.write("property float x\nproperty float y\nproperty float z\n")
        fh.write(f"element face {len(f)}\n")
        fh.write("property list uchar int vertex_indices\nend_header\n")
        for x, y, z in v:
            fh.write(f"{x:.6f} {y:.6f} {z:.6f}\n")
        for a, b, c in f:
            fh.write(f"3 {a} {b} {c}\n")
    return path
