"""The 3D-FUTURE furniture records that a pickled catalog holds, and the OBJ
reader the renders and mesh retrieval use.

Copy of the mesh and furniture parts of ``diffuscene_tpu/data/raw.py``
(reference ``scene_synthesis/datasets/threed_front_scene.py:21-448`` and
``scene_synthesis/utils.py:10-77``): the numpy OBJ/MTL reader
(``load_obj_vertices_faces``, ``load_obj_mesh``), ``Asset``,
``BaseThreedFutureModel``, ``ThreedFutureModel`` (paths, the cached point
cloud and latents, the raw and transformed mesh, bounding-box corners,
size, centroid, z angle) and ``ThreedFutureExtra``.  ``ModelInfo``,
``Room`` and the 3D-FRONT scene parsers are not copied yet
(``cli/preprocess_data.py`` and ``cli/pickle_threed_future_*.py`` stay
queued, ROADMAP A7/A8).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


def rotation_matrix(axis, theta: float) -> np.ndarray:
    """Axis-angle rotation matrix (3D-Front-Toolbox convention;
    threed_front_scene.py:21-31)."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.sqrt(np.dot(axis, axis))
    a = np.cos(theta / 2.0)
    b, c, d = -axis * np.sin(theta / 2.0)
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    bc, ad, ac, ab, bd, cd = b * c, a * d, a * c, a * b, b * d, c * d
    return np.array([
        [aa + bb - cc - dd, 2 * (bc + ad), 2 * (bd - ac)],
        [2 * (bc - ad), aa + cc - bb - dd, 2 * (cd + ab)],
        [2 * (bd + ac), 2 * (cd - ab), aa + dd - bb - cc],
    ])


def _parse_obj(path: str):
    """Single OBJ text parser shared by both loaders (one copy of the
    negative-index + fan-triangulation rules).

    Returns ``(vertices (V,3) f64, faces (F,3) i64, uvs (T,2) f64,
    face_uv_idx (F,3) i64 with -1 = no vt on that corner,
    face_mtl (F,) i64 index into mtl_names with -1 = before any usemtl,
    mtl_names [str] in order of first use, mtllib str|None)``.
    """
    vertices: List[List[float]] = []
    uvs: List[List[float]] = []
    faces: List[List[int]] = []
    face_uv_idx: List[List[int]] = []
    face_mtl: List[int] = []
    mtl_names: List[str] = []
    mtl_index: Dict[str, int] = {}
    mtllib = None
    cur_mtl = -1
    with open(path, "r", errors="ignore") as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                vertices.append([float(p[1]), float(p[2]), float(p[3])])
            elif line.startswith("vt "):
                p = line.split()
                uvs.append([float(p[1]), float(p[2]) if len(p) > 2 else 0.0])
            elif line.startswith("f "):
                vi, ti = [], []
                for tok in line.split()[1:]:
                    sub = tok.split("/")
                    i = int(sub[0])
                    vi.append(i - 1 if i > 0 else len(vertices) + i)
                    if len(sub) > 1 and sub[1]:
                        j = int(sub[1])
                        ti.append(j - 1 if j > 0 else len(uvs) + j)
                    else:
                        ti.append(-1)
                for k in range(1, len(vi) - 1):
                    faces.append([vi[0], vi[k], vi[k + 1]])
                    face_uv_idx.append([ti[0], ti[k], ti[k + 1]])
                    face_mtl.append(cur_mtl)
            elif line.startswith("mtllib ") and mtllib is None:
                mtllib = line.split(None, 1)[1].strip()
            elif line.startswith("usemtl "):
                name = line.split(None, 1)[1].strip()
                if name not in mtl_index:
                    mtl_index[name] = len(mtl_names)
                    mtl_names.append(name)
                cur_mtl = mtl_index[name]
    return (np.asarray(vertices, np.float64),
            np.asarray(faces, np.int64).reshape(-1, 3),
            np.asarray(uvs, np.float64).reshape(-1, 2),
            np.asarray(face_uv_idx, np.int64).reshape(-1, 3),
            np.asarray(face_mtl, np.int64),
            mtl_names, mtllib)


def load_obj_vertices_faces(path: str):
    """Minimal OBJ reader: vertices (V, 3) float64 + triangle faces (F, 3) int.

    Replaces trimesh.load for bbox/size computation
    (threed_front_scene.py:270-283).  Polygons are fan-triangulated.
    """
    v, faces, _, _, _, _, _ = _parse_obj(path)
    return v, faces


def _parse_mtl_diffuse(mtl_path: str) -> Dict[str, Dict]:
    """material name -> {"map_kd": abs path | None, "kd": (3,) float | None}.

    Minimal MTL reader for the diffuse channel only — the reference's
    TexturedMesh uses the diffuse texture for rendering
    (scene_synthesis/utils.py:10-77 via simple_3dviz TexturedMesh.from_file).
    """
    materials: Dict[str, Dict] = {}
    cur = None
    base = os.path.dirname(os.path.abspath(mtl_path))
    try:
        with open(mtl_path, "r", errors="ignore") as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                if parts[0] == "newmtl" and len(parts) > 1:
                    cur = parts[1]
                    materials[cur] = {"map_kd": None, "kd": None}
                elif parts[0] == "map_Kd" and cur and len(parts) > 1:
                    materials[cur]["map_kd"] = os.path.join(base, parts[-1])
                elif parts[0] == "Kd" and cur and len(parts) >= 4:
                    materials[cur]["kd"] = np.asarray(
                        [float(parts[1]), float(parts[2]), float(parts[3])],
                        np.float32)
    except OSError:
        pass
    return materials


def load_obj_mesh(path: str) -> Dict:
    """OBJ reader keeping UVs and the MTL diffuse channel.

    Returns ``{"vertices": (V, 3) f64, "faces": (F, 3) i64,
    "face_uvs": (F, 3, 2) f64 | None, "texture_path": str | None,
    "kd": (3,) f32 | None, "face_materials": (F,) i64 | None,
    "materials": [{"map_kd", "kd"}] | None}``.  Polygons are
    fan-triangulated with UV indices kept aligned; faces without ``vt``
    indices get NaN UV rows (renderers fall back to flat color per face,
    so a few untextured faces don't untexture the whole mesh).

    ``texture_path``/``kd`` describe the PRIMARY material — the used
    material whose readable ``map_Kd`` covers the most faces, else the
    first material, else a ``texture.png`` next to the OBJ (the 3D-FUTURE
    layout the reference reads directly, threed_front_scene.py:241-246).
    When several ``usemtl`` groups are present, ``face_materials`` +
    ``materials`` additionally carry the per-face binding so renderers can
    sample each group's own diffuse map.  Replaces trimesh's TexturedMesh
    loading (scene_synthesis/utils.py:36-38) for the native renderer.
    """
    v, fc, uv_arr, uv_idx, face_mtl, mtl_names, mtllib = _parse_obj(path)

    face_uvs = None
    if len(uv_arr) and len(fc) and (uv_idx >= 0).any():
        face_uvs = uv_arr[np.clip(uv_idx, 0, len(uv_arr) - 1)]  # (F, 3, 2)
        bad = (uv_idx < 0).any(axis=1)
        if bad.any():
            face_uvs[bad] = np.nan

    base = os.path.dirname(os.path.abspath(path))
    named = _parse_mtl_diffuse(os.path.join(base, mtllib)) if mtllib else {}
    # materials[i] <-> mtl_names[i]; unreadable map_Kd paths dropped to None
    materials = []
    for name in mtl_names:
        m = dict(named.get(name) or {"map_kd": None, "kd": None})
        if m["map_kd"] is not None and not os.path.isfile(m["map_kd"]):
            m["map_kd"] = None
        materials.append(m)

    # primary material: readable map_Kd covering the most faces, else first
    texture_path, kd = None, None
    textured = [i for i, m in enumerate(materials) if m["map_kd"] is not None]
    if textured:
        counts = [(face_mtl == i).sum() for i in textured]
        primary = materials[textured[int(np.argmax(counts))]]
        texture_path, kd = primary["map_kd"], primary["kd"]
    elif materials:
        texture_path, kd = materials[0]["map_kd"], materials[0]["kd"]
    if texture_path is not None and not os.path.isfile(texture_path):
        texture_path = None
    if texture_path is None and named:
        # "any material's map_Kd": usemtl names may not match the MTL file
        for m in named.values():
            if m["map_kd"] is not None and os.path.isfile(m["map_kd"]):
                texture_path = texture_path or m["map_kd"]
                kd = kd if kd is not None else m["kd"]
                break
        else:
            if kd is None:
                kd = next(iter(named.values()))["kd"]
    if texture_path is None:
        fallback = os.path.join(base, "texture.png")
        texture_path = fallback if os.path.isfile(fallback) else None

    multi = len(materials) > 1
    return {"vertices": v, "faces": fc, "face_uvs": face_uvs,
            "texture_path": texture_path, "kd": kd,
            "face_materials": face_mtl if multi else None,
            "materials": materials if multi else None}


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

    def _transform(self, vertices: np.ndarray) -> np.ndarray:
        ref = [0, 0, 1]
        axis = np.cross(ref, self.rotation[1:])
        theta = np.arccos(np.dot(ref, self.rotation[1:])) * 2
        vertices = vertices * self.scale
        if np.sum(axis) != 0 and not np.isnan(theta):
            R = rotation_matrix(axis, theta)
            vertices = vertices.dot(R.T)
        return vertices + self.position


class ThreedFutureModel(BaseThreedFutureModel):
    """One furniture instance (threed_front_scene.py:187-420)."""

    def __init__(self, model_uid, model_jid, model_info, position, rotation,
                 scale, path_to_models):
        super().__init__(model_uid, model_jid, position, rotation, scale)
        self.model_info = model_info
        self.path_to_models = path_to_models
        self._label: Optional[str] = None
        self._size: Optional[np.ndarray] = None

    # --- paths (threed_front_scene.py:205-254) ---
    @property
    def raw_model_path(self):
        return os.path.join(self.path_to_models, self.model_jid, "raw_model.obj")

    @property
    def raw_model_norm_pc_path(self):
        return os.path.join(self.path_to_models, self.model_jid, "raw_model_norm_pc.npz")

    @property
    def raw_model_norm_pc_lat_path(self):
        return os.path.join(self.path_to_models, self.model_jid, "raw_model_norm_pc_lat.npz")

    @property
    def raw_model_norm_pc_lat32_path(self):
        return os.path.join(self.path_to_models, self.model_jid, "raw_model_norm_pc_lat32.npz")

    @property
    def texture_image_path(self):
        return os.path.join(self.path_to_models, self.model_jid, "texture.png")

    @property
    def path_to_bbox_vertices(self):
        return os.path.join(self.path_to_models, self.model_jid, "bbox_vertices.npy")

    # --- cached per-model data ---
    def raw_model_norm_pc(self):
        return np.load(self.raw_model_norm_pc_path)["points"].astype(np.float32)

    def raw_model_norm_pc_lat(self):
        return np.load(self.raw_model_norm_pc_lat_path)["latent"].astype(np.float32)

    def raw_model_norm_pc_lat32(self):
        return np.load(self.raw_model_norm_pc_lat32_path)["latent"].astype(np.float32)

    def raw_model(self):
        """(vertices, faces) of the raw OBJ (numpy, not trimesh)."""
        return load_obj_vertices_faces(self.raw_model_path)

    def raw_model_transformed(self, offset=(0.0, 0.0, 0.0)):
        v, f = self.raw_model()
        return self._transform(v) + np.asarray(offset), f

    def _bbox_vertices(self) -> np.ndarray:
        """8 bbox corner vertices of the raw model, cached on disk
        (threed_front_scene.py:339-345)."""
        try:
            return np.load(self.path_to_bbox_vertices, mmap_mode="r")
        except (FileNotFoundError, ValueError):
            v, _ = self.raw_model()
            lo, hi = v.min(0), v.max(0)
            # trimesh bounding_box vertex ordering: z fastest, then y, then x
            corners = np.array([
                [x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])
            ])
            try:
                np.save(self.path_to_bbox_vertices, corners)
            except OSError:
                pass
            return corners

    def corners(self, offset=(0.0, 0.0, 0.0)) -> np.ndarray:
        return self._transform(self._bbox_vertices()) + np.asarray(offset)

    def centroid(self, offset=(0.0, 0.0, 0.0)):
        return self.corners(offset).mean(axis=0)

    @property
    def size(self) -> np.ndarray:
        """Half-extents from transformed bbox corner distances
        (threed_front_scene.py:295-302)."""
        if self._size is None:
            c = self.corners()
            self._size = np.array([
                np.sqrt(np.sum((c[4] - c[0]) ** 2)) / 2,
                np.sqrt(np.sum((c[2] - c[0]) ** 2)) / 2,
                np.sqrt(np.sum((c[1] - c[0]) ** 2)) / 2,
            ])
        return self._size

    @size.setter
    def size(self, value):
        self._size = np.asarray(value)

    def bottom_center(self, offset=(0.0, 0.0, 0.0)):
        centroid = self.centroid(offset)
        return np.array([centroid[0], centroid[1] - self.size[1], centroid[2]])

    @property
    def z_angle(self) -> float:
        """Rotation about +y in (-pi, pi].  (threed_front_scene.py:313-330)"""
        ref = [0, 0, 1]
        axis = np.cross(ref, self.rotation[1:])
        theta = np.arccos(np.dot(ref, self.rotation[1:])) * 2
        if np.sum(axis) == 0 or np.isnan(theta):
            return 0
        assert np.dot(axis, [1, 0, 1]) == 0
        assert 0 <= theta <= 2 * np.pi
        if theta >= np.pi:
            theta = theta - 2 * np.pi
        return np.sign(axis[1]) * theta

    @property
    def label(self):
        if self._label is None:
            self._label = self.model_info.label
        return self._label

    @label.setter
    def label(self, value):
        self._label = value

    def copy_from_other_model(self, other_model: "ThreedFutureModel") -> "ThreedFutureModel":
        """(threed_front_scene.py:408-420)"""
        model = ThreedFutureModel(
            model_uid=other_model.model_uid,
            model_jid=other_model.model_jid,
            model_info=other_model.model_info,
            position=self.position,
            rotation=self.rotation,
            scale=other_model.scale,
            path_to_models=self.path_to_models,
        )
        model.label = self.label
        return model


class ThreedFutureExtra(BaseThreedFutureModel):
    """Walls / floors / doors meshes.  (threed_front_scene.py:423-448)"""

    def __init__(self, model_uid, model_jid, xyz, faces, model_type,
                 position, rotation, scale):
        super().__init__(model_uid, model_jid, position, rotation, scale)
        self.xyz = xyz
        self.faces = faces
        self.model_type = model_type

    def raw_model_transformed(self, offset=(0.0, 0.0, 0.0)):
        return self._transform(np.array(self.xyz)) + np.asarray(offset), np.array(self.faces)
