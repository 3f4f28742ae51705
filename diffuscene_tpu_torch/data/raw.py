"""Raw 3D-FRONT/3D-FUTURE parsing: the furniture records, the rooms and the
JSON walkers (numpy only, no trimesh).

Copy of ``diffuscene_tpu/data/raw.py`` (reference
``scene_synthesis/datasets/threed_front_scene.py:21-666`` and
``scene_synthesis/datasets/utils.py:12-198``), so the port does not import
the JAX package: the OBJ/MTL reader (``load_obj_vertices_faces``,
``load_obj_mesh``), ``Asset``, ``ModelInfo``, ``BaseThreedFutureModel``,
``ThreedFutureModel`` (paths, the cached point cloud and latents, the raw
and transformed mesh, bounding-box corners, size, centroid, z angle),
``ThreedFutureExtra``, ``Room`` (floor plan, centroid, bboxes, uid, the
room-mask path), ``parse_threed_front_scenes``,
``parse_threed_future_models`` and ``ThreedFront`` (bounds, class labels
and frequencies, ``count_furniture``, ``from_dataset_directory``).  The
parsed lists short-circuit through the same ``PATH_TO_SCENES`` /
``PATH_TO_3D_FUTURE_OBJECTS`` pickles; a pickle the JAX package wrote loads
through the catalog's unpickler (``data/threed_future.py``), which maps the
JAX package's classes to these copies.

Left out: ``Room.room_mask_rotated`` and ``Room.room_mask``, which read the
mask through Pillow (which the port does not depend on) and which no code of
either package calls; the cached pipeline reads ``boxes.npz``'s
``room_layout`` instead (``data/threed_front.py``).
"""
from __future__ import annotations

import json
import os
import pickle
from collections import Counter
from dataclasses import dataclass
from functools import reduce
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


class ModelInfo:
    """All 3D-FUTURE model metadata, keyed by model id.
    (threed_front_scene.py:47-131)"""

    def __init__(self, model_info_data: List[Dict]):
        self.model_info_data = model_info_data
        self._model_info: Optional[Dict[str, Asset]] = None
        self._styles, self._themes = [], []
        self._categories, self._super_categories, self._materials = [], [], []

    @property
    def model_info(self) -> Dict[str, Asset]:
        if self._model_info is None:
            self._model_info = {}
            for m in self.model_info_data:
                for key, store in [("style", self._styles), ("theme", self._themes),
                                   ("super-category", self._super_categories),
                                   ("category", self._categories),
                                   ("material", self._materials)]:
                    if m.get(key) is not None and m[key] not in store:
                        store.append(m[key])
                super_cat = (m["super-category"].lower().replace(" / ", "/")
                             if m.get("super-category") else "unknown_super-category")
                cat = (m["category"].lower().replace(" / ", "/")
                       if m.get("category") else "unknown_category")
                self._model_info[m["model_id"]] = Asset(
                    super_cat, cat, m.get("style"), m.get("theme"), m.get("material")
                )
        return self._model_info

    @property
    def categories(self):
        return set(s.lower().replace(" / ", "/") for s in self._categories)

    @property
    def super_categories(self):
        return set(s.lower().replace(" / ", "/") for s in self._super_categories)

    @classmethod
    def from_file(cls, path: str) -> "ModelInfo":
        with open(path, "rb") as f:
            return cls(json.load(f))


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
    def bottom_size(self):
        return self.size * [1, 2, 1]

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

    def one_hot_label(self, all_labels):
        return np.eye(len(all_labels))[self.int_label(all_labels)]

    def int_label(self, all_labels):
        return all_labels.index(self.label)

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


class Room:
    """A parsed 3D-FRONT room.  (threed_front_scene.py:451-666)"""

    def __init__(self, scene_id, scene_type, bboxes, extras, json_path,
                 path_to_room_masks_dir=None):
        self.scene_id = scene_id
        self.scene_type = scene_type
        self.bboxes = bboxes
        self.extras = extras
        self.json_path = json_path
        self.uid = "_".join([json_path, scene_id])
        self.path_to_room_masks_dir = path_to_room_masks_dir
        self.path_to_room_mask = (
            os.path.join(path_to_room_masks_dir, self.uid, "room_mask.png")
            if path_to_room_masks_dir is not None else None
        )

    def __len__(self):
        return len(self.bboxes)

    @property
    def floor(self):
        return [e for e in self.extras if e.model_type == "Floor"][0]

    @property
    def bbox(self):
        corners = np.vstack([f.corners() for f in self.bboxes])
        return np.min(corners, axis=0), np.max(corners, axis=0)

    @property
    def bboxes_centroid(self):
        a, b = self.bbox
        return (a + b) / 2

    @property
    def furniture_in_room(self):
        return [f.label for f in self.bboxes]

    @property
    def count_furniture_in_room(self):
        return Counter(self.furniture_in_room)

    @property
    def floor_plan(self):
        """Concatenated floor meshes (vertices, faces).
        (threed_front_scene.py:491-505)"""
        def cat_mesh(m1, m2):
            v1, f1 = m1
            v2, f2 = m2
            return np.vstack([v1, v2]), np.vstack([f1, f2 + len(v1)])

        vertices, faces = reduce(
            cat_mesh,
            ((e.xyz, e.faces) for e in self.extras if e.model_type == "Floor"),
        )
        return np.copy(vertices), np.copy(faces)

    @property
    def floor_plan_bbox(self):
        v, _ = self.floor_plan
        return np.min(v, axis=0), np.max(v, axis=0)

    @property
    def floor_plan_centroid(self):
        a, b = self.floor_plan_bbox
        return (a + b) / 2

    @property
    def centroid(self):
        return self.floor_plan_centroid

    def category_counts(self, class_labels):
        if "start" in class_labels and "end" in class_labels:
            class_labels = class_labels[:-2]
        counts = [0] * len(class_labels)
        for label in self.furniture_in_room:
            counts[class_labels.index(label)] += 1
        return counts

    def ordered_bboxes_with_centroid(self):
        centroids = np.array([f.centroid(-self.centroid) for f in self.bboxes])
        ordering = np.lexsort(centroids.T)
        return [self.bboxes[i] for i in ordering]

    def ordered_bboxes_with_class_labels(self, all_labels):
        centroids = np.array([f.centroid(-self.centroid) for f in self.bboxes])
        int_labels = np.array([[f.int_label(all_labels)] for f in self.bboxes])
        ordering = np.lexsort(np.hstack([centroids, int_labels]).T)
        return [self.bboxes[i] for i in ordering]

    def ordered_bboxes_with_class_frequencies(self, class_order):
        centroids = np.array([f.centroid(-self.centroid) for f in self.bboxes])
        label_order = np.array([[class_order[f.label]] for f in self.bboxes])
        ordering = np.lexsort(np.hstack([centroids, label_order]).T)
        return [self.bboxes[i] for i in ordering[::-1]]

    def augment_room(self, objects_dataset, rng: Optional[np.random.Generator] = None):
        """Swap one random object for its nearest-by-size catalog neighbor.
        (threed_front_scene.py:639-666)"""
        rng = rng or np.random.default_rng()
        bi = self.bboxes[int(rng.integers(len(self.bboxes)))]
        furniture = objects_dataset.get_closest_furniture_to_box(
            bi.label, bi.size + rng.normal(0, 0.02)
        )
        new_bboxes = [b for b in self.bboxes if b is not bi] + [bi.copy_from_other_model(furniture)]
        return Room(
            scene_id=self.scene_id + "_augm",
            scene_type=self.scene_type,
            bboxes=new_bboxes,
            extras=self.extras,
            json_path=self.json_path,
            path_to_room_masks_dir=self.path_to_room_masks_dir,
        )


# ---------------------------------------------------------------------------
# dataset walkers (scene_synthesis/datasets/utils.py:12-198)
# ---------------------------------------------------------------------------

def _load_pickle(path: str):
    """A pickled list of parsed records, written by this package or the JAX
    one.  Unpickle only files you made."""
    from .threed_future import _PortUnpickler

    with open(path, "rb") as f:
        return _PortUnpickler(f).load()


def _valid_scale(scale) -> bool:
    return not (any(s < 1e-5 for s in scale) or any(s > 5 for s in scale))


def parse_threed_front_scenes(dataset_directory, path_to_model_info,
                              path_to_models, path_to_room_masks_dir=None,
                              pickle_output: Optional[str] = None) -> List[Room]:
    if os.getenv("PATH_TO_SCENES"):
        return _load_pickle(os.environ["PATH_TO_SCENES"])

    model_info = ModelInfo.from_file(path_to_model_info).model_info
    layouts = [
        os.path.join(dataset_directory, f)
        for f in sorted(os.listdir(dataset_directory)) if f.endswith(".json")
    ]
    scenes: List[Room] = []
    unique_room_ids = set()
    for m in layouts:
        with open(m) as f:
            data = json.load(f)
        furniture_in_scene = {}
        for ff in data["furniture"]:
            if ff.get("valid") and ff["jid"] in model_info:
                furniture_in_scene[ff["uid"]] = dict(
                    model_uid=ff["uid"], model_jid=ff["jid"],
                    model_info=model_info[ff["jid"]],
                )
        meshes_in_scene = {
            mm["uid"]: dict(
                mesh_uid=mm["uid"], mesh_jid=mm["jid"],
                mesh_xyz=np.asarray(mm["xyz"]).reshape(-1, 3),
                mesh_faces=np.asarray(mm["faces"]).reshape(-1, 3),
                mesh_type=mm["type"],
            )
            for mm in data["mesh"]
        }
        for rr in data["scene"]["room"]:
            furniture_in_room, extras = [], []
            is_valid_scene = True
            for cc in rr["children"]:
                if cc["ref"] in furniture_in_scene:
                    if not _valid_scale(cc["scale"]):
                        is_valid_scene = False
                        break
                    tf = furniture_in_scene[cc["ref"]]
                    furniture_in_room.append(ThreedFutureModel(
                        tf["model_uid"], tf["model_jid"], tf["model_info"],
                        cc["pos"], cc["rot"], cc["scale"], path_to_models,
                    ))
                elif cc["ref"] in meshes_in_scene:
                    mf = meshes_in_scene[cc["ref"]]
                    extras.append(ThreedFutureExtra(
                        mf["mesh_uid"], mf["mesh_jid"], mf["mesh_xyz"],
                        mf["mesh_faces"], mf["mesh_type"],
                        cc["pos"], cc["rot"], cc["scale"],
                    ))
            if len(furniture_in_room) > 1 and is_valid_scene \
                    and rr["instanceid"] not in unique_room_ids:
                unique_room_ids.add(rr["instanceid"])
                scenes.append(Room(
                    rr["instanceid"], rr["type"].lower(), furniture_in_room,
                    extras, os.path.basename(m).split(".")[0], path_to_room_masks_dir,
                ))
    if pickle_output:
        with open(pickle_output, "wb") as f:
            pickle.dump(scenes, f)
    return scenes


def parse_threed_future_models(dataset_directory, path_to_models,
                               path_to_model_info,
                               pickle_output: Optional[str] = None) -> List[ThreedFutureModel]:
    if os.getenv("PATH_TO_3D_FUTURE_OBJECTS"):
        return _load_pickle(os.environ["PATH_TO_3D_FUTURE_OBJECTS"])

    model_info = ModelInfo.from_file(path_to_model_info).model_info
    layouts = [
        os.path.join(dataset_directory, f)
        for f in sorted(os.listdir(dataset_directory)) if f.endswith(".json")
    ]
    furnitures: List[ThreedFutureModel] = []
    unique_ids = set()
    for m in layouts:
        with open(m) as f:
            data = json.load(f)
        furniture_in_scene = {
            ff["uid"]: dict(model_uid=ff["uid"], model_jid=ff["jid"],
                            model_info=model_info[ff["jid"]])
            for ff in data["furniture"] if ff.get("valid") and ff["jid"] in model_info
        }
        for rr in data["scene"]["room"]:
            for cc in rr["children"]:
                if cc["ref"] not in furniture_in_scene:
                    continue
                if not _valid_scale(cc["scale"]):
                    break
                tf = furniture_in_scene[cc["ref"]]
                if tf["model_uid"] not in unique_ids:
                    unique_ids.add(tf["model_uid"])
                    furnitures.append(ThreedFutureModel(
                        tf["model_uid"], tf["model_jid"], tf["model_info"],
                        cc["pos"], cc["rot"], cc["scale"], path_to_models,
                    ))
    if pickle_output:
        with open(pickle_output, "wb") as f:
            pickle.dump(furnitures, f)
    return furnitures


class ThreedFront:
    """Container over parsed Rooms with dataset-level bounds/statistics.

    (threed_front.py:16-216).  Bounds are computed over room-centered object
    centroids, sizes, z-angles, and the latent objfeats of every object.
    """

    def __init__(self, scenes: List[Room], bounds: Optional[Dict] = None):
        assert len(scenes) > 0
        self.scenes = scenes
        self._object_types = None
        self._count_furniture = None
        self._sizes = self._centroids = self._angles = None
        self._objfeats = self._objfeats_32 = None
        if bounds is not None:
            self._centroids = bounds["translations"]
            self._sizes = bounds["sizes"]
            self._angles = bounds["angles"]
            self._objfeats = bounds.get(
                "objfeats", (np.array([1]), np.array([-1]), np.array([1])))
            self._objfeats_32 = bounds.get(
                "objfeats_32", (np.array([1]), np.array([-1]), np.array([1])))

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, i):
        return self.scenes[i]

    def _compute_bounds(self):
        c_min, c_max = np.full(3, np.inf), np.full(3, -np.inf)
        s_min, s_max = np.full(3, np.inf), np.full(3, -np.inf)
        a_min, a_max = np.inf, -np.inf
        feats, feats32 = [], []
        for s in self.scenes:
            for f in s.bboxes:
                centroid = f.centroid(-s.centroid)
                c_min, c_max = np.minimum(centroid, c_min), np.maximum(centroid, c_max)
                s_min, s_max = np.minimum(f.size, s_min), np.maximum(f.size, s_max)
                a_min, a_max = min(f.z_angle, a_min), max(f.z_angle, a_max)
                try:
                    feats.append(f.raw_model_norm_pc_lat())
                except (FileNotFoundError, OSError):
                    pass
                try:
                    feats32.append(f.raw_model_norm_pc_lat32())
                except (FileNotFoundError, OSError):
                    pass
        self._centroids = (c_min, c_max)
        self._sizes = (s_min, s_max)
        self._angles = (np.array([a_min]), np.array([a_max]))
        for attr, arr in [("_objfeats", feats), ("_objfeats_32", feats32)]:
            if arr:
                a = np.stack(arr, axis=0)
                setattr(self, attr, (np.array([a.flatten().std()]),
                                     np.array([a.min()]), np.array([a.max()])))
            else:
                setattr(self, attr, (np.array([1]), np.array([-1]), np.array([1])))

    @property
    def bounds(self) -> Dict:
        return {
            "translations": self.centroids,
            "sizes": self.sizes,
            "angles": self.angles,
            "objfeats": self.objfeats,
            "objfeats_32": self.objfeats_32,
        }

    @property
    def centroids(self):
        if self._centroids is None:
            self._compute_bounds()
        return self._centroids

    @property
    def sizes(self):
        if self._sizes is None:
            self._compute_bounds()
        return self._sizes

    @property
    def angles(self):
        if self._angles is None:
            self._compute_bounds()
        return self._angles

    @property
    def objfeats(self):
        if self._objfeats is None:
            self._compute_bounds()
        return self._objfeats

    @property
    def objfeats_32(self):
        if self._objfeats_32 is None:
            self._compute_bounds()
        return self._objfeats_32

    @property
    def count_furniture(self):
        if self._count_furniture is None:
            counts = Counter(sum((s.furniture_in_room for s in self.scenes), []))
            self._count_furniture = dict(sorted(counts.items(), key=lambda x: -x[1]))
        return self._count_furniture

    @property
    def class_order(self):
        return dict(zip(self.count_furniture.keys(), range(len(self.count_furniture))))

    @property
    def class_frequencies(self):
        counts = self.count_furniture
        total = sum(counts.values())
        return {k: v / total for k, v in counts.items()}

    @property
    def object_types(self):
        if self._object_types is None:
            types = set()
            for s in self.scenes:
                types |= set(b.label for b in s.bboxes)
            self._object_types = sorted(types)
        return self._object_types

    @property
    def room_types(self):
        return set(s.scene_type for s in self.scenes)

    @property
    def class_labels(self):
        return self.object_types + ["start", "end"]

    @property
    def max_length(self) -> int:
        """(threed_front.py:204-216)"""
        room_types = set(str(s.scene_type) for s in self.scenes)
        if any("bed" in r for r in room_types):
            return 12
        if any("living" in r for r in room_types):
            return 21
        if any("dining" in r for r in room_types):
            return 21
        if any("library" in r for r in room_types):
            return 11
        return 12

    @classmethod
    def from_dataset_directory(cls, dataset_directory, path_to_model_info,
                               path_to_models, path_to_room_masks_dir=None,
                               path_to_bounds=None, filter_fn=lambda s: s):
        scenes = parse_threed_front_scenes(
            dataset_directory, path_to_model_info, path_to_models,
            path_to_room_masks_dir,
        )
        bounds = None
        if path_to_bounds:
            bounds = np.load(path_to_bounds, allow_pickle=True)
        return cls([s for s in map(filter_fn, scenes) if s], bounds)
