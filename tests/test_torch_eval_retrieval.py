"""The port's mesh half of data/raw.py, the nearest-furniture retrieval of
data/threed_future.py, eval/retrieval.py and eval/mesh_intersect.py
against the JAX package's on the CPU.

All of it is numpy copied from the JAX package, so the same inputs, made
from a seed, must give equal arrays, the same catalog jids, byte-equal
OBJ/MTL/PLY files and the same Möller booleans.  One departure is checked
as such: a scene with no objects merges to an empty mesh in the port, where
the JAX package's ``merge_meshes`` raises.
"""
import os
import pickle

import numpy as np
import pytest

from diffuscene_tpu.data import raw as jraw
from diffuscene_tpu.data.threed_future import ThreedFutureDataset as JDataset
from diffuscene_tpu.eval import mesh_intersect as jmi
from diffuscene_tpu.eval import retrieval as jret
from diffuscene_tpu_torch.data import make_synthetic_catalog
from diffuscene_tpu_torch.data import raw as praw
from diffuscene_tpu_torch.data.threed_future import ThreedFutureDataset
from diffuscene_tpu_torch.eval import mesh_intersect as pmi
from diffuscene_tpu_torch.eval import retrieval as pret

OBJ_MULTI = """mtllib m.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
f 1/1 2/2 3/3 4/4
usemtl wood
f -5/-4 -4/-3 -1/-1
usemtl cloth
f 1 2 5
usemtl wood
f 2/2 3/3 5/4
"""
MTL_MULTI = """newmtl wood
Kd 0.5 0.25 0.125
map_Kd wood.png
newmtl cloth
Kd 0.1 0.2 0.3
map_Kd missing.png
"""


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


def _equal_mesh(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray) or isinstance(b[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        elif isinstance(a[k], list):
            assert len(a[k]) == len(b[k])
            for ma, mb in zip(a[k], b[k]):
                assert ma["map_kd"] == mb["map_kd"]
                np.testing.assert_array_equal(ma["kd"], mb["kd"])
        else:
            assert a[k] == b[k], k


def test_obj_mtl_parse_equals_jax(tmp_path):
    """load_obj_mesh and load_obj_vertices_faces: a multi-material OBJ with
    quads, negative indices, faces without UVs and a missing texture; a
    plain OBJ beside a texture.png; a UV-less OBJ without an MTL."""
    from diffuscene_tpu_torch.eval.png import write_png

    write_png(str(tmp_path / "wood.png"), np.full((4, 4, 3), 99, np.uint8))
    _write(tmp_path / "m.mtl", MTL_MULTI)
    multi = _write(tmp_path / "multi.obj", OBJ_MULTI)
    plain_dir = tmp_path / "plain"
    plain_dir.mkdir()
    write_png(str(plain_dir / "texture.png"), np.zeros((2, 2, 3), np.uint8))
    plain = _write(plain_dir / "raw_model.obj", "v 0 0 0\nv 1 0 0\nv 0 0 1\nvt 0 0\nvt 1 0\n"
                   "vt 0 1\nf 1/1 2/2 3/3\n")
    bare = _write(tmp_path / "bare.obj", "v 0 0 0\nv 1 0 0\nv 0 0 1\nv 1 1 1\nf 1 2 3 4\n")
    for path in (multi, plain, bare):
        _equal_mesh(praw.load_obj_mesh(path), jraw.load_obj_mesh(path))
        for x, y in zip(praw.load_obj_vertices_faces(path), jraw.load_obj_vertices_faces(path)):
            np.testing.assert_array_equal(x, y)
    m = praw.load_obj_mesh(multi)
    assert m["texture_path"].endswith("wood.png") and m["face_materials"] is not None
    assert np.isnan(m["face_uvs"][3]).all()              # "f 1 2 5" has no vt


def _quat_y(theta):
    """The 3D-FRONT rotation quaternion (x, y, z, w) of a turn about +y."""
    return np.array([0.0, np.sin(theta / 2), 0.0, np.cos(theta / 2)])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_future_model_geometry_equals_jax(tmp_path, seed):
    """ThreedFutureModel's paths, raw and transformed mesh, bbox corners,
    centroid, size (and its setter), bottom centre, z angle and
    copy_from_other_model; ThreedFutureExtra's transformed mesh."""
    rng = np.random.default_rng(seed)
    root = str(tmp_path / "models")
    make_synthetic_catalog(root, ["bed"], per_label=1, seed=seed)
    jid = "synth-000-00"
    pos, rot, scale = rng.normal(0, 1, 3), _quat_y(rng.uniform(-3, 3)), rng.uniform(0.5, 2, 3)
    info = praw.Asset("bed", "bed", None, None, None)
    pm = praw.ThreedFutureModel("u", jid, info, pos, rot, scale, root)
    jm = jraw.ThreedFutureModel("u", jid, info, pos, rot, scale, root)
    for name in ("raw_model_path", "texture_image_path", "path_to_bbox_vertices",
                 "raw_model_norm_pc_lat32_path"):
        assert getattr(pm, name) == getattr(jm, name)
    off = rng.normal(0, 1, 3)
    for a, b in zip(pm.raw_model_transformed(off), jm.raw_model_transformed(off)):
        np.testing.assert_array_equal(a, b)
    for name in ("corners", "centroid", "bottom_center"):
        np.testing.assert_array_equal(getattr(pm, name)(off), getattr(jm, name)(off))
    np.testing.assert_array_equal(pm.size, jm.size)
    assert pm.z_angle == jm.z_angle and pm.label == jm.label == "bed"
    np.testing.assert_array_equal(pm.raw_model_norm_pc_lat32(), jm.raw_model_norm_pc_lat32())
    other = praw.ThreedFutureModel("u2", "other", praw.Asset("x", "x", None, None, None),
                                   pos * 2, rot, scale * 3, root)
    copied = pm.copy_from_other_model(other)
    assert (copied.model_jid, copied.label) == ("other", "bed")
    np.testing.assert_array_equal(copied.scale, other.scale)
    pm.size = [1.0, 2.0, 3.0]
    np.testing.assert_array_equal(pm.size, [1.0, 2.0, 3.0])
    xyz, faces = rng.normal(0, 1, (5, 3)), np.array([[0, 1, 2], [2, 3, 4]])
    pe = praw.ThreedFutureExtra("e", "e", xyz, faces, "Floor", pos, rot, scale)
    je = jraw.ThreedFutureExtra("e", "e", xyz, faces, "Floor", pos, rot, scale)
    for a, b in zip(pe.raw_model_transformed(), je.raw_model_transformed()):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    """A catalog of 4 labels x 5 textured boxes (the port's synthetic
    catalog), its pickle, and the labels."""
    root = str(tmp_path_factory.mktemp("catalog"))
    labels = ["bed", "chair", "desk", "lamp"]
    return make_synthetic_catalog(root, labels, per_label=5, seed=4), labels


def test_nearest_furniture_jids_equal_jax(catalog):
    """get_closest_furniture_to_box, _2dbox, _objfeats (32-d) and
    _objfeats_and_size pick the same jids as the JAX catalog over the same
    objects, for 200 random queries each; a catalog pickled by the JAX
    package loads in the port with the same sizes and answers."""
    path, labels = catalog
    ours = ThreedFutureDataset.from_pickled_dataset(path)
    theirs = JDataset(ours.objects)
    rng = np.random.default_rng(0)
    for _ in range(200):
        label = labels[int(rng.integers(len(labels)))]
        size, feat = rng.uniform(0.1, 1.0, 3), rng.normal(0, 1, 32)
        for method, args in (("get_closest_furniture_to_box", (size,)),
                             ("get_closest_furniture_to_2dbox", (size[[0, 2]],)),
                             ("get_closest_furniture_to_objfeats", (feat,)),
                             ("get_closest_furniture_to_objfeats_and_size", (feat, size))):
            a = getattr(ours, method)(label, *args)
            b = getattr(theirs, method)(label, *args)
            assert a.model_jid == b.model_jid, method
    # the JAX package's own classes, pickled by it, read by the port
    jobjs = []
    for o in ours.objects:
        m = jraw.ThreedFutureModel(o.model_uid, o.model_jid, o.model_info, o.position,
                                   o.rotation, o.scale, o.path_to_models)
        m.size
        jobjs.append(m)
    jpath = os.path.join(os.path.dirname(path), "jax_catalog.pkl")
    JDataset(jobjs).pickle(jpath)
    loaded = ThreedFutureDataset.from_pickled_dataset(jpath)
    assert type(loaded.objects[0]) is praw.ThreedFutureModel
    for a, b in zip(loaded.objects, ours.objects):
        np.testing.assert_array_equal(a.size, b.size)
    size = np.array([0.5, 0.5, 0.5])
    assert (loaded.get_closest_furniture_to_box("desk", size).model_jid
            == ours.get_closest_furniture_to_box("desk", size).model_jid)
    with open(path, "rb") as f:
        legacy = pickle.load(f)
    del legacy.__dict__["_by_label"]                    # a catalog pickled before the cache
    assert legacy.get_closest_furniture_to_box("bed", size).label == "bed"


def _scene_boxes(seed, labels, n=6, objfeats=False):
    rng = np.random.default_rng(seed)
    c = len(labels)
    out = {"class_labels": np.eye(c)[rng.integers(0, c, n)][None],
           "translations": rng.uniform(-2, 2, (1, n, 3)),
           "sizes": rng.uniform(0.1, 1.0, (1, n, 3)),
           "angles": rng.uniform(-3, 3, (1, n, 1))}
    if objfeats:
        out["objfeats"] = rng.normal(0, 1, (1, n, 32))
    return out


def _equal_scene_mesh(a, b):
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)
    assert (a.label, a.model_jid, a.texture_path) == (b.label, b.model_jid, b.texture_path)
    np.testing.assert_array_equal(a.face_uvs, b.face_uvs)
    np.testing.assert_array_equal(a.kd, b.kd)


def _tree(root):
    files = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                files[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return files


@pytest.mark.parametrize("seed", [0, 1])
def test_retrieval_floor_merge_and_exports_equal_jax(catalog, tmp_path, seed):
    """get_textured_objects, ..._based_on_objfeats (with and without size),
    floor_plan_from_scene (a cached record, with a floor texture drawn from
    a seeded rng), merge_meshes, write_obj, write_ply and export_scene: the
    same meshes and byte-equal files."""
    path, labels = catalog
    ours = ThreedFutureDataset.from_pickled_dataset(path)
    theirs = JDataset(ours.objects)
    boxes = _scene_boxes(seed, labels, objfeats=True)
    pairs = [(pret.get_textured_objects(boxes, ours, labels),
              jret.get_textured_objects(boxes, theirs, labels))]
    for combine in (True, False):
        pairs.append((pret.get_textured_objects_based_on_objfeats(boxes, ours, labels, combine),
                      jret.get_textured_objects_based_on_objfeats(boxes, theirs, labels,
                                                                  combine)))
    for a_list, b_list in pairs:
        assert len(a_list) == len(b_list) == 6
        for a, b in zip(a_list, b_list):
            _equal_scene_mesh(a, b)
    rng = np.random.default_rng(seed)
    room = {"floor_plan_vertices": rng.uniform(-3, 3, (6, 3)),
            "floor_plan_faces": np.array([[0, 1, 2], [2, 3, 4], [4, 5, 0]]),
            "floor_plan_centroid": rng.normal(0, 1, 3)}
    textures = [ours.objects[0].texture_image_path, ours.objects[1].texture_image_path]
    fa = pret.floor_plan_from_scene(room, textures, rng=np.random.default_rng(seed))
    fb = jret.floor_plan_from_scene(room, textures, rng=np.random.default_rng(seed))
    _equal_scene_mesh(fa, fb)
    _equal_scene_mesh(pret.floor_plan_from_scene(room), jret.floor_plan_from_scene(room))
    meshes_a, meshes_b = [fa] + pairs[0][0], [fb] + pairs[0][1]
    ma, mb = pret.merge_meshes(meshes_a), jret.merge_meshes(meshes_b)
    np.testing.assert_array_equal(ma.vertices, mb.vertices)
    np.testing.assert_array_equal(ma.faces, mb.faces)
    for pkg, mod, meshes, merged in (("port", pret, meshes_a, ma), ("jax", jret, meshes_b, mb)):
        out = tmp_path / pkg
        out.mkdir()
        mod.write_obj(merged, str(out / "scene.obj"))
        mod.write_ply(merged, str(out / "scene.ply"))
        mod.write_obj(meshes[1], str(out / "one.obj"))
        mod.export_scene(str(out / "objects"), meshes)
    a, b = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert a.keys() == b.keys() and len(a) > 10
    for k in a:
        assert a[k] == b[k], k


def test_merge_of_an_empty_scene(tmp_path):
    """An empty scene merges to an empty mesh and exports as files with no
    vertex (the JAX package's merge_meshes raises ValueError on it)."""
    m = pret.merge_meshes([])
    assert m.vertices.shape == (0, 3) and m.faces.shape == (0, 3)
    pret.write_obj(m, str(tmp_path / "e.obj"))
    pret.write_ply(m, str(tmp_path / "e.ply"))
    assert "element vertex 0" in (tmp_path / "e.ply").read_text()
    with pytest.raises(ValueError):
        jret.merge_meshes([])


def _degenerate_pairs():
    """Coplanar overlapping, coplanar disjoint, contained, shared edge,
    shared vertex, zero-area (collinear) and point-like triangles, each
    against several others."""
    t = [
        [[0, 0, 0], [1, 0, 0], [0, 1, 0]],
        [[0.2, 0.2, 0], [1.2, 0.2, 0], [0.2, 1.2, 0]],
        [[2, 2, 0], [3, 2, 0], [2, 3, 0]],
        [[0.1, 0.1, 0], [0.3, 0.1, 0], [0.1, 0.3, 0]],
        [[1, 0, 0], [0, 1, 0], [1, 1, 1]],
        [[0, 0, 0], [-1, 0, 1], [0, -1, 1]],
        [[0, 0, 0], [1, 1, 0], [2, 2, 0]],
        [[0.5, 0.5, 0], [0.5, 0.5, 0], [0.5, 0.5, 0]],
        [[0.25, 0.25, -1], [0.25, 0.25, 1], [0.3, 0.3, 0]],
        [[0, 0, 1e-12], [1, 0, 1e-12], [0, 1, 1e-12]],
    ]
    t = np.asarray(t, np.float64)
    i, j = np.meshgrid(np.arange(len(t)), np.arange(len(t)), indexing="ij")
    return t[i.ravel()], t[j.ravel()]


def test_moller_tri_tri_equals_jax():
    """tri_tri_intersect on 4000 random pairs (about a third hit), on
    every pair of ten degenerate triangles, and on a single pair: the same
    booleans as the JAX package."""
    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, (4000, 3, 3))
    b = rng.uniform(-1, 1, (4000, 3, 3)) + rng.uniform(-1, 1, (4000, 1, 3))
    got = pmi.tri_tri_intersect(a, b)
    np.testing.assert_array_equal(got, jmi.tri_tri_intersect(a, b))
    assert 0.1 < got.mean() < 0.9
    da, db = _degenerate_pairs()
    np.testing.assert_array_equal(pmi.tri_tri_intersect(da, db), jmi.tri_tri_intersect(da, db))
    assert pmi.tri_tri_intersect(a[0], b[0]).shape == (1,)


def _box_mesh(center, half):
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], np.float64)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = [f for a, b, c, d in quads for f in ([a, b, c], [a, c, d])]
    return v * half + center, np.asarray(faces, np.int64)


def test_mesh_pair_intersects_equals_jax():
    """mesh_pair_intersects over 60 random box pairs (crossing, nested,
    touching, apart; tuples, dicts and SceneMeshes), and make_pair_intersects
    over a scene: the same answers."""
    rng = np.random.default_rng(1)
    meshes = [_box_mesh(rng.uniform(-1, 1, 3), rng.uniform(0.1, 0.8, 3)) for _ in range(12)]
    meshes.append(_box_mesh(meshes[0][0].mean(0), np.full(3, 1e-3)))     # inside mesh 0
    v, f = meshes[1]
    meshes.append((v + [v[:, 0].max() - v[:, 0].min(), 0, 0], f))        # touching mesh 1
    hits = 0
    for i in range(len(meshes)):
        for j in range(i + 1, min(i + 6, len(meshes))):
            a, b = meshes[i], meshes[j]
            got = pmi.mesh_pair_intersects(a, b)
            assert got == jmi.mesh_pair_intersects(a, b)
            assert got == pmi.mesh_pair_intersects({"vertices": a[0], "faces": a[1]},
                                                   pret.SceneMesh(b[0], b[1], "x"))
            hits += got
    assert 0 < hits
    assert pmi.mesh_pair_intersects(meshes[0], meshes[12]) is False      # nested: no crossing
    ours, theirs = pmi.make_pair_intersects(meshes), jmi.make_pair_intersects(meshes)
    for i, j in [(0, 1), (1, 0), (2, 5), (1, 13), (13, 1)]:
        assert ours(i, j) == theirs(i, j)
