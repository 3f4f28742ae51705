"""The port's raw-data pipeline against the JAX package's, on one raw
3D-FRONT / 3D-FUTURE tree that ``make_synthetic_raw_front`` writes (12
bedrooms of rectangles and L shapes, 3-12 textured boxes each, and one room
with a furniture scale out of range): the parsers, ``Room`` floor plans and
``ThreedFront``'s bounds, labels and frequencies; ``preprocess_data``
(``boxes.npz`` bit for bit, ``room_mask.png`` pixels, ``dataset_stats.txt``);
the two pickle CLIs (the records, the clouds from one seed, the lst files);
the room mask's resize without Pillow; then the train and generate CLIs on a
room-mask config over the preprocessed rooms, port against JAX, with
``--fix_order`` and ``--scene_id``: the same masks reach both models and,
on the same weights and the JAX noise stream, the samples agree within
1e-4 (tests/test_torch_tasks.py's sample tolerance).
"""
import json
import os
import pickle
import shutil
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from diffuscene_tpu.cli import pickle_threed_future_dataset as j_pickle_dataset
from diffuscene_tpu.cli import pickle_threed_future_pointcloud as j_pickle_pointcloud
from diffuscene_tpu.cli import preprocess_data as j_preprocess
from diffuscene_tpu.data import raw as jraw
from diffuscene_tpu_torch.cli import pickle_threed_future_dataset as t_pickle_dataset
from diffuscene_tpu_torch.cli import pickle_threed_future_pointcloud as t_pickle_pointcloud
from diffuscene_tpu_torch.cli import preprocess_data as t_preprocess
from diffuscene_tpu_torch.data import make_synthetic_raw_front
from diffuscene_tpu_torch.data import raw as traw
from diffuscene_tpu_torch.data.threed_front import CachedThreedFront
from diffuscene_tpu_torch.data.threed_future import ThreedFutureDataset
from diffuscene_tpu_torch.eval.png import read_png

from test_torch_tasks import _ddpm_stream, _replay
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


N_ROOMS = 12
ENCODING = "cached_diffusion_cosin_angle_objfeatsnorm_lat32_wocm"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The raw tree, latents for every model (as generate_objautoencoder
    writes them), and the port's preprocess_data --add_objfeats output."""
    root = tmp_path_factory.mktemp("rawfront")
    paths = make_synthetic_raw_front(str(root / "raw"), n_rooms=N_ROOMS, seed=0)
    rng = np.random.default_rng(1)
    for jid in sorted(os.listdir(paths["future"])):
        d = os.path.join(paths["future"], jid)
        if os.path.isdir(d):
            for name, dim in (("lat", 64), ("lat32", 32)):
                np.savez(os.path.join(d, f"raw_model_norm_pc_{name}.npz"),
                         latent=rng.normal(size=dim).astype(np.float32))
    paths["cached"] = str(root / "cached_port")
    t_preprocess.main(_preprocess_argv(paths, paths["cached"]))
    return paths


def _preprocess_argv(paths, out):
    return [out, paths["front"], paths["future"], paths["model_info"],
            "--annotation_file", paths["splits"], "--add_objfeats"]


def _rooms(pkg, paths):
    return pkg.parse_threed_front_scenes(paths["front"], paths["model_info"], paths["future"])


def test_parsers_and_threed_front_match_jax(tree):
    """parse_threed_front_scenes and parse_threed_future_models of both
    packages: the same rooms (the out-of-range room dropped), uids, types,
    floor plans, centroids, and each object's jid, label, size, centroid
    and z angle; ThreedFront's bounds, labels, frequencies and counts, raw
    and through the bedroom filter, equal."""
    rooms_j, rooms_t = _rooms(jraw, tree), _rooms(traw, tree)
    assert len(rooms_t) == len(rooms_j) == N_ROOMS
    assert not any("bad" in r.uid for r in rooms_t)
    for rj, rt in zip(rooms_j, rooms_t):
        assert (rt.uid, rt.scene_type, len(rt)) == (rj.uid, rj.scene_type, len(rj))
        for a, b in zip(rt.floor_plan, rj.floor_plan):
            assert np.array_equal(a, b)
        assert np.array_equal(rt.floor_plan_centroid, rj.floor_plan_centroid)
        assert np.array_equal(rt.bboxes_centroid, rj.bboxes_centroid)
        for ot, oj in zip(rt.bboxes, rj.bboxes):
            assert (ot.model_jid, ot.label, ot.z_angle) == (oj.model_jid, oj.label, oj.z_angle)
            assert np.array_equal(ot.size, oj.size)
            assert np.array_equal(ot.centroid(-rt.centroid), oj.centroid(-rj.centroid))
    models_j = jraw.parse_threed_future_models(tree["front"], tree["future"], tree["model_info"])
    models_t = traw.parse_threed_future_models(tree["front"], tree["future"], tree["model_info"])
    assert [(m.model_uid, m.model_jid, m.label) for m in models_t] == \
        [(m.model_uid, m.model_jid, m.label) for m in models_j]

    from diffuscene_tpu.data.filters import filter_function as j_filter
    from diffuscene_tpu_torch.data.filters import filter_function as t_filter

    cfg = {"filter_fn": "threed_front_bedroom", "annotation_file": tree["splits"]}
    for split in (None, ["train", "val"]):
        if split is None:
            dj, dt = jraw.ThreedFront(rooms_j), traw.ThreedFront(rooms_t)
        else:
            dj, dt = (pkg.ThreedFront.from_dataset_directory(
                tree["front"], tree["model_info"], tree["future"], filter_fn=f(cfg, split))
                for pkg, f in ((jraw, j_filter), (traw, t_filter)))
        assert len(dt) == len(dj)
        for k, v in dj.bounds.items():
            for a, b in zip(dt.bounds[k], v):
                assert np.array_equal(np.asarray(a), np.asarray(b)), k
        assert dt.class_labels == dj.class_labels and dt.object_types == dj.object_types
        assert dt.class_frequencies == dj.class_frequencies
        assert dt.count_furniture == dj.count_furniture and dt.class_order == dj.class_order
        assert dt.max_length == dj.max_length == 12
    assert len(dt) == int(0.9 * N_ROOMS)


def test_jax_pickled_rooms_load_as_the_ports(tree, tmp_path, monkeypatch):
    """The JAX parser's PATH_TO_SCENES pickle of Rooms (ModelInfo's assets,
    ThreedFutureModel, ThreedFutureExtra inside) loads through the port's
    parser as the port's classes, the same rooms."""
    path = str(tmp_path / "scenes.pkl")
    rooms_j = jraw.parse_threed_front_scenes(tree["front"], tree["model_info"], tree["future"],
                                             pickle_output=path)
    monkeypatch.setenv("PATH_TO_SCENES", path)
    rooms = traw.parse_threed_front_scenes("unused", "unused", "unused")
    assert [type(r) for r in rooms] == [traw.Room] * len(rooms_j)
    assert type(rooms[0].bboxes[0]) is traw.ThreedFutureModel
    assert type(rooms[0].extras[0]) is traw.ThreedFutureExtra
    assert [r.uid for r in rooms] == [r.uid for r in rooms_j]
    for a, b in zip(rooms[0].floor_plan, rooms_j[0].floor_plan):
        assert np.array_equal(a, b)


def test_preprocess_matches_jax(tree, tmp_path):
    """preprocess_data --add_objfeats of both packages on the tree: the
    same room directories (every valid room, the out-of-range one
    dropped), boxes.npz arrays bit for bit with their dtypes, room_mask.png
    pixels equal, a render beside each, dataset_stats.txt equal; every
    room's 64x64 mask from CachedThreedFront is non-empty."""
    out_j = str(tmp_path / "cached_jax")
    j_preprocess.main(_preprocess_argv(tree, out_j))
    out_t = tree["cached"]
    dirs = sorted(d for d in os.listdir(out_t) if os.path.isdir(os.path.join(out_t, d)))
    assert dirs == sorted(d for d in os.listdir(out_j) if os.path.isdir(os.path.join(out_j, d)))
    assert len(dirs) == N_ROOMS and not any("bad" in d for d in dirs)
    for d in dirs:
        a, b = (np.load(os.path.join(o, d, "boxes.npz")) for o in (out_t, out_j))
        assert sorted(a.files) == sorted(b.files)
        assert {"room_layout", "floor_plan_vertices", "objfeats", "objfeats_32"} <= set(a.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (d, k)
        mt, mj = (read_png(os.path.join(o, d, "room_mask.png")) for o in (out_t, out_j))
        assert mt.shape == (512, 512, 3) and np.array_equal(mt, mj)
        assert np.array_equal(mt[:, :, 0], a["room_layout"][:, :, 0])
        assert os.path.isfile(os.path.join(out_t, d, "rendered_scene_256.png"))
    with open(os.path.join(out_t, "dataset_stats.txt")) as f, \
            open(os.path.join(out_j, "dataset_stats.txt")) as g:
        assert f.read() == g.read()
    ds = CachedThreedFront(out_t, {"room_layout_size": "64,64"},
                           [d.split("_")[1] for d in dirs])
    masks = np.stack([ds[i]["room_layout"] for i in range(len(ds))])
    assert masks.shape == (N_ROOMS, 1, 64, 64) and (masks.reshape(N_ROOMS, -1).max(1) > 0).all()


def test_room_layout_resize_without_pillow(tree, monkeypatch):
    """The cached dataset's 512 -> 64 mask resize with Pillow blocked
    equals its result with Pillow importable, and is within one level
    (1/255) of Pillow's BILINEAR on at most 0.5% of the pixels, on the masks
    render_room_mask drew (a nearest-neighbour fallback differs on every
    edge pixel); their sums in levels are chip_smoke.py's pinned ones."""
    from PIL import Image

    ds = CachedThreedFront(tree["cached"], {"room_layout_size": "64,64"}, [])
    dirs = sorted(d for d in os.listdir(tree["cached"])
                  if os.path.isdir(os.path.join(tree["cached"], d)))
    masks = [np.load(os.path.join(tree["cached"], d, "boxes.npz"))["room_layout"] for d in dirs]
    with_pil = [ds._room_layout(m) for m in masks]
    pil = [np.asarray(Image.fromarray(m[:, :, 0]).resize((64, 64), Image.BILINEAR))
           .astype(np.float32) / np.float32(255) for m in masks]
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    without = [ds._room_layout(m) for m in masks]
    diff = np.abs(np.stack(without) - np.stack(pil))
    for a, b in zip(without, with_pil):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    assert diff.max() <= 1 / 255 + 1e-7 and (diff > 0).mean() <= 5e-3
    assert all(0 < (p > 0).mean() < 1 for p in pil)       # edges to resize
    # the same rooms' masks, summed in levels, are what chip_smoke.py's
    # phase 19 holds the card's run to
    import chip_smoke

    levels = [int(round(float(m.astype(np.float64).sum() * 255))) for m in without]
    assert tuple(levels) == chip_smoke.DATA_MASK_LEVELS


def _load_catalog_jax(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_pickle_clis_match_jax(tree, tmp_path):
    """pickle_threed_future_dataset: the same catalog records (jids,
    labels, sizes), the JAX pickle readable by the port.
    pickle_threed_future_pointcloud with --annotation_file and without it,
    one seed, 128 points: the same raw_model_norm_pc.npz arrays, PLY bytes
    and lst files."""
    args = [tree["front"], tree["future"], tree["model_info"]]
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    j_pickle_dataset.main([out_j, *args, "--annotation_file", tree["splits"]])
    t_pickle_dataset.main([out_t, *args, "--annotation_file", tree["splits"]])
    name = "threed_future_model_bedroom.pkl"
    cj = _load_catalog_jax(os.path.join(out_j, name))
    ct = ThreedFutureDataset.from_pickled_dataset(os.path.join(out_t, name))
    cjt = ThreedFutureDataset.from_pickled_dataset(os.path.join(out_j, name))
    assert len(ct) == len(cj) == len(cjt) > 0
    for ot, oj, ojt in zip(ct.objects, cj.objects, cjt.objects):
        assert ot.model_jid == oj.model_jid == ojt.model_jid and ot.label == oj.label
        assert np.array_equal(ot.size, oj.size) and np.array_equal(ojt.size, oj.size)

    def clouds():
        found = {}
        for jid in sorted(os.listdir(tree["future"])):
            p = os.path.join(tree["future"], jid, "raw_model_norm_pc.npz")
            if os.path.isfile(p):
                with np.load(p) as z:
                    found[jid] = {k: z[k] for k in z.files}
                os.remove(p)
        return found

    def files(out):
        got = {}
        for dirpath, _, names in os.walk(out):
            for n in names:
                if n.endswith((".lst", ".ply")):
                    with open(os.path.join(dirpath, n), "rb") as f:
                        got[os.path.relpath(os.path.join(dirpath, n), out)] = f.read()
        return got

    for mode in (["--annotation_file", tree["splits"]], ["--export_ply"]):
        runs = []
        for cli, out in ((t_pickle_pointcloud, out_t), (j_pickle_pointcloud, out_j)):
            shutil.rmtree(out)
            cli.main([out, *args, "--pointcloud_size", "128", "--seed", "3", *mode])
            runs.append((clouds(), files(out)))
        (pt, ft), (pj, fj) = runs
        assert pt.keys() == pj.keys() and len(pt) > 0
        for jid in pj:
            for k in pj[jid]:
                assert np.array_equal(pt[jid][k], pj[jid][k]), (jid, k)
        assert ft == fj and any(k.endswith(".lst") for k in ft)


def _reference_state_dict(state):
    """A port scene state_dict as a reference DiffusionSceneLayout_DDPM
    checkpoint (the JAX CLI's --weight_file .pt): the denoiser under
    diffusion.model., the heads at the top, the extractor under
    feature_extractor._feature_extractor. with the freeze's eps baked into
    running_var."""
    out = {}
    for k, v in state.items():
        v = v.detach().cpu().float()
        if k.startswith("denoiser."):
            out["diffusion.model." + k[len("denoiser."):]] = v
        elif k.startswith("conditioner."):
            out[k[len("conditioner."):]] = v
        else:
            sub = k[len("feature_extractor."):]
            out["feature_extractor._feature_extractor." + sub] = \
                v + 1e-5 if sub.endswith("running_var") else v
    return out


def _room_mask_config(tree, root):
    nk = {"dim": 32, "dim_mults": [1, 1], "channels": 62, "objectness_dim": 0,
          "class_dim": 22, "angle_dim": 2, "objfeat_dim": 32, "context_dim": 64,
          "instanclass_dim": 16, "seperate_all": True}
    data = {"dataset_type": "cached_threedfront", "encoding_type": ENCODING,
            "dataset_directory": tree["cached"], "annotation_file": tree["splits"],
            "augmentations": ["fixed_rotations"], "filter_fn": "threed_front_bedroom",
            "train_stats": "dataset_stats.txt", "room_layout_size": "64,64",
            "max_length": 12}
    cfg = {
        "data": data,
        "network": {"type": "diffusion_scene_layout_ddpm", "net_type": "unet1d",
                    "point_dim": 62, "latent_dim": 64, "room_mask_condition": True,
                    "sample_num_points": 12, "objectness_dim": 0, "class_dim": 22,
                    "angle_dim": 2, "objfeat_dim": 32, "learnable_embedding": True,
                    "instance_condition": True, "instance_emb_dim": 16,
                    "diffusion_kwargs": {"schedule_type": "linear", "time_num": 8,
                                         "model_mean_type": "v",
                                         "model_var_type": "fixedsmall",
                                         "loss_separate": True, "loss_iou": True},
                    "net_kwargs": nk},
        "feature_extractor": {"name": "resnet18", "feature_size": 64, "freeze_bn": True,
                              "input_channels": 1},
        "training": {"splits": ["train"], "epochs": 2, "batch_size": 4,
                     "save_frequency": 1, "max_grad_norm": 10, "optimizer": "Adam",
                     "schedule": "step", "lr": 2e-4, "lr_step": 10000, "lr_decay": 0.5,
                     "ema_decay": 0.9},
        "validation": {"splits": ["val", "test"], "frequency": 1, "batch_size": 2},
        "logger": {"type": "stats"},
    }
    path = str(root / "room_mask.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def test_room_mask_train_then_generate_cli_matches_jax(tree, tmp_path, monkeypatch):
    """train_diffusion (2 epochs) on a room-mask config over the
    preprocessed rooms: each batch's room_layout reaches get_loss, the
    checkpoint holds the extractor and its frozen statistics unchanged.
    Then generate_diffusion of both packages on its EMA weights (the JAX
    CLI reads them as a reference .pt), --fix_order and --scene_id: the
    (B, 1, 64, 64) masks that reach the two models are the same (within
    one level: Pillow's resize in the JAX package's data pipeline, the
    port's own here), those of the eval scenes in the CLI's order (rotated
    with the scenes, as the eval set keeps the config's augmentations), one
    scene's under --scene_id; with the JAX noise stream replayed the
    samples agree within 1e-4."""
    from diffuscene_tpu.cli.generate_diffusion import main as j_gen
    from diffuscene_tpu.eval import postprocess as jpost
    from diffuscene_tpu.models.scene_model import SceneDiffusion as JSceneDiffusion
    from diffuscene_tpu_torch.cli.generate_diffusion import main as t_gen
    from diffuscene_tpu_torch.cli.train_diffusion import main as t_train
    from diffuscene_tpu_torch.eval import postprocess as tpost
    from diffuscene_tpu_torch.models.scene_model import SceneDiffusion
    from diffuscene_tpu_torch.utils.checkpoint import load_checkpoint

    cfg = _room_mask_config(tree, tmp_path)
    seen = []
    get_loss = SceneDiffusion.get_loss

    def spy_loss(self, batch, *a, **k):
        seen.append(tuple(batch["room_layout"].shape))
        return get_loss(self, batch, *a, **k)

    monkeypatch.setattr(SceneDiffusion, "get_loss", spy_loss)
    out = str(tmp_path / "out")
    t_train([cfg, out, "--experiment_tag", "rm", "--seed", "0", "--device", "cpu"])
    monkeypatch.setattr(SceneDiffusion, "get_loss", get_loss)
    state, epoch = load_checkpoint(os.path.join(out, "rm"))
    assert epoch == 1 and seen and all(s[1:] == (1, 64, 64) for s in seen)
    ema = state["ema"]
    assert ema["feature_extractor.layer4.1.bn2.running_var"].eq(1.0).all()
    assert set(ema) == set(state["model"])
    pt = str(tmp_path / "rm.pt")
    torch.save(_reference_state_dict(ema), pt)

    n, bsz, seed, steps = 5, 4, 2, 8
    record = {"t": [], "j": [], "ts": [], "js": []}
    t_sample = SceneDiffusion.sample
    keys = [jax.random.PRNGKey(seed)]

    def port_sample(self, batch_size, generator=None, **kw):
        record["t"].append(kw["room_layout"].numpy().copy())
        keys[0], sub = jax.random.split(keys[0])
        noises = _ddpm_stream(sub, (batch_size, 12, 62), steps)
        return t_sample(self, batch_size, noise_fn=_replay(noises), **kw)

    j_sample = JSceneDiffusion.sample

    def jax_sample(self, params, key, batch_size, room_layout=None, **kw):
        jax.debug.callback(lambda rl: record["j"].append(np.asarray(rl)), room_layout)
        return j_sample(self, params, key, batch_size, room_layout=room_layout, **kw)

    def recorder(module, name):
        split = module.split_network_samples

        def spy(spec, samples):
            record[name].append(np.asarray(samples, np.float32))
            return split(spec, samples)
        return spy

    j_init, shapes = JSceneDiffusion.init, []

    def traced_init(self, key, batch_size=2):
        # the JAX CLI replaces its random init with the .pt's weights: trace
        # the init once for its shapes instead of running flax eagerly
        if not shapes:
            shapes.append(jax.eval_shape(lambda k: j_init(self, k, batch_size), key))
        return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes[0])

    monkeypatch.setattr(SceneDiffusion, "sample", port_sample)
    monkeypatch.setattr(JSceneDiffusion, "sample", jax_sample)
    monkeypatch.setattr(JSceneDiffusion, "init", traced_init)
    monkeypatch.setattr(tpost, "split_network_samples", recorder(tpost, "ts"))
    monkeypatch.setattr(jpost, "split_network_samples", recorder(jpost, "js"))
    from diffuscene_tpu_torch.data.factory import get_raw_dataset

    scene_id = get_raw_dataset(yaml.safe_load(open(cfg))["data"], split=["test"]).scene_ids[1]
    for flags in (["--fix_order"], ["--scene_id", scene_id]):
        for k in record:
            record[k].clear()
        keys[0] = jax.random.PRNGKey(seed)
        common = ["--n_sequences", str(n), "--batch_size", str(bsz), "--clip_denoised",
                  "--seed", str(seed), *flags]
        t_gen([cfg, str(tmp_path / "gen_port"), "--weight_file", os.path.join(out, "rm"),
               "--device", "cpu", *common])
        j_gen([cfg, str(tmp_path / "gen_jax"), "--weight_file", pt, *common])
        mt, mj = np.concatenate(record["t"]), np.concatenate(record["j"])
        assert mt.shape == mj.shape == (2 * bsz, 1, 64, 64)
        assert np.abs(mt - mj).max() <= 1 / 255 + 1e-6
        # one room turned by multiples of 90 degrees keeps its area; the
        # eval scenes in order do not share one
        areas = mt.reshape(len(mt), -1).sum(1)
        assert (np.ptp(areas) < 1e-3 * areas.max()) == (flags[0] == "--scene_id")
        np.testing.assert_allclose(np.concatenate(record["ts"]), np.concatenate(record["js"]),
                                   atol=1e-4, rtol=0)
        assert len([f for f in os.listdir(tmp_path / "gen_port") if f.endswith("_boxes.npz")]) == n
