"""The port's evaluation entry points end to end on the CPU, on a tiny
synthetic cached dataset and a synthetic textured-box catalog, against the
JAX package's where the two can see the same inputs.

- run/generate.sh's command (``--clip_denoised --fused --render
  --compute_intersec``) on a flagship-shaped tiny config (the flagship's
  encoding and 4 levels, dim 32, 4 steps), then the mesh flags with a
  catalog; the sampler's noise differs between the packages, so these are
  checked for their outputs.
- ``SceneOutput`` fed the same boxes in both packages: the same renders
  (top-down, perspective, orbit frames), manifests and mesh files.
- ``compute_fid_scores`` and ``improved_precision_recall`` of both packages
  on the same two folders: pixel features (FID within 1e-3 relative, KID
  within 1e-5), a random-weight InceptionV3 (FID and KID within 1e-6: the
  features agree to 1e-5 relative L2), VGG16 and pixel precision/recall
  equal; the JAX CLIs' extractors run at batch 2 here (their default 64
  pads every call to 64 images).
- Flag parity: the port's parsers take every option of the JAX CLIs.
"""
import argparse
import contextlib
import functools
import json
import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from diffuscene_tpu_torch.data import make_synthetic_cached_dataset, make_synthetic_catalog

ENCODING = "cached_diffusion_cosin_angle_objfeatsnorm_lat32_wocm"


@pytest.fixture(autouse=True)
def one_thread():
    """torch and the BLAS under numpy/scipy on one thread: the tests run
    with several workers a machine, and a thread a core per worker
    oversubscribes the cores (scipy's ``sqrtm`` of a 2048x2048 product
    takes 11.6 s on 8 threads and 16.5 s on one)."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:                 # the BLAS keeps its threads
        threadpool_limits = contextlib.nullcontext
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _config(root, data_dir):
    """The flagship config's shape (encoding, 4 levels, N=12, v-prediction)
    at dim 32 and 4 diffusion steps."""
    nk = {"dim": 32, "dim_mults": [1, 1, 1, 1], "channels": 62, "objectness_dim": 0,
          "class_dim": 22, "angle_dim": 2, "objfeat_dim": 32, "context_dim": 0,
          "instanclass_dim": 16, "seperate_all": True}
    cfg = {
        "data": {"dataset_type": "cached_threedfront", "encoding_type": ENCODING,
                 "dataset_directory": data_dir,
                 "annotation_file": os.path.join(data_dir, "splits.csv"),
                 "augmentations": ["fixed_rotations"], "train_stats": "dataset_stats.txt",
                 "room_layout_size": "64,64", "max_length": 12},
        "network": {"type": "diffusion_scene_layout_ddpm", "net_type": "unet1d",
                    "point_dim": 62, "room_mask_condition": False, "sample_num_points": 12,
                    "objectness_dim": 0, "class_dim": 22, "angle_dim": 2, "objfeat_dim": 32,
                    "learnable_embedding": True, "instance_condition": True,
                    "instance_emb_dim": 16,
                    "diffusion_kwargs": {"schedule_type": "linear", "time_num": 4,
                                         "model_mean_type": "v",
                                         "model_var_type": "fixedsmall",
                                         "loss_separate": True, "loss_iou": True},
                    "net_kwargs": nk},
        "training": {"splits": ["train", "val"], "epochs": 1, "batch_size": 8},
        "validation": {"splits": ["test"], "frequency": 1, "batch_size": 2},
    }
    path = str(root / "flagship_tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A 40-room synthetic dataset (4 eval scenes), the tiny config and a
    catalog with every class label of the dataset."""
    from diffuscene_tpu_torch.data.factory import get_raw_dataset
    from diffuscene_tpu_torch.utils.config import load_config

    root = tmp_path_factory.mktemp("eval_cli")
    data_dir = str(root / "cached")
    make_synthetic_cached_dataset(data_dir, n_scenes=40, seed=0)
    cfg = _config(root, data_dir)
    raw = get_raw_dataset(load_config(cfg)["data"], split=["test"])
    catalog = make_synthetic_catalog(str(root / "catalog"), raw.class_labels, seed=0)
    return {"root": root, "data": data_dir, "config": cfg, "catalog": catalog}


def _pngs(folder, n, shape=(256, 256, 3)):
    names = sorted(f for f in os.listdir(folder) if f.endswith(".png") and len(f) == 9)
    assert names == [f"{i:05d}.png" for i in range(n)]
    for name in names:
        with Image.open(os.path.join(folder, name)) as im:
            assert np.asarray(im).shape == shape
    return names


def test_generate_sh_command_then_mesh_flags(setup, tmp_path):
    """generate_diffusion CONFIG OUT --n_sequences 4 --batch_size 2
    --clip_denoised --fused --render --compute_intersec --device cpu writes
    00000.png..00003.png, iou_states.txt, metrics.json (the JAX CLI's keys)
    and timing.json; with the catalog as the third positional,
    --save_mesh --mesh_format .ply --judge_mesh_intersec
    --render_perspective also writes scene_mesh/, the manifests and the
    perspective renders, and judges no more pairs than the boxes."""
    from diffuscene_tpu_torch.cli._box_stats import mean_box_stats, scene_box_stats
    from diffuscene_tpu_torch.cli.generate_diffusion import main as gen_main

    out = str(tmp_path / "gen")
    stats = gen_main([setup["config"], out, "--n_sequences", "4", "--batch_size", "2",
                      "--clip_denoised", "--fused", "--render", "--compute_intersec",
                      "--device", "cpu"])
    _pngs(out, 4)
    with open(os.path.join(out, "metrics.json")) as f:
        assert json.load(f) == stats
    assert set(stats) == {"n_scenes", "categorical_kl", "avg_objects", "avg_pair_iou",
                          "avg_intersec", "avg_overlap_ratio", "avg_symmetry"}
    with open(os.path.join(out, "iou_states.txt")) as f:
        assert len(f.read().splitlines()) == 4
    with open(os.path.join(out, "timing.json")) as f:
        assert set(json.load(f)) == {"sample_s", "render_s", "metrics_s"}

    mesh = str(tmp_path / "mesh")
    judged = gen_main([setup["config"], mesh, setup["catalog"], "--n_sequences", "3",
                       "--batch_size", "3", "--render", "--render_perspective",
                       "--window_size", "64,48", "--save_mesh", "--mesh_format", ".ply",
                       "--compute_intersec", "--judge_mesh_intersec", "--device", "cpu"])
    _pngs(mesh, 3)
    from diffuscene_tpu_torch.data import ThreedFutureDataset

    jids = {o.model_jid for o in ThreedFutureDataset.from_pickled_dataset(setup["catalog"])}
    unjudged = []
    for i in range(3):
        with Image.open(os.path.join(mesh, f"{i:05d}_persp.png")) as im:
            assert np.asarray(im).shape == (48, 64, 3)
        with open(os.path.join(mesh, f"{i:05d}_scene.json")) as f:
            manifest = json.load(f)
        assert all(m["model_jid"] in jids for m in manifest)
        assert os.path.isfile(os.path.join(mesh, "scene_mesh", f"{i:05d}.ply"))
        objs = [f for f in os.listdir(os.path.join(mesh, "scene_mesh", f"{i:05d}"))
                if f.endswith(".obj")]
        assert len(objs) == len(manifest)
        with np.load(os.path.join(mesh, f"{i:05d}_boxes.npz")) as d:
            unjudged.append(scene_box_stats(dict(d)))
    assert judged["avg_intersec"] <= mean_box_stats(unjudged)["avg_intersec"]
    with pytest.raises(SystemExit, match="needs a retrieved catalog"):
        gen_main([setup["config"], mesh, "--compute_intersec", "--judge_mesh_intersec",
                  "--device", "cpu"])
    with pytest.raises(SystemExit, match="profile_dir"):
        gen_main([setup["config"], mesh, "--profile_dir", str(tmp_path), "--device", "cpu"])


def _scene_output_args(pkg, argv):
    parser = argparse.ArgumentParser()
    parser.add_argument("--render", action="store_true")
    pkg.add_scene_output_args(parser)
    return pkg.resolve_scene_output_args(parser.parse_args(argv))


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            rel = os.path.relpath(path, root)
            if n.endswith(".png"):
                with Image.open(path) as im:
                    out[rel] = np.asarray(im).tobytes()
            else:
                with open(path, "rb") as f:
                    out[rel] = f.read()
    return out


@pytest.mark.parametrize("extra", [[], ["--retrive_objfeats", "--no_texture"]],
                         ids=["textured", "objfeats"])
def test_scene_output_equals_jax(setup, tmp_path, extra):
    """Both packages' SceneOutput on the same eval scenes (their boxes as
    post-processed scenes) with the catalog, a floor-texture folder, the
    perspective camera and 2 orbit frames: render() pixels, the perspective
    renders and frames, the manifests and every mesh file equal; without a
    catalog, the box renders equal."""
    from diffuscene_tpu.cli import _scene_output as jso
    from diffuscene_tpu.data.factory import get_raw_dataset as j_raw
    from diffuscene_tpu_torch.cli import _scene_output as pso
    from diffuscene_tpu_torch.data.factory import get_raw_dataset as p_raw
    from diffuscene_tpu_torch.utils.config import load_config

    floors = tmp_path / "floors"
    floors.mkdir()
    for i in range(2):
        Image.fromarray(np.full((8, 8, 3), 60 * (i + 1), np.uint8)).save(floors / f"f{i}.png")
    argv = [setup["catalog"], "--render_perspective", "--with_rotating_camera", "--n_frames",
            "2", "--window_size", "40,32", "--path_to_floor_plan_textures", str(floors),
            "--save_mesh", *extra]
    data = load_config(setup["config"])["data"]
    for pkg, raw_fn, label in ((pso, p_raw, "port"), (jso, j_raw, "jax")):
        raw = raw_fn(data, split=["test"])
        out = pkg.SceneOutput(_scene_output_args(pkg, argv), raw, seed=3)
        boxless = pkg.SceneOutput(_scene_output_args(pkg, []), raw, seed=3)
        root = tmp_path / label
        os.makedirs(root / "box")
        for i in range(len(raw)):
            boxes = {k: v[None] for k, v in raw[i].items() if k != "room_layout"}
            if extra:
                boxes["objfeats"] = boxes.pop("objfeats_32")
            Image.fromarray(out.render(boxes, i, floor_idx=len(raw) - 1 - i)).save(
                root / f"{i:05d}.png")
            Image.fromarray(boxless.render(boxes, i)).save(root / "box" / f"{i:05d}.png")
            out.perspective_outputs(boxes, i, str(root), floor_idx=i)
            out.export(boxes, i, str(root))
    ours, theirs = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert ours.keys() == theirs.keys()
    assert sum(k.endswith("_scene.json") for k in ours) == 4
    assert any(k.startswith(os.path.join("frames", "00003")) for k in ours)
    for k in ours:
        assert ours[k] == theirs[k], k


def _render_folders(root, n=5):
    """Two folders of n box renders (the port's render_to_folder over random
    scenes of 23 classes)."""
    from diffuscene_tpu_torch.eval.render import render_to_folder

    folders = []
    for name, seed in (("real", 0), ("fake", 1)):
        rng = np.random.default_rng(seed)
        scenes = [{"translations": rng.uniform(-2.5, 2.5, (7, 3)),
                   "sizes": rng.uniform(0.1, 1.2, (7, 3)),
                   "angles": rng.uniform(-3, 3, (7, 1)),
                   "class_labels": np.eye(23)[rng.integers(0, 23, 7)]} for _ in range(n)]
        render_to_folder(scenes, str(root / name))
        folders.append(str(root / name))
    return folders


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """The two render folders, and a cached dataset whose rooms carry the
    real renders as rendered_scene_256.png (the annotations branch)."""
    root = tmp_path_factory.mktemp("folders")
    real, fake = _render_folders(root)
    cached = str(root / "cached")
    make_synthetic_cached_dataset(cached, n_scenes=len(os.listdir(real)), seed=1)
    rooms = sorted(d for d in os.listdir(cached) if os.path.isdir(os.path.join(cached, d)))
    for room, name in zip(rooms, sorted(os.listdir(real))):
        with open(os.path.join(real, name), "rb") as f, \
                open(os.path.join(cached, room, "rendered_scene_256.png"), "wb") as g:
            g.write(f.read())
    return {"real": real, "fake": fake, "cached": cached,
            "splits": os.path.join(cached, "splits.csv")}


def _cli_pair(module, monkeypatch):
    """(port main, JAX main) of a metrics CLI; the JAX extractors at batch 2."""
    import importlib

    from diffuscene_tpu.eval import fid as jfid

    monkeypatch.setattr(jfid, "JaxInceptionFeatures",
                        functools.partial(jfid.JaxInceptionFeatures, batch_size=2))
    monkeypatch.setattr(jfid, "JaxVGG16Features",
                        functools.partial(jfid.JaxVGG16Features, batch_size=2))
    port = importlib.import_module(f"diffuscene_tpu_torch.cli.{module}")
    jax_cli = importlib.import_module(f"diffuscene_tpu.cli.{module}")
    return port.main, jax_cli.main


def _jax_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_fid_cli_equals_jax(folders, monkeypatch, capsys, tmp_path):
    """compute_fid_scores of both packages on the same folders: a
    random-weight InceptionV3 (its .npz) on two render folders, and pixel
    features on the annotations branch (a cached dataset's renders, all
    splits); --features inception without weights raises."""
    from diffuscene_tpu.eval.backbones import random_inception_state_dict

    ours, theirs = _cli_pair("compute_fid_scores", monkeypatch)
    weights = str(tmp_path / "inception.npz")
    np.savez(weights, **random_inception_state_dict(0))
    cases = [(["--features", "inception", "--inception_weights", weights], 0, 1e-6),
             ([folders["cached"], folders["fake"], folders["splits"], "--features", "pixel",
               "--compare_all", "--kid_subset_size", "4"], 1e-3, 1e-5)]
    for flags, fid_rtol, atol in cases:
        argv = flags if flags[0] == folders["cached"] else [folders["real"], folders["fake"], *flags]
        got = ours([*argv, "--device", "cpu"])
        capsys.readouterr()
        theirs(argv)
        want = _jax_json(capsys)
        assert (got["features"], got["comparable"]) == (want["features"], want["comparable"])
        np.testing.assert_allclose(got["fid"], want["fid"], rtol=fid_rtol, atol=atol)
        np.testing.assert_allclose(got["kid"], want["kid"], atol=atol)
    with pytest.raises(FileNotFoundError):
        ours([folders["real"], folders["fake"], "--features", "inception", "--device", "cpu"])


def test_ipr_cli_equals_jax(folders, monkeypatch, capsys, tmp_path):
    """improved_precision_recall of both packages on the same folders:
    VGG16 (random weights) and pixel features with --realism, the
    annotations branch, a precalculated manifold and --toy; precision and
    recall equal, realism within 1e-3 relative (it moves with the features:
    VGG16's agree to 1e-5 relative L2, the pixel features to one level)."""
    from diffuscene_tpu.eval.backbones import random_vgg16_state_dict

    ours, theirs = _cli_pair("improved_precision_recall", monkeypatch)
    weights = str(tmp_path / "vgg.npz")
    np.savez(weights, **random_vgg16_state_dict(0))
    precalc = str(tmp_path / "manifold.npz")
    cases = [[folders["real"], folders["fake"], "--features", "vgg", "--vgg_weights", weights,
              "--k", "2", "--realism"],
             [folders["real"], folders["fake"], "--features", "pixel", "--k", "2",
              "--num_samples", "5", "--realism"],
             [folders["cached"], folders["fake"], folders["splits"], "--features", "pixel",
              "--k", "2"],
             [folders["real"], folders["fake"], "--features", "pixel", "--k", "2",
              "--fname_precalc", precalc],
             [precalc, folders["fake"], "--features", "pixel", "--k", "2"],
             [folders["real"], folders["fake"], "--toy", "--num_samples", "200"]]
    for argv in cases:
        got = ours([*argv, "--device", "cpu"])
        capsys.readouterr()
        theirs(argv)
        if "--fname_precalc" in argv:
            assert got is None and os.path.isfile(precalc)
            continue
        want = _jax_json(capsys)
        assert got.keys() == want.keys()
        for k in want:
            if k.startswith("realism"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-3)
            else:
                assert got[k] == want[k], (argv, k)


def _jax_parser(main):
    """The argparse parser a JAX CLI's main builds, caught at parse_args."""
    class Caught(Exception):
        pass

    def catch(self, *args, **kwargs):
        raise Caught(self)

    original = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = catch
    try:
        main([])
    except Caught as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = original
    raise AssertionError("the CLI parsed no arguments")


# options of the JAX CLIs that the port takes and refuses at run time
REFUSED = {"generate_diffusion": {"--profile_dir"}}


@pytest.mark.parametrize("module", ["generate_diffusion", "completion_rearrange",
                                    "compute_fid_scores", "improved_precision_recall"])
def test_flag_parity_with_jax(module):
    """The port's parser accepts every option and positional of the JAX
    CLI with the same default and the same choices; the options it refuses
    are only those in REFUSED, and each raises SystemExit naming itself."""
    import importlib

    jax_parser = _jax_parser(importlib.import_module(f"diffuscene_tpu.cli.{module}").main)
    port_mod = importlib.import_module(f"diffuscene_tpu_torch.cli.{module}")
    port_parser = port_mod.build_parser()
    port_opts = {o: a for a in port_parser._actions for o in a.option_strings}
    port_pos = [a.dest for a in port_parser._actions if not a.option_strings]
    for action in jax_parser._actions:
        if not action.option_strings:
            assert action.dest in port_pos, action.dest
            continue
        for opt in action.option_strings:
            assert opt in port_opts, opt
            mine = port_opts[opt]
            assert (mine.dest, mine.default, mine.choices, mine.nargs) == \
                (action.dest, action.default, action.choices, action.nargs), opt
    assert [a.dest for a in jax_parser._actions if not a.option_strings] == \
        [d for d in port_pos if d in {a.dest for a in jax_parser._actions}]
    extra = {o for o in port_opts if o not in
             {o for a in jax_parser._actions for o in a.option_strings}}
    assert extra == {"--device"}
    for opt in REFUSED.get(module, ()):
        with pytest.raises(SystemExit, match=opt.lstrip("-")):
            port_mod.main(["config.yaml", "out", opt, "x", "--device", "cpu"])
