"""``compute_fid_scores`` and ``improved_precision_recall`` of both packages
end to end on the CPU, on the same two folders of box renders and a tiny
synthetic cached dataset: pixel features (FID within 1e-3 relative, KID
within 1e-5), a random-weight InceptionV3 (FID and KID within 1e-6: the
features agree to 1e-5 relative L2), VGG16 and pixel precision/recall
equal; the JAX CLIs' extractors run at batch 2 here (their default 64 pads
every call to 64 images).  The other evaluation CLIs are in
tests/test_torch_eval_cli.py; this pair has a file of its own so that the
test runner's file scheduler starts it beside the long JAX files, not
before them.
"""
import functools
import json
import os

import numpy as np
import pytest

from diffuscene_tpu_torch.data import make_synthetic_cached_dataset
from test_torch_threads import below_the_longest_file  # noqa: F401 (autouse)
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


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

