"""The port's copied scene data pipeline (diffuscene_tpu_torch/data/) against
the JAX package's, and the port's train and generate CLIs end to end on the
CPU, on a tiny synthetic cached dataset.

The pipeline is a numpy copy, so the batches must be identical
(``np.array_equal`` on every key) over two epochs with fixed_rotations,
random permutation and shuffling from the same seed.
"""
import json
import os

import numpy as np
import pytest
import yaml

from diffuscene_tpu.data import make_synthetic_cached_dataset as j_make_synthetic
from diffuscene_tpu.data.factory import get_dataset_raw_and_encoded as j_get_dataset
from diffuscene_tpu.data.loader import DataLoader as JDataLoader
from diffuscene_tpu_torch.data import make_synthetic_cached_dataset
from diffuscene_tpu_torch.data.factory import get_dataset_raw_and_encoded
from diffuscene_tpu_torch.data.loader import DataLoader, PackedDataLoader

ENCODING = "cached_diffusion_cosin_angle_objfeatsnorm_lat32_wocm"


def _data_config(data_dir):
    return {"dataset_type": "cached_threedfront", "encoding_type": ENCODING,
            "dataset_directory": data_dir,
            "annotation_file": os.path.join(data_dir, "splits.csv"),
            "augmentations": ["fixed_rotations"], "train_stats": "dataset_stats.txt",
            "room_layout_size": "64,64", "max_length": 12}


def test_synthetic_dataset_equals_jax(tmp_path):
    """Both generators write the same rooms, stats and splits from a seed."""
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    make_synthetic_cached_dataset(a, n_scenes=6, seed=3)
    j_make_synthetic(b, n_scenes=6, seed=3)
    for name in ("dataset_stats.txt", "splits.csv"):
        with open(os.path.join(a, name)) as fa, open(os.path.join(b, name)) as fb:
            assert fa.read() == fb.read(), name
    rooms = sorted(d for d in os.listdir(a) if os.path.isdir(os.path.join(a, d)))
    assert rooms == sorted(d for d in os.listdir(b) if os.path.isdir(os.path.join(b, d)))
    for r in rooms:
        with np.load(os.path.join(a, r, "boxes.npz")) as da, \
                np.load(os.path.join(b, r, "boxes.npz")) as db:
            assert sorted(da.files) == sorted(db.files)
            for k in da.files:
                assert np.array_equal(da[k], db[k]), (r, k)


@pytest.mark.parametrize("split", [("train", "val"), ("test",)], ids=["train", "test"])
def test_pipeline_batches_equal_jax(tmp_path, split):
    """Two epochs of shuffled batches (fixed_rotations, permutation, padding,
    scaling) from the copied pipeline equal the JAX package's, key for key;
    the bounds and class metadata too."""
    data_dir = str(tmp_path / "cached")
    make_synthetic_cached_dataset(data_dir, n_scenes=40, seed=0)
    cfg = _data_config(data_dir)
    raw_t, ds_t = get_dataset_raw_and_encoded(cfg, augmentations=cfg["augmentations"],
                                              split=split, seed=5)
    raw_j, ds_j = j_get_dataset(cfg, augmentations=cfg["augmentations"], split=split, seed=5)
    assert raw_t.class_labels == raw_j.class_labels and len(ds_t) == len(ds_j) > 0
    for k, v in ds_j.bounds.as_device_bounds().items():
        assert np.array_equal(ds_t.bounds.as_device_bounds()[k], v), k
    loader_t = DataLoader(ds_t, 3, shuffle=True, seed=7)
    loader_j = JDataLoader(ds_j, 3, shuffle=True, seed=7)
    n = 0
    for _ in range(2):
        for bt, bj in zip(loader_t, loader_j, strict=True):
            assert bt.keys() == bj.keys()
            for k in bj:
                assert np.array_equal(np.asarray(bt[k]), np.asarray(bj[k])), k
            n += 1
    assert n == 2 * len(loader_j)
    # post_process (descaling) of a batch
    pt, pj = ds_t.post_process(dict(bt)), ds_j.post_process(dict(bj))
    assert pt.keys() == pj.keys()
    for k in pj:
        assert np.array_equal(np.asarray(pt[k]), np.asarray(pj[k])), k


def test_unported_loaders_raise():
    with pytest.raises(NotImplementedError, match="A11"):
        PackedDataLoader(None, None, 12, 23, 2)


def _cli_config(root, ema_decay):
    data_dir = str(root / "cached")
    make_synthetic_cached_dataset(data_dir, n_scenes=24, seed=0)
    nk = {"dim": 32, "dim_mults": [1, 1, 1, 1], "channels": 62, "objectness_dim": 0,
          "class_dim": 22, "angle_dim": 2, "objfeat_dim": 32, "context_dim": 0,
          "instanclass_dim": 16, "seperate_all": True}
    cfg = {
        "data": _data_config(data_dir),
        "network": {"type": "diffusion_scene_layout_ddpm", "net_type": "unet1d",
                    "point_dim": 62, "room_mask_condition": False, "sample_num_points": 12,
                    "objectness_dim": 0, "class_dim": 22, "angle_dim": 2, "objfeat_dim": 32,
                    "learnable_embedding": True, "instance_condition": True,
                    "instance_emb_dim": 16,
                    "diffusion_kwargs": {"schedule_type": "linear", "time_num": 8,
                                         "model_mean_type": "v",
                                         "model_var_type": "fixedsmall",
                                         "loss_separate": True, "loss_iou": True},
                    "net_kwargs": nk},
        "training": {"splits": ["train", "val"], "epochs": 2, "batch_size": 8,
                     "save_frequency": 1, "max_grad_norm": 10, "optimizer": "Adam",
                     "schedule": "step", "lr": 2e-4, "lr_step": 10000, "lr_decay": 0.5,
                     "ema_decay": ema_decay},
        "validation": {"splits": ["test"], "frequency": 1, "batch_size": 2},
        "logger": {"type": "stats"},
    }
    path = str(root / "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def test_train_then_generate_cli_on_cpu(tmp_path):
    """train_diffusion (2 epochs, EMA, checkpoints, bounds, stats) then
    generate_diffusion on its checkpoint (EMA weights, DPM-Solver++ through
    the 3-D engine, --compute_intersec, metrics.json; then --render, a PNG
    a scene), both with --device cpu; a rerun of
    train resumes from the last checkpoint, trains one more epoch and keeps
    only the last checkpoint."""
    from diffuscene_tpu_torch.cli.generate_diffusion import main as gen_main
    from diffuscene_tpu_torch.cli.train_diffusion import main as train_main
    from diffuscene_tpu_torch.utils.checkpoint import latest_epoch, load_checkpoint

    cfg = _cli_config(tmp_path, ema_decay=0.9)
    out = str(tmp_path / "out")
    train_main([cfg, out, "--experiment_tag", "e2e", "--seed", "0", "--device", "cpu",
                "--steps_per_dispatch", "2", "--log_every", "1"])
    exp = os.path.join(out, "e2e")
    for name in ("params.json", "bounds.npz", "stats.txt"):
        assert os.path.isfile(os.path.join(exp, name)), name
    assert latest_epoch(exp) == 1
    state, _ = load_checkpoint(exp)
    assert state["step"] == 2 * 2 and state["ema"] is not None   # 20 scenes // 8 = 2 a epoch
    with open(os.path.join(exp, "stats.txt")) as f:
        assert "loss" in f.read()

    train_main([cfg, out, "--experiment_tag", "e2e", "--seed", "0", "--device", "cpu",
                "--epochs", "3", "--keep_last_checkpoints", "1"])
    state, epoch = load_checkpoint(exp)
    assert epoch == 2 and state["step"] == 3 * 2
    assert sorted(f for f in os.listdir(exp) if f.startswith("model_")) == ["model_00002"]

    gen = str(tmp_path / "gen")
    stats = gen_main([cfg, gen, "--weight_file", exp, "--n_sequences", "3", "--batch_size", "2",
                      "--fused", "--dpm", "--dpm_steps", "3", "--compute_intersec",
                      "--device", "cpu"])
    with open(os.path.join(gen, "metrics.json")) as f:
        assert json.load(f) == stats
    assert stats["n_scenes"] == 3 and np.isfinite(stats["categorical_kl"])
    assert "avg_overlap_ratio" in stats
    boxes = sorted(f for f in os.listdir(gen) if f.endswith("_boxes.npz"))
    assert boxes == ["00000_boxes.npz", "00001_boxes.npz", "00002_boxes.npz"]
    with np.load(os.path.join(gen, boxes[0])) as d:
        assert d["translations"].shape[-1] == 3 and np.isfinite(d["sizes"]).all()
    gen_main([cfg, gen, "--weight_file", exp, "--n_sequences", "3", "--batch_size", "2",
              "--fused", "--dpm", "--dpm_steps", "3", "--render", "--device", "cpu"])
    pngs = sorted(f for f in os.listdir(gen) if f.endswith(".png"))
    assert pngs == ["00000.png", "00001.png", "00002.png"]
    from diffuscene_tpu_torch.eval.png import read_png

    assert all(read_png(os.path.join(gen, f)).shape == (256, 256, 3) for f in pngs)
    with pytest.raises(SystemExit, match="A11"):
        train_main([cfg, out, "--native_loader", "--device", "cpu"])
