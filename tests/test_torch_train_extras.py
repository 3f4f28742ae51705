"""The port's native batcher and PackedDataLoader (diffuscene_tpu_torch/native/,
data/loader.py), its torch.profiler trace window (utils/profiling.py), its
asynchronous checkpoints (utils/checkpoint.py) and the train CLI's
``--native_loader``, ``--async_checkpoints``, ``--profile_dir`` /
``--profile_steps`` and optimizer keys, against the JAX package where it
has a counterpart.

The port builds its own copy of ``batcher.cpp`` with the JAX build's flags,
so its encoder must equal the JAX package's bit for bit on the same raw
scenes and seed, under every permutation and rotation setting; against the
port's numpy pipeline (no permutation, no rotation) atol 2e-6, as
tests/test_native.py holds the JAX encoder.
"""
import os

import numpy as np
import pytest
import torch
import yaml

from diffuscene_tpu import native as jnative
from diffuscene_tpu_torch import native
from diffuscene_tpu_torch.data.encoding import Bounds, diffusion_encode, scale_sample
from diffuscene_tpu_torch.data.factory import get_dataset_raw_and_encoded
from diffuscene_tpu_torch.data.loader import PackedDataLoader
from diffuscene_tpu_torch.utils import checkpoint as ckpt
from diffuscene_tpu_torch.utils.profiling import ThroughputMeter, TraceWindow, annotate, trace
from test_torch_scene_data import _cli_config, _data_config
from test_torch_train import _tiny
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


def _bounds():
    return Bounds(
        translations=(np.array([-3.0, 0.0, -3.0]), np.array([3.0, 4.0, 3.0])),
        sizes=(np.array([0.04, 0.04, 0.04]), np.array([2.0, 2.0, 2.0])),
        angles=(np.array(-np.pi), np.array(np.pi)),
        objfeats_32=(np.array([1.0]), np.array([-4.0]), np.array([4.0])),
    )


def _raw_scenes(seed, n_scenes=16, n_classes=23):
    rng = np.random.default_rng(seed)
    scenes = []
    for _ in range(n_scenes):
        n = int(rng.integers(3, 12))
        cls = np.zeros((n, n_classes), np.float32)
        cls[np.arange(n), rng.integers(0, n_classes - 2, n)] = 1.0
        scenes.append({
            "translations": rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32),
            "sizes": rng.uniform(0.05, 1.9, (n, 3)).astype(np.float32),
            "angles": rng.uniform(-np.pi, np.pi, (n, 1)).astype(np.float32),
            "class_labels": cls,
            "objfeats_32": rng.normal(0, 1, (n, 32)).astype(np.float32),
        })
    return scenes


@pytest.mark.parametrize("rotation", [None, "fixed_rotations", "rotations"])
@pytest.mark.parametrize("permute", [False, True])
def test_native_encoder_equals_jax(permute, rotation):
    samples = _raw_scenes(0)
    kw = dict(max_length=12, n_classes=23, objfeat_dim=32, permute=permute, rotation=rotation,
              seed=3)
    ours = native.NativeBatchEncoder(_bounds(), **kw)
    theirs = jnative.NativeBatchEncoder(_bounds(), **kw)
    for seed in (None, 11):
        got = ours(samples, seed=seed)
        assert got.shape == (16, 12, 62)
        np.testing.assert_array_equal(got, theirs(samples, seed=seed))


def test_native_encoder_matches_numpy_pipeline():
    """tests/test_native.py:49 for the port: scaling, cos/sin angles,
    objfeats normalization and the diffusion padding, no augmentation."""
    samples = _raw_scenes(1)
    got = native.NativeBatchEncoder(_bounds(), 12, 23, 32, permute=False, rotation=None)(
        samples, seed=1)
    want = []
    for s in samples:
        enc = diffusion_encode(scale_sample(s, _bounds(), cosin_angle=True, objfeats_norm=True), 12)
        want.append(np.concatenate([enc[k] for k in ("translations", "sizes", "angles",
                                                     "class_labels", "objfeats_32")], axis=-1))
    np.testing.assert_allclose(got, np.stack(want), atol=2e-6, rtol=0)


def test_native_build_is_keyed_and_a_failed_build_raises(tmp_path, monkeypatch):
    """The library lives in build/native/ under a name keyed by the source
    (another source, another name); a source that does not compile, or no
    g++, raises; nothing falls back."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    real = native.library_path()
    assert str(real.parent) == os.path.join(repo, "build", "native")
    bad = tmp_path / "batcher.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "_lib", None)
    assert native.library_path().name != real.name
    with pytest.raises(RuntimeError, match="failed"):
        native.load_library()
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.NativeBatchEncoder(_bounds(), 12, 23)


def test_packed_loader_trains_two_epochs(tmp_path):
    """PackedDataLoader's {"packed": ...} batches through Trainer.train_step
    for two epochs on a synthetic dataset: every step finite, the epochs
    shuffled apart (the JAX loader's batches, bit for bit, in
    tests/test_torch_scene_data.py)."""
    from diffuscene_tpu_torch.data import make_synthetic_cached_dataset

    data_dir = str(tmp_path / "cached")
    make_synthetic_cached_dataset(data_dir, n_scenes=16, seed=4)
    cfg = _data_config(data_dir)
    raw, ds = get_dataset_raw_and_encoded(cfg, augmentations=cfg["augmentations"],
                                          split=["train", "val"], seed=0)
    loader = PackedDataLoader(raw, ds.bounds, ds.max_length, ds.n_classes, batch_size=4, seed=0)
    trainer = _tiny()
    epochs = []
    for _ in range(2):
        batches = list(loader)
        for b in batches:
            m = trainer.train_step(trainer.put_batch(b))
            assert np.isfinite(m["loss"]) and np.isfinite(m["gradnorm"])
        epochs.append(np.stack([b["packed"] for b in batches]))
    assert trainer.step == 2 * len(loader) > 0
    assert not np.array_equal(epochs[0], epochs[1])


def test_trace_window_opens_and_closes_on_its_steps(tmp_path):
    """TraceWindow(start=3, length=2): the capture opens at tick(3) and
    closes at tick(5), as the JAX package's window does; on the CPU it
    writes one non-empty Chrome trace holding the annotated region; trace()
    captures a region; ThroughputMeter counts steps."""
    win = TraceWindow(str(tmp_path / "win"), start=3, length=2)
    active = []
    for step in range(8):
        with annotate("a_train_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        win.tick(step)
        active.append(win._active)
    win.close()
    assert active == [False, False, False, True, True, False, False, False]
    files = os.listdir(tmp_path / "win")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(tmp_path / "win" / files[0]) as f:
        text = f.read()
    assert "a_train_step" in text
    with trace(str(tmp_path / "region")):
        torch.ones(8).sum()
    assert len(os.listdir(tmp_path / "region")) == 1
    meter = ThroughputMeter(items_per_step=4)
    for _ in range(3):
        meter.synced_tick(torch.ones(2))
    assert meter.total_steps == 3 and meter.items_per_sec == 4 * meter.steps_per_sec > 0


def test_async_checkpoint_equals_a_blocking_one(tmp_path):
    """save_checkpoint(blocking=False) snapshots the state to host memory
    before it returns: updating the trainer afterwards does not reach the
    file, which equals a blocking save of the same state, tensor for
    tensor; keep_last prunes after the background write."""
    trainer = _tiny(ema_decay=0.5)
    state = trainer.state_dict()        # its tensors are the trainer's own
    ckpt.save_checkpoint(state, str(tmp_path / "b"), 0, blocking=True)
    ckpt.save_checkpoint(state, str(tmp_path / "a"), 0, blocking=False, keep_last=1)
    with torch.no_grad():
        for p in trainer.params:
            p.add_(1.0)                    # in place, after the call returned
    ckpt.wait_for_checkpoints()
    a, _ = ckpt.load_checkpoint(str(tmp_path / "a"))
    b, _ = ckpt.load_checkpoint(str(tmp_path / "b"))

    def flat(x, prefix=""):
        if isinstance(x, dict):
            return {k2: v2 for k, v in x.items() for k2, v2 in flat(v, f"{prefix}{k}.").items()}
        if isinstance(x, (list, tuple)):
            return {k2: v2 for i, v in enumerate(x) for k2, v2 in flat(v, f"{prefix}{i}.").items()}
        return {prefix[:-1]: x}

    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    for k in fb:
        if isinstance(fb[k], torch.Tensor):
            assert torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k
    assert not torch.equal(fa["model." + trainer.names[0]], trainer.params[0].detach())
    for i in (1, 2):
        ckpt.save_checkpoint(state, str(tmp_path / "a"), i, blocking=False, keep_last=1)
    ckpt.wait_for_checkpoints()
    assert sorted(os.listdir(tmp_path / "a")) == ["model_00002"]


OPTIMIZERS = [{"optimizer": "RAdam", "schedule": "warmup_cosine", "warmup_epochs": 1,
               "min_lr": 1e-5},
              {"optimizer": "SGD", "momentum": 0.9, "schedule": "lambda", "start_epoch": 1,
               "lr_decay": 0.9},
              {"optimizer": "Adam", "weight_decay": 0.01, "schedule": "step"}]


def test_train_cli_native_loader_async_checkpoints_profile_and_optimizers(tmp_path):
    """train_diffusion --native_loader --async_checkpoints --profile_dir
    --profile_steps 2 on a RAdam + warmup_cosine config for 3 epochs (6
    steps): every epoch's checkpoint on disk, the trace of steps 5-6
    written; then each other optimizer/schedule key of the JAX package
    (SGD + lambda, AdamW + step) for one epoch."""
    from diffuscene_tpu_torch.cli.train_diffusion import main as train_main

    path = _cli_config(tmp_path, ema_decay=0.9)
    with open(path) as f:
        base = yaml.safe_load(f)
    out, prof = str(tmp_path / "out"), str(tmp_path / "prof")
    for i, opt in enumerate(OPTIMIZERS):
        cfg = dict(base, training={**base["training"], **opt})
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        tag = opt["optimizer"] + opt["schedule"]
        flags = (["--native_loader", "--async_checkpoints", "--profile_dir", prof,
                  "--profile_steps", "2", "--epochs", "3"] if i == 0 else ["--epochs", "1"])
        train_main([path, out, "--experiment_tag", tag, "--seed", "0", "--device", "cpu",
                    *flags])
        state, epoch = ckpt.load_checkpoint(os.path.join(out, tag))
        assert epoch == (2 if i == 0 else 0) and state["step"] == (6 if i == 0 else 2)
        assert state["optimizer"]["count"] == state["step"]
        assert all(torch.isfinite(v).all() for v in state["model"].values())
    assert sorted(f for f in os.listdir(os.path.join(out, OPTIMIZERS[0]["optimizer"] + "warmup_cosine"))
                  if f.startswith("model_")) == ["model_00001", "model_00002"]
    traces = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1 and os.path.getsize(os.path.join(prof, traces[0])) > 0
