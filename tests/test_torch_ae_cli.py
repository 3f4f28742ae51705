"""The port's shape-autoencoder entry points and their support
(diffuscene_tpu_torch/cli/*_objautoencoder.py, utils/config.py,
utils/checkpoint.py, data/): the YAML reader against ``yaml.safe_load`` on
every shipped config, a catalog pickled by the JAX package's classes, and
train -> checkpoint -> resume -> generate on the CPU at 64 points.
"""
import glob
import inspect
import json
import os
import pickle

import numpy as np
import pytest
import torch
import yaml

from diffuscene_tpu.data.raw import Asset as JAsset
from diffuscene_tpu.data.raw import ThreedFutureModel as JThreedFutureModel
from diffuscene_tpu.data.threed_future import ThreedFutureDataset as JThreedFutureDataset
from diffuscene_tpu_torch.cli import generate_objautoencoder, train_objautoencoder
from diffuscene_tpu_torch.data import ThreedFutureModel, ThreedFutureNormPCDataset
from diffuscene_tpu_torch.models import SceneDiffusion, autoencoder
from diffuscene_tpu_torch.train import AETrainer
from diffuscene_tpu_torch.utils import checkpoint, config
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))
N_OBJECTS, N_POINTS, BATCH = 16, 64, 8
AE_YAML = """\
network:
  objfeat_dim: 32
  kl_weight: 0.001     # as bed_living_diningrooms_lat32
training:
  epochs: 1
  batch_size: 8
  save_frequency: 100
  max_grad_norm: 10
  optimizer: Adam
  schedule: step
  lr: 0.0001
  lr_step: 400
  lr_decay: 0.1
logger:
  type: stats
"""


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_config_reader_matches_yaml(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    assert config.load_config(path) == want


def test_config_reader_scalars_match_yaml():
    text = ("a: 1\nb: -2\nc: 0.5\nd: 1.0e-4\ne: 1e-4\nf: .inf\ng: ~\nh:\ni: yes\nj: Off\n"
            "k: 64,64\nl: path/to:x\nm: -.5\nlist:\n- 1\n- two\n- 3.0\nnested:\n  x:\n    y: true\n")
    assert config.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: 'quoted'", "a: [1, 2]", "a: {b: 1}", "a: &x 1", "a: *x", "a: !!str 1", "a: |\n  x",
    "---\na: 1", "a:\n- b: 1", "a: 010", "a: 0x1f", "a: 12:30", "a: 2001-12-14",
    "a: 1\n  b: 2", "a: 1\na: 2", "a:\n\t- 1",
])
def test_config_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        config.parse_yaml(text)


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    """A catalog pickled by the JAX package's classes: 16 objects, each with
    a normalized point cloud on disk."""
    root = tmp_path_factory.mktemp("ae_catalog")
    models = root / "3D-FUTURE-model"
    rng = np.random.default_rng(0)
    objects = []
    for i in range(N_OBJECTS):
        jid = f"jid_{i:02d}"
        (models / jid).mkdir(parents=True)
        pts = rng.uniform(-0.5, 0.5, (256, 3)) * rng.uniform(0.3, 1.0, 3)
        np.savez(models / jid / "raw_model_norm_pc.npz", points=pts.astype(np.float16))
        objects.append(JThreedFutureModel(
            f"uid_{i}", jid, JAsset("misc", "desk" if i % 2 else "chair", "modern", None, "wood"),
            [0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0], [1.0, 1.0, 1.0], str(models)))
    path = root / "threed_future_model_bedroom.pkl"
    JThreedFutureDataset(objects).pickle(str(path))
    cfg = root / "ae.yaml"
    cfg.write_text(AE_YAML)
    return {"root": root, "pkl": str(path), "models": models, "cfg": str(cfg)}


def test_jax_pickled_catalog_loads_through_the_port(catalog):
    ds = ThreedFutureNormPCDataset.from_pickled_dataset(catalog["pkl"], num_samples=N_POINTS)
    assert isinstance(ds, ThreedFutureNormPCDataset) and len(ds) == N_OBJECTS
    obj = ds.objects[3]
    assert type(obj) is ThreedFutureModel and obj.label == "desk"
    item = ds[3]
    assert item["points"].shape == (N_POINTS, 3) and item["points"].dtype == np.float32
    assert ds.get_model_jid(3) == {"model_jid": "jid_03"}
    batch = ds.collate_fn([ds[0], ds[1]])
    assert batch["points"].shape == (2, N_POINTS, 3)


def test_unpickler_refuses_other_jax_package_classes(tmp_path):
    """A JAX-package class outside data/raw.py and data/threed_future.py (here
    the encoding's Bounds) has no copy the unpickler maps to: refused."""
    from diffuscene_tpu.data.encoding import Bounds

    path = tmp_path / "other.pkl"
    with open(path, "wb") as f:
        pickle.dump(Bounds(translations=(np.zeros(3), np.ones(3)), sizes=(np.zeros(3), np.ones(3)),
                           angles=(np.zeros(1), np.ones(1))), f)
    with pytest.raises(pickle.UnpicklingError):
        ThreedFutureNormPCDataset.from_pickled_dataset(str(path))


def test_entry_points_default_to_the_card():
    for fn, name in ((SceneDiffusion.__init__, "device"),
                     (autoencoder.KLAutoEncoder.__init__, "device"),
                     (autoencoder.build_autoencoder, "device"),
                     (AETrainer.__init__, "device")):
        assert inspect.signature(fn).parameters[name].default == "cuda", fn
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            autoencoder.KLAutoEncoder(latent_dim=8)


def test_checkpoint_naming_and_resume(tmp_path):
    assert checkpoint.latest_epoch(str(tmp_path / "missing")) is None
    assert checkpoint.load_checkpoint(str(tmp_path)) == (None, None)
    for epoch in (3, 12, 7):
        checkpoint.save_checkpoint({"epoch": epoch, "w": torch.full((2,), float(epoch))},
                                   str(tmp_path), epoch)
    (tmp_path / "model_00099.tmp").write_text("partial")       # not a checkpoint
    assert sorted(os.listdir(tmp_path))[:3] == ["model_00003", "model_00007", "model_00012"]
    assert checkpoint.latest_epoch(str(tmp_path)) == 12
    state, epoch = checkpoint.load_checkpoint(str(tmp_path))
    assert epoch == 12 and state["epoch"] == 12
    state, epoch = checkpoint.load_checkpoint(str(tmp_path), epoch=3)
    assert torch.equal(state["w"], torch.full((2,), 3.0))


def test_train_resume_and_generate_cli(catalog, tmp_path):
    out = tmp_path / "out"
    args = [catalog["cfg"], str(out), "--experiment_tag", "ae", "--path_to_pickled_dataset",
            catalog["pkl"], "--num_samples", str(N_POINTS), "--device", "cpu", "--seed", "3"]
    train_objautoencoder.main(args)
    exp = out / "ae"
    assert checkpoint.latest_epoch(str(exp)) == 0
    state, _ = checkpoint.load_checkpoint(str(exp))
    assert state["step"] == N_OBJECTS // BATCH                   # 1 epoch of 2 steps
    stats = (exp / "stats.txt").read_text()
    assert "epoch: 0" in stats and "loss.cd" in stats and "gradnorm" in stats
    assert json.loads((exp / "params.json").read_text())["experiment_tag"] == "ae"

    # resume: the second run picks up epoch 0 and trains epoch 1
    train_objautoencoder.main(args + ["--epochs", "2"])
    state1, epoch1 = checkpoint.load_checkpoint(str(exp))
    assert epoch1 == 1 and state1["step"] == 2 * (N_OBJECTS // BATCH)
    assert state1["optimizer"]["count"] == state1["step"]
    assert not torch.equal(state1["model"]["fc.weight"], state["model"]["fc.weight"])

    generate_objautoencoder.main([catalog["cfg"], str(exp), "--path_to_pickled_dataset",
                                  catalog["pkl"], "--num_samples", str(N_POINTS),
                                  "--batch_size", "5", "--device", "cpu"])
    lat = np.load(catalog["models"] / "jid_04" / "raw_model_norm_pc_lat32.npz")["latent"]
    assert lat.shape == (32,) and lat.dtype == np.float32 and np.isfinite(lat).all()
    # the latents are the trained encoder's deterministic code of the points
    # the CLI drew (the dataset's sampler starts from seed 0 on every load)
    model = autoencoder.KLAutoEncoder(latent_dim=32, device="cpu").eval()
    model.load_state_dict(state1["model"])
    ds = ThreedFutureNormPCDataset.from_pickled_dataset(catalog["pkl"], num_samples=N_POINTS)
    pts = torch.from_numpy(np.stack([ds[i]["points"] for i in range(5)]))
    with torch.no_grad():
        want = model.encode(pts, deterministic=True)[1][4].numpy()
    np.testing.assert_allclose(lat, want, atol=1e-5, rtol=0)
    stats = json.loads((exp / "lat32_stats.json").read_text())
    assert stats["latent_dim"] == 32 and stats["n_objects"] == N_OBJECTS
    assert stats["std"] > 0 and np.isclose(stats["scale_factor"], 1 / stats["std"])

    # a reference .pt state_dict loads straight into the module
    pt = tmp_path / "ref.pt"
    torch.save(state1["model"], pt)
    generate_objautoencoder.main([catalog["cfg"], str(exp), "--path_to_pickled_dataset",
                                  catalog["pkl"], "--num_samples", str(N_POINTS),
                                  "--weight_file", str(pt), "--output_directory",
                                  str(tmp_path / "lats"), "--lat_name", "lat", "--device", "cpu"])
    assert (tmp_path / "lats" / "jid_04_norm_pc_lat.npz").exists()


def test_clis_default_to_the_card(catalog, tmp_path):
    """Without --device the CLIs build the model on the card, which this
    torch (CPU only) refuses."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default is exercised by chip_smoke.py")
    with pytest.raises((RuntimeError, AssertionError)):
        train_objautoencoder.main([catalog["cfg"], str(tmp_path), "--path_to_pickled_dataset",
                                   catalog["pkl"], "--num_samples", str(N_POINTS)])
    with pytest.raises((RuntimeError, AssertionError)):
        generate_objautoencoder.main([catalog["cfg"], str(tmp_path), "--path_to_pickled_dataset",
                                      catalog["pkl"], "--num_samples", str(N_POINTS)])


def test_wandb_flag_is_refused(catalog, tmp_path):
    with pytest.raises(SystemExit, match="W&B"):
        train_objautoencoder.main([catalog["cfg"], str(tmp_path), "--path_to_pickled_dataset",
                                   catalog["pkl"], "--with_wandb_logger", "--device", "cpu"])
