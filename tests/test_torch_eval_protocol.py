"""The port's synthetic eval protocol (diffuscene_tpu_torch/cli/eval_protocol.py)
on the CPU, against the JAX script (tools/eval_protocol_r5.py) where the two
can see the same inputs.

- The derived config, written by the port's YAML writer and read by its
  reader, equals the JAX script's edits applied with pyyaml to the same file.
- A whole tiny run (``--device cpu``; a dim-64 copy of the flagship config at
  20 diffusion steps, 40 rooms, 4 + 4 generated scenes) writes every stage's
  files and the report's keys, and its metrics equal what the CLIs wrote.
- Its GT renders equal the JAX package's ``render_scene_dict`` on the same
  rooms' boxes, pixel for pixel.
- A second run on the same directory skips every stage and returns the same
  metrics.
- ``--device cuda`` raises where there is no card.
"""
import json
import os

import numpy as np
import pytest
import torch
import yaml

from diffuscene_tpu_torch.cli import eval_protocol
from diffuscene_tpu_torch.eval.png import read_png
from diffuscene_tpu_torch.utils.config import dump_yaml, load_config
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, eval_protocol.CONFIG)
SCALE = ["--rooms", "40", "--epochs", "2", "--n_sequences", "4", "--n_extra", "4",
         "--batch_size", "4", "--steps_per_dispatch", "2", "--ipr_samples", "8",
         "--revision", "test", "--device", "cpu"]


def _tiny_config(path):
    """The flagship config at dim 64 and 20 diffusion steps, 8 scenes a
    train batch and 4 a validation batch."""
    with open(FLAGSHIP) as f:
        cfg = yaml.safe_load(f)
    cfg["network"]["net_kwargs"]["dim"] = 64
    cfg["network"]["diffusion_kwargs"]["time_num"] = 20
    cfg["training"]["batch_size"] = 8
    cfg["validation"]["batch_size"] = 4
    with open(path, "w") as f:
        f.write(dump_yaml(cfg))
    return str(path)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One whole tiny run: (its workdir, its report)."""
    root = tmp_path_factory.mktemp("protocol")
    work = root / "work"
    report = eval_protocol.main([str(work), "--config", _tiny_config(root / "tiny.yaml")]
                                + SCALE)
    return work, report


def test_derived_config_is_the_jax_scripts(tmp_path):
    """derive_config, written by dump_yaml and read back by load_config,
    equals tools/eval_protocol_r5.py:72-79 applied with pyyaml."""
    data_dir = str(tmp_path / "cached")
    path = tmp_path / "config.yaml"
    path.write_text(dump_yaml(eval_protocol.derive_config(FLAGSHIP, data_dir, 160)))
    with open(FLAGSHIP) as f:
        cfg = yaml.safe_load(f)
    cfg["data"].update(dataset_directory=data_dir,
                       annotation_file=os.path.join(data_dir, "splits.csv"))
    del cfg["data"]["path_to_invalid_scene_ids"], cfg["data"]["path_to_invalid_bbox_jids"]
    del cfg["data"]["filter_fn"]
    cfg["training"].update(epochs=160, save_frequency=40, ema_decay=0.9999)
    cfg["validation"].update(frequency=10_000)
    assert load_config(str(path)) == cfg
    assert yaml.safe_load(path.read_text()) == cfg


def test_whole_run_writes_every_stage(run):
    """Every stage ran and wrote its files; the report holds every stage,
    every metric row (the backbones' refusals among them) and the card
    entry, and its generate metrics equal the metrics.json files."""
    work, report = run
    assert list(report["stages"]) == list(eval_protocol.STAGES)
    assert not any(s["skipped"] for s in report["stages"].values())
    for name in eval_protocol.STAGES:
        assert (work / "stages" / f"{name}.json").is_file()
    assert (work / "exp" / "protocol" / "model_00001").is_file()
    assert len(list((work / "gen_protocol").glob("*_boxes.npz"))) == 4
    assert (work / "gen_protocol" / "iou_states.txt").is_file()
    assert len(list((work / "fake_5000").glob("*.png"))) == 8
    assert len(list((work / "gt_renders").glob("*.png"))) == 8
    assert report["n_synth_renders"] == 8
    with open(work / "gen_protocol" / "metrics.json") as f:
        assert report["generate_metrics"] == json.load(f)
    with open(work / "gen_extra" / "metrics.json") as f:
        assert report["generate_extra_metrics"] == json.load(f)
    assert {"categorical_kl", "avg_objects", "avg_intersec"} <= set(report["generate_metrics"])
    assert "InceptionV3" in report["fid_protocol"]["blocked"]
    assert "VGG16" in report["ipr_protocol"]["blocked"]
    for key in ("fid_protocol_pixel", "fid_control_half_vs_half_pixel"):
        assert np.isfinite([report[key]["fid"], report[key]["kid"]]).all()
        assert report[key]["comparable"] is False
    for key in ("ipr_protocol_pixel", "ipr_5000x5000_pixel"):
        assert np.isfinite([report[key]["precision"], report[key]["recall"],
                            report[key]["realism_mean"]]).all()
    train = report["stages"]["train"]
    # 36 train + val rooms in batches of 8: 4 steps an epoch
    assert train["steps"] == 8 == 2 * train["batches_per_epoch"]
    assert train["step_probe"]["graphed"] is False and train["step_probe"]["ms_per_step"] > 0
    # the CPU runs the kernels' plain versions: no launch is counted
    assert report["card"]["launches"] == {"generate_1000": {"B1": 0, "B2": 0},
                                          "generate_4000": {"B1": 0, "B2": 0}}
    assert report["card"]["revision"] == "test"
    with open(work / "eval_protocol.json") as f:
        assert json.load(f) == report


def test_gt_renders_are_the_jax_packages(run):
    """The GT renders, read back from their PNGs, equal the JAX package's
    render_scene_dict on the same rooms' boxes."""
    from diffuscene_tpu.eval.render import render_scene_dict

    work, _ = run
    rooms = sorted(d for d in os.listdir(work / "cached") if d.startswith("SynthRoom_"))[:8]
    for i, room in enumerate(rooms):
        z = np.load(work / "cached" / room / "boxes.npz")
        want = render_scene_dict({k: z[k] for k in ("translations", "sizes", "angles",
                                                     "class_labels")})
        got = read_png(str(work / "gt_renders" / f"{i:05d}.png"))
        np.testing.assert_array_equal(got, want)


def test_second_run_skips_every_stage(run, tmp_path):
    """A second run on the same directory skips every stage and reads back
    the same seconds and metrics."""
    work, report = run
    again = eval_protocol.main([str(work), "--config", report["protocol"]["config"],
                                "--out", str(tmp_path / "again.json")] + SCALE)
    assert all(s["skipped"] for s in again["stages"].values())
    strip = lambda r: {k: v for k, v in r.items() if k != "stages"}
    assert strip(again) == strip(report)
    for name, stage in report["stages"].items():
        assert dict(again["stages"][name], skipped=False) == stage


def test_device_cuda_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no card")
    with pytest.raises(SystemExit, match="no CUDA device"):
        eval_protocol.main([str(tmp_path / "work")])
    assert not (tmp_path / "work").exists()
