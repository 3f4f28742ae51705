"""The port's completion_rearrange CLI end to end on the CPU, on a tiny
synthetic cached dataset: the train CLI on a tiny rearrange config (the
arrange head, 5 diffused channels through init_conv/final_conv) then
re-arrangement on its checkpoint, completion on a tiny unconditional model
from a reference-format ``.pt``, and each render and mesh flag with its
outputs (a synthetic textured-box catalog where the flag needs one).  Tiny
sizes: dim 32, 2 levels, 4 steps.
"""
import json
import os

import numpy as np
import pytest
import torch
import yaml

from diffuscene_tpu_torch.data import make_synthetic_cached_dataset, make_synthetic_catalog
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


ENCODING = "cached_diffusion_cosin_angle_objfeatsnorm_lat32_wocm"


def _config(root, arrange, data_dir=None):
    """A tiny config over a synthetic dataset (made here unless
    ``data_dir`` is given): the rearrange config's shape with ``arrange``,
    else the unconditional model's."""
    if data_dir is None:
        data_dir = str(root / "cached")
        make_synthetic_cached_dataset(data_dir, n_scenes=24, seed=0)
    inst, arr = 16, 16
    nk = {"dim": 32, "dim_mults": [1, 1], "channels": 62, "objectness_dim": 0,
          "class_dim": 22, "angle_dim": 2, "objfeat_dim": 32, "context_dim": 0,
          "instanclass_dim": inst, "seperate_all": True}
    net = {"type": "diffusion_scene_layout_ddpm", "net_type": "unet1d", "point_dim": 62,
           "room_mask_condition": False, "sample_num_points": 12, "objectness_dim": 0,
           "class_dim": 22, "angle_dim": 2, "objfeat_dim": 32, "learnable_embedding": True,
           "instance_condition": True, "instance_emb_dim": inst,
           "diffusion_kwargs": {"schedule_type": "linear", "time_num": 4,
                                "model_mean_type": "v", "model_var_type": "fixedsmall",
                                "loss_separate": True, "loss_iou": True},
           "net_kwargs": nk}
    if arrange:
        net.update(room_arrange_condition=True, arrange_emb_dim=arr)
        nk.update(channels=5, out_dim=5, seperate_all=False, instanclass_dim=inst + arr)
    cfg = {
        "data": {"dataset_type": "cached_threedfront", "encoding_type": ENCODING,
                 "dataset_directory": data_dir,
                 "annotation_file": os.path.join(data_dir, "splits.csv"),
                 "augmentations": ["fixed_rotations"], "train_stats": "dataset_stats.txt",
                 "room_layout_size": "64,64", "max_length": 12},
        "network": net,
        "training": {"splits": ["train", "val"], "epochs": 1, "batch_size": 8,
                     "save_frequency": 1, "max_grad_norm": 10, "optimizer": "Adam",
                     "schedule": "step", "lr": 2e-4, "lr_step": 10000, "lr_decay": 0.5,
                     "ema_decay": 0.9},
        "validation": {"splits": ["test"], "frequency": 1, "batch_size": 2},
        "logger": {"type": "stats"},
    }
    path = str(root / ("arrange.yaml" if arrange else "uncond.yaml"))
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _outputs(out_dir, n):
    """The box files (each scene's attributes finite) and metrics.json."""
    boxes = sorted(f for f in os.listdir(out_dir) if f.endswith("_boxes.json"))
    assert boxes == [f"{i:05d}_boxes.json" for i in range(n)]
    for name in boxes:
        with open(os.path.join(out_dir, name)) as f:
            scene = json.load(f)
        assert {"translations", "sizes", "angles", "class_labels"} <= scene.keys()
        assert np.isfinite(np.asarray(scene["sizes"], np.float64)).all()
    with open(os.path.join(out_dir, "metrics.json")) as f:
        metrics = json.load(f)
    assert metrics["n_scenes"] == n and all(np.isfinite(v) for v in metrics.values())
    with open(os.path.join(out_dir, "iou_states.txt")) as f:
        assert len(f.read().splitlines()) == n
    return metrics


def test_rearrange_train_then_arrange_cli(tmp_path):
    """train_diffusion on the tiny rearrange config for 1 epoch (the EMA
    and the checkpoint carry the arrange head), then completion_rearrange
    --arrange_objects --fused --compute_intersec on its EMA weights: 3
    scenes in batches of 2, the box files, iou_states.txt and metrics.json;
    a --scene_id not in the eval split raises."""
    from diffuscene_tpu_torch.cli.completion_rearrange import main as task_main
    from diffuscene_tpu_torch.cli.train_diffusion import main as train_main
    from diffuscene_tpu_torch.utils.checkpoint import load_checkpoint

    cfg = _config(tmp_path, arrange=True)
    out = str(tmp_path / "out")
    train_main([cfg, out, "--experiment_tag", "arr", "--seed", "0", "--device", "cpu"])
    exp = os.path.join(out, "arr")
    state, epoch = load_checkpoint(exp)
    assert epoch == 0 and state["step"] == 2        # 20 scenes // 8 a epoch
    head = {f"conditioner.fc_arrange_condition.{i}.weight" for i in (0, 2)}
    assert head <= state["model"].keys() and head <= state["ema"].keys()

    arranged = str(tmp_path / "arranged")
    metrics = task_main([cfg, arranged, "--weight_file", exp, "--arrange_objects", "--fused",
                         "--clip_denoised", "--compute_intersec", "--n_sequences", "3",
                         "--batch_size", "2", "--device", "cpu"])
    assert _outputs(arranged, 3) == metrics
    with pytest.raises(SystemExit, match="not in the eval split"):
        task_main([cfg, arranged, "--weight_file", exp, "--arrange_objects", "--scene_id",
                   "no_such_room", "--device", "cpu"])


def test_completion_cli_from_reference_weights(tmp_path):
    """completion_rearrange --num_partial 3 --fused --compute_intersec on a
    tiny unconditional model whose weights come as a reference-format
    ``.pt`` (``diffusion.model.*`` keys and the bare head names): 3 scenes,
    the box files and a finite metrics.json."""
    from diffuscene_tpu_torch.cli.completion_rearrange import main as task_main
    from diffuscene_tpu_torch.models import SceneDiffusion, SceneModelConfig
    from diffuscene_tpu_torch.utils.config import load_config

    cfg = _config(tmp_path, arrange=False)
    scene = SceneDiffusion(SceneModelConfig.from_config(load_config(cfg)["network"]),
                           device="cpu").init(torch.Generator().manual_seed(3))
    ref = {("diffusion.model." + k[len("denoiser."):] if k.startswith("denoiser.")
            else k[len("conditioner."):]): v for k, v in scene.networks.state_dict().items()}
    weights = str(tmp_path / "reference.pt")
    torch.save(ref, weights)
    completed = str(tmp_path / "completed")
    metrics = task_main([cfg, completed, "--weight_file", weights, "--num_partial", "3",
                         "--fused", "--compute_intersec", "--n_sequences", "3",
                         "--batch_size", "2", "--device", "cpu"])
    assert _outputs(completed, 3) == metrics


@pytest.fixture(scope="module")
def flag_setup(tmp_path_factory):
    """A tiny unconditional config over a synthetic dataset and a textured-box
    catalog of its classes (data.make_synthetic_catalog)."""
    from diffuscene_tpu_torch.data.factory import get_raw_dataset
    from diffuscene_tpu_torch.utils.config import load_config

    root = tmp_path_factory.mktemp("flags")
    cfg = _config(root, arrange=False)
    raw = get_raw_dataset(load_config(cfg)["data"], split=["test"])
    return cfg, make_synthetic_catalog(str(root / "catalog"), raw.class_labels, seed=0)


def _png_names(folder):
    return sorted(f for f in os.listdir(folder) if f.endswith(".png"))


# flags that need the catalog get it as the flag form; the last two cases
# are the catalog itself, as the flag and as the third positional
_NEEDS_CATALOG = {"--render_perspective", "--with_rotating_camera", "--save_mesh",
                  "--judge_mesh_intersec"}


@pytest.mark.parametrize("flags", [
    ["--render"], ["--render_top2down"], ["--render_gt"], ["--render_perspective"],
    ["--with_rotating_camera"], ["--save_mesh"], ["--judge_mesh_intersec"],
    ["--path_to_pickled_3d_futute_models", "catalog.pkl"], ["catalog.pkl"],
])
def test_render_and_mesh_flags_write_their_outputs(flag_setup, tmp_path, flags):
    """Each render and mesh flag of completion_rearrange (refused before the
    evaluation path was ported) writes its output on 2 completed scenes:
    the renders with the partial inputs' in partial/, the ground truth's in
    groundtruth/, the perspective renders, the orbit frames, the mesh files
    and manifests, the judged intersection statistics, and the catalog's
    jids in the manifests (flag and positional)."""
    from diffuscene_tpu_torch.cli.completion_rearrange import main as task_main
    from diffuscene_tpu_torch.data import ThreedFutureDataset

    cfg, catalog = flag_setup
    flags = [catalog if f == "catalog.pkl" else f for f in flags]
    extra = ["--path_to_pickled_3d_futute_models", catalog] if flags[0] in _NEEDS_CATALOG else []
    out = str(tmp_path / "out")
    metrics = task_main([cfg, out, *flags, *extra, "--n_sequences", "2", "--batch_size", "2",
                         "--compute_intersec", "--n_frames", "2", "--window_size", "40,32",
                         "--device", "cpu"])
    names = ["00000.png", "00001.png"]
    with open(os.path.join(out, "metrics.json")) as f:
        assert json.load(f) == metrics and metrics["n_scenes"] == 2
    if flags[0] in ("--render", "--render_top2down"):
        assert _png_names(out) == names == _png_names(os.path.join(out, "partial"))
    elif flags[0] == "--render_gt":
        assert _png_names(os.path.join(out, "groundtruth")) == names
        assert _png_names(out) == []
    elif flags[0] == "--render_perspective":
        assert _png_names(out) == ["00000_persp.png", "00001_persp.png"]
    elif flags[0] == "--with_rotating_camera":
        for i in range(2):
            assert _png_names(os.path.join(out, "frames", f"{i:05d}")) == names
    elif flags[0] == "--save_mesh":
        mesh = os.path.join(out, "scene_mesh")
        assert sorted(f for f in os.listdir(mesh) if f.endswith(".obj")) == ["00000.obj",
                                                                              "00001.obj"]
        for i in range(2):
            with open(os.path.join(out, f"{i:05d}_scene.json")) as f:
                n = len(json.load(f))
            assert len([f for f in os.listdir(os.path.join(mesh, f"{i:05d}"))
                        if f.endswith(".obj")]) == n
    elif flags[0] == "--judge_mesh_intersec":
        boxes_only = task_main([cfg, str(tmp_path / "boxes"), "--n_sequences", "2",
                                "--batch_size", "2", "--compute_intersec", "--device", "cpu"])
        assert metrics["avg_intersec"] <= boxes_only["avg_intersec"]
        assert metrics["avg_pair_iou"] <= boxes_only["avg_pair_iou"]
    else:   # the catalog, as the flag or the positional: with --save_mesh, its jids
        task_main([cfg, out, *flags, "--save_mesh", "--n_sequences", "1", "--device", "cpu"])
        jids = {o.model_jid for o in ThreedFutureDataset.from_pickled_dataset(catalog)}
        with open(os.path.join(out, "00000_scene.json")) as f:
            assert {m["model_jid"] for m in json.load(f)} <= jids
    with pytest.raises(SystemExit, match="needs a retrieved catalog"):
        task_main([cfg, out, "--compute_intersec", "--judge_mesh_intersec", "--device", "cpu"])
