"""The port's text-conditioned entry points on the CPU: train_diffusion on a
text config (the 768-wide token width from the network's flags, desc_emb
reaching get_loss as text_emb), then generate_diffusion --fused on its
checkpoint, conditioned on eval scenes' descriptions: with --fix_order the
eval scenes in order, with --scene_id one scene for every sequence, else
scenes drawn from np.random.default_rng(seed) as the JAX CLI draws them.
Each scene's sentence goes to {idx:05d}.txt and equals the JAX package's
``textfix`` description of the same eval scene, the eval set read in the
same order (the config's fixed rotations stay on in the eval encoding, as
in the JAX CLI, and draw from the pipeline's generator).

A synthetic dataset of 24 rooms (21 train/val, 3 test), dim 32, 4 levels,
8 diffusion steps, 3 DPM-Solver++ steps.  Then each configs/text model at
its full width samples on the CPU through every path and sampler.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
import yaml

from diffuscene_tpu.data.factory import get_dataset_raw_and_encoded as j_get_dataset
from diffuscene_tpu_torch.data import make_synthetic_cached_dataset
from diffuscene_tpu_torch.models import SceneDiffusion, SceneModelConfig
from diffuscene_tpu_torch.utils.config import load_config
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENCODING = "cached_diffusion_text_cosin_angle_objfeatsnorm_lat32_wocm"


def _text_config(root):
    data_dir = str(root / "cached")
    make_synthetic_cached_dataset(data_dir, n_scenes=24, seed=0)
    nk = {"dim": 32, "dim_mults": [1, 1, 1, 1], "channels": 62, "objectness_dim": 0,
          "class_dim": 22, "angle_dim": 2, "objfeat_dim": 32, "context_dim": 0,
          "instanclass_dim": 16, "seperate_all": True, "text_condition": True,
          "text_dim": 24}
    data = {"dataset_type": "cached_threedfront", "encoding_type": ENCODING,
            "dataset_directory": data_dir,
            "annotation_file": os.path.join(data_dir, "splits.csv"),
            "augmentations": ["fixed_rotations"], "train_stats": "dataset_stats.txt",
            "room_layout_size": "64,64", "max_length": 12}
    cfg = {
        "data": data,
        "network": {"type": "diffusion_scene_layout_ddpm", "net_type": "unet1d",
                    "point_dim": 62, "room_mask_condition": False, "sample_num_points": 12,
                    "objectness_dim": 0, "class_dim": 22, "angle_dim": 2, "objfeat_dim": 32,
                    "learnable_embedding": True, "instance_condition": True,
                    "instance_emb_dim": 16, "text_condition": True, "text_embed_dim": 24,
                    "diffusion_kwargs": {"schedule_type": "linear", "time_num": 8,
                                         "model_mean_type": "v",
                                         "model_var_type": "fixedsmall",
                                         "loss_separate": True, "loss_iou": True},
                    "net_kwargs": nk},
        "training": {"splits": ["train", "val"], "epochs": 2, "batch_size": 8,
                     "save_frequency": 1, "max_grad_norm": 10, "optimizer": "Adam",
                     "schedule": "step", "lr": 2e-4, "lr_step": 10000, "lr_decay": 0.5,
                     "ema_decay": 0.9},
        "validation": {"splits": ["test"], "frequency": 1, "batch_size": 2},
        "logger": {"type": "stats"},
    }
    path = str(root / "text.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path, data


def _sentences(out_dir, n):
    names = sorted(f for f in os.listdir(out_dir) if f.endswith(".txt"))
    assert names == [f"{i:05d}.txt" for i in range(n)]
    out = []
    for name in names:
        with open(os.path.join(out_dir, name)) as f:
            out.append(f.read())
    return out


def test_text_train_then_generate_cli_on_cpu(tmp_path):
    """train_diffusion for 2 epochs on the text config, then three
    generate_diffusion --fused runs on its EMA checkpoint: every scene's
    boxes and sentence written; the sentences are JAX's textfix eval
    descriptions of the scenes --fix_order walks, of --scene_id's scene,
    and of the scenes default_rng(seed) draws."""
    from diffuscene_tpu_torch.cli.generate_diffusion import main as gen_main
    from diffuscene_tpu_torch.cli.train_diffusion import main as train_main
    from diffuscene_tpu_torch.utils.checkpoint import load_checkpoint

    cfg, data = _text_config(tmp_path)
    out = str(tmp_path / "out")
    train_main([cfg, out, "--experiment_tag", "text", "--seed", "0", "--device", "cpu"])
    exp = os.path.join(out, "text")
    state, epoch = load_checkpoint(exp)
    assert epoch == 1 and state["step"] == 2 * 2 and state["ema"] is not None
    assert state["model"]["conditioner.fc_text_f.weight"].shape == (24, 768)

    def jax_eval_set():
        return j_get_dataset(
            {**data, "encoding_type": ENCODING.replace("text", "textfix") + "_no_prm",
             "text_emb_dim": 768}, augmentations=None, split=["test"])

    raw_j, eval_j = jax_eval_set()
    k = len(eval_j)
    assert k == 3
    n, bsz, seed = 6, 4, 3
    rng = np.random.default_rng(seed)
    drawn = [int(rng.integers(k)) for _ in range(2 * bsz)]   # two batches of 4
    runs = {"fix_order": (["--fix_order"], [i % k for i in range(2 * bsz)]),
            "scene_id": (["--scene_id", raw_j.scene_ids[1]], [1] * (2 * bsz)),
            "random": ([], drawn)}
    for name, (flags, indices) in runs.items():
        gen = str(tmp_path / name)
        stats = gen_main([cfg, gen, "--weight_file", exp, "--n_sequences", str(n),
                          "--batch_size", str(bsz), "--fused", "--dpm", "--dpm_steps", "3",
                          "--seed", str(seed), "--device", "cpu", *flags])
        assert stats["n_scenes"] == n and np.isfinite(stats["categorical_kl"])
        assert len([f for f in os.listdir(gen) if f.endswith("_boxes.npz")]) == n
        # the JAX eval set read in the CLI's order (its fixed rotations draw
        # from the pipeline's generator, so the order matters)
        _, eval_j = jax_eval_set()
        want = [eval_j[i]["description"] for i in indices][:n]
        got = _sentences(gen, n)
        assert got == want, name
        assert all(w.startswith("The room has ") for w in got)
        if name == "scene_id":   # one scene: the same objects in every sentence
            assert len({w.split(" . ")[0] for w in got}) == 1
    with pytest.raises(SystemExit, match="not in the eval split"):
        gen_main([cfg, str(tmp_path / "bad"), "--scene_id", "no-such-room", "--device", "cpu"])


@pytest.mark.parametrize("config", sorted(os.listdir(os.path.join(REPO, "configs/text"))))
def test_text_configs_sample_on_the_cpu(config):
    """Each configs/text model at full width (dim 512, 50 tokens of 768
    through fc_text_f), random weights, B=2, its schedule cut to 4 steps:
    DDPM, DDIM (3 steps) and DPM-Solver++ (3 steps) through the module, the
    3-D engine and the rows engine give finite samples of the config's
    shape; the two engines agree within 1e-4 (both run the tanh GELU), the
    module within 5e-3 of them (its exact GELU; the JAX package's
    fused-vs-module sample tolerance, tests/test_fused_engine.py)."""
    net = load_config(os.path.join(REPO, "configs/text", config))["network"]
    cfg = dataclasses.replace(SceneModelConfig.from_config(net), time_num=4)
    scene = SceneDiffusion(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    te = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 50, 768)).astype(np.float32))
    shape = (2, cfg.sample_num_points, cfg.point_dim)
    for kw in ({}, {"ddim": True, "ddim_steps": 3}, {"dpm": True, "dpm_steps": 3}):
        outs = {fused: scene.sample(2, generator=torch.Generator().manual_seed(2), fused=fused,
                                    clip_denoised=True, text_emb=te, **kw)
                for fused in (False, True, "rows")}
        for fused, out in outs.items():
            assert out.shape == shape and torch.isfinite(out).all(), (kw, fused)
        torch.testing.assert_close(outs["rows"], outs[True], atol=1e-4, rtol=0)
        torch.testing.assert_close(outs[False], outs[True], atol=5e-3, rtol=1e-2)
