"""The synthetic evaluation protocol, end to end, through the port's CLIs.

Port of ``tools/eval_protocol_r5.py``: one resumable run of the pipeline
the reference publishes (run/generate.sh, compute_fid_scores.py:113-116,
improved_precision_recall.py:377-379), at that script's scale unless the
arguments cut it:

1. ``dataset``: a synthetic bedroom dataset (``--rooms`` rooms, 80/10/10
   train/val/test, at most 12 objects, seed 0) and the config edited to
   read it as the JAX script edits it (``tools/eval_protocol_r5.py:72-82``):
   the dataset paths set, the invalid-scene lists and the filter dropped,
   ``--epochs`` epochs, a checkpoint every 40, EMA decay 0.9999, no
   mid-train validation.  It is written as YAML that ``utils/config.py``
   reads back equal (``dump_yaml``: the card's machine has no pyyaml);
2. ``train``: ``cli/train_diffusion`` with ``--steps_per_dispatch`` steps a
   call (on the card ``train_step_scan`` replays the step's CUDA graph);
   then the config's step is timed alone (``Trainer.train_step`` from its
   graph on the card, on one batch on the device) beside the host's time to
   assemble a batch, the train loader's pace;
3. ``generate_1000``: ``cli/generate_diffusion`` DDPM on the raw weights
   with renders and the box metrics (run/generate.sh's flags, seed 0), the
   B1/B2 launches read from the wrappers' counters;
4. ``generate_4000``: ``--n_extra`` more with renders only (seed 1), then
   every non-perspective render of both linked into ``fake_5000``;
5. ``render_gt``: the first ``--n_sequences`` + ``--n_extra`` rooms in
   sorted order rendered from their boxes;
6. ``fid``, ``fid_control``: ``cli/compute_fid_scores``, InceptionV3 first
   (its refusal without local weights recorded), then pixel features: GT
   against the protocol's scenes and GT half against half;
7. ``ipr_protocol``, ``ipr_5000x5000``: ``cli/improved_precision_recall``
   with ``--realism``, VGG16 first (its refusal recorded), then pixel
   features against the protocol's scenes and against ``fake_5000``.

It writes one JSON (``--out``, default ``WORKDIR/eval_protocol.json``):
every stage's seconds, every metric, generate's ``metrics.json`` and a
``card`` entry (the card's name and power limit as nvidia-smi gives them,
the revision, the launch counts of each generate stage).

Resumable: each stage writes a record, ``WORKDIR/stages/NAME.json``, after
its outputs; a stage whose record and outputs exist is skipped and marked
skipped, its seconds and metrics read back, not recomputed.  The train
stage skips only once the final epoch's checkpoint exists (the JAX script
skips once any checkpoint exists); otherwise it calls the train CLI again,
whose auto-resume continues from the last checkpoint.  ``--device cuda``
(the default) raises on a machine without a card; nothing falls back to
the CPU unless ``--device cpu`` asks for it.

    python -m diffuscene_tpu_torch.cli.eval_protocol WORKDIR [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

CONFIG = "configs/uncond/diffusion_bedrooms_instancond_lat32_v.yaml"
STAGES = ("dataset", "train", "generate_1000", "generate_4000", "render_gt", "fid",
          "fid_control", "ipr_protocol", "ipr_5000x5000")
STEP_PROBE_STEPS = 20       # timed graphed train steps, after a warm step and a capture


def build_parser() -> argparse.ArgumentParser:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser = argparse.ArgumentParser(description="The synthetic eval protocol, end to end "
                                     "(PyTorch port)")
    parser.add_argument("workdir", help="where the dataset, checkpoints and renders go")
    parser.add_argument("--out", default=None,
                        help="the report's path (default WORKDIR/eval_protocol.json)")
    parser.add_argument("--config", default=os.path.join(root, CONFIG))
    parser.add_argument("--rooms", type=int, default=6250,
                        help="synthetic rooms, 80/10/10 train/val/test")
    parser.add_argument("--epochs", type=int, default=160)
    parser.add_argument("--n_sequences", type=int, default=1000,
                        help="the protocol's generated scenes (run/generate.sh)")
    parser.add_argument("--n_extra", type=int, default=4000,
                        help="more generated renders, to as many as the GT renders")
    parser.add_argument("--batch_size", type=int, default=250, help="generate's batch")
    parser.add_argument("--steps_per_dispatch", type=int, default=8)
    parser.add_argument("--ipr_samples", type=int, default=5000)
    parser.add_argument("--k", type=int, default=3)
    parser.add_argument("--revision", default=None,
                        help="what the checkout was made from, recorded in the report; read "
                        "from git when not given")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def derive_config(config_path: str, data_dir: str, epochs: int) -> Dict[str, Any]:
    """The config with the JAX script's edits (tools/eval_protocol_r5.py:72-79)."""
    from ..utils.config import load_config

    cfg = load_config(config_path)
    cfg["data"].update(dataset_directory=data_dir,
                       annotation_file=os.path.join(data_dir, "splits.csv"))
    del cfg["data"]["path_to_invalid_scene_ids"], cfg["data"]["path_to_invalid_bbox_jids"]
    del cfg["data"]["filter_fn"]
    cfg["training"].update(epochs=epochs, save_frequency=40, ema_decay=0.9999)
    cfg["validation"].update(frequency=10_000)  # no mid-train eval in this run
    return cfg


def card_line() -> Optional[str]:
    """The card's name and power limit, as nvidia-smi gives them (None
    without nvidia-smi)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return (out.stdout.strip() or None) if out.returncode == 0 else None


def _revision(given: Optional[str]) -> str:
    if given:
        return given
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "HEAD"], cwd=os.path.dirname(os.path.abspath(__file__)),
            stderr=subprocess.DEVNULL, text=True).strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def _pngs(folder: str) -> list:
    return sorted(f for f in os.listdir(folder) if f.endswith(".png")) \
        if os.path.isdir(folder) else []


def _write_json(path: str, value: Any) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(value, f, indent=1)
    os.replace(tmp, path)


def _step_probe(cfg_path: str, device: str, state: Dict[str, Any]) -> Dict[str, Any]:
    """The config's train step alone, on one batch on the device, from the
    trained state: the median host time of STEP_PROBE_STEPS calls of
    ``Trainer.train_step`` (from its CUDA graph on the card: a warm step and
    a capture first), beside the host's time to assemble a batch as the
    train loader does."""
    from ..data.factory import get_dataset_raw_and_encoded
    from ..data.loader import collate
    from ..models.scene_model import SceneDiffusion, SceneModelConfig
    from ..train.trainer import Trainer
    from ..utils.config import load_config

    config = load_config(cfg_path)
    _, ds = get_dataset_raw_and_encoded(
        config["data"], augmentations=config["data"].get("augmentations"),
        split=config["training"].get("splits", ["train", "val"]), seed=0,
        keep_room_layout=bool(config["network"].get("room_mask_condition", True)))
    batch_size = int(config["training"].get("batch_size", 128))
    rng = np.random.default_rng(0)
    loader_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        host = collate([ds[int(i)] for i in rng.permutation(len(ds))[:batch_size]])
        loader_ms.append(1e3 * (time.perf_counter() - t0))
    net_cfg = dict(config["network"])
    net_cfg.setdefault("sample_num_points", ds.max_length)
    cfg = SceneModelConfig.from_config(net_cfg, config.get("feature_extractor"))
    bounds = ds.bounds.as_device_bounds()
    scene = SceneDiffusion(cfg, bounds=bounds if cfg.loss_iou else None, device=device)
    trainer = Trainer(scene, config["training"], device=device)
    trainer.load_state_dict(state)
    batch = trainer.put_batch(host)
    ms = []
    for _ in range(2 + STEP_PROBE_STEPS):
        t0 = time.perf_counter()
        trainer.train_step(batch)
        ms.append(1e3 * (time.perf_counter() - t0))
    return {"ms_per_step": float(np.median(ms[2:])), "graphed": trainer.graph,
            "batch_size": batch_size, "loader_ms_per_batch": float(np.median(loader_ms))}


class Protocol:
    """One run of the protocol over ``args.workdir``; :meth:`run` returns the
    report."""

    def __init__(self, args):
        self.args = args
        self.work = os.path.abspath(args.workdir)
        self.out = os.path.abspath(args.out or os.path.join(self.work, "eval_protocol.json"))
        self.data_dir = os.path.join(self.work, "cached")
        self.cfg_path = os.path.join(self.work, "config.yaml")
        self.ckpt_dir = os.path.join(self.work, "exp", "protocol")
        self.gen_dir = os.path.join(self.work, "gen_protocol")
        self.gen_dir2 = os.path.join(self.work, "gen_extra")
        self.fake = os.path.join(self.work, "fake_5000")
        self.gt_dir = os.path.join(self.work, "gt_renders")
        self.n_gt = args.n_sequences + args.n_extra
        self.report: Dict[str, Any] = {
            "workdir": self.work, "n_scenes_dataset": args.rooms,
            "protocol": {"n_sequences": args.n_sequences, "n_extra": args.n_extra,
                         "sampler": "ddpm", "batch_size": args.batch_size,
                         "epochs": args.epochs, "steps_per_dispatch": args.steps_per_dispatch,
                         "ipr_num_samples": args.ipr_samples, "ipr_k": args.k,
                         "config": args.config, "device": args.device},
            "card": {"name_power": card_line(), "revision": _revision(args.revision),
                     "launches": {}},
            "stages": {}}
        os.makedirs(os.path.join(self.work, "stages"), exist_ok=True)

    # -- the stages' machinery --------------------------------------------
    def _stage(self, name: str, outputs: Callable[[], bool],
               fn: Callable[[], Tuple[Dict[str, Any], Dict[str, Any]]]) -> None:
        """Run stage ``name`` (``fn`` returns its record's entries and the
        report's), or, where its record and ``outputs()`` say it ran, read
        its record back."""
        path = os.path.join(self.work, "stages", f"{name}.json")
        if os.path.isfile(path) and outputs():
            with open(path) as f:
                record = json.load(f)
            skipped = True
            print(f"=== {name}: skipped (its outputs exist) ===", flush=True)
        else:
            print(f"\n=== {name} ===", flush=True)
            t0 = time.perf_counter()
            info, results = fn()
            record = {"seconds": time.perf_counter() - t0, **info, "results": results}
            _write_json(path, record)
            skipped = False
            print(f"=== {name}: {record['seconds']:.1f} s ===", flush=True)
        results = record.pop("results")
        self.report["stages"][name] = {**record, "skipped": skipped}
        self.report.update(results)
        self.write()

    def write(self) -> None:
        os.makedirs(os.path.dirname(self.out), exist_ok=True)
        _write_json(self.out, self.report)

    def _cli(self, main, argv) -> Dict[str, Any]:
        return main(list(argv) + ["--device", self.args.device])

    # -- 1. dataset -------------------------------------------------------
    def _dataset(self):
        from ..data import make_synthetic_cached_dataset
        from ..utils.config import dump_yaml

        shutil.rmtree(self.data_dir, ignore_errors=True)     # a cut run's partial one
        make_synthetic_cached_dataset(self.data_dir, n_scenes=self.args.rooms, max_objects=12,
                                      seed=0)
        cfg = derive_config(self.args.config, self.data_dir, self.args.epochs)
        with open(self.cfg_path, "w") as f:
            f.write(dump_yaml(cfg))
        return {"rooms": self.args.rooms}, {}

    # -- 2. train ---------------------------------------------------------
    def _final_checkpoint(self) -> str:
        from ..utils.checkpoint import checkpoint_path

        return checkpoint_path(self.ckpt_dir, self.args.epochs - 1)

    def _train(self):
        from ..utils.checkpoint import load_checkpoint
        from ..utils.config import load_config
        from . import train_diffusion

        state, epoch = load_checkpoint(self.ckpt_dir)
        start_step = 0 if state is None else int(state["step"])
        t0 = time.perf_counter()
        self._cli(train_diffusion.main,
                  [self.cfg_path, os.path.dirname(self.ckpt_dir), "--experiment_tag", "protocol",
                   "--steps_per_dispatch", str(self.args.steps_per_dispatch),
                   "--log_every", "50"])
        seconds = time.perf_counter() - t0
        state, final = load_checkpoint(self.ckpt_dir)
        steps = int(state["step"])
        # the CLI fits the train and val splits (the config's training.splits)
        # in full batches
        with open(os.path.join(self.data_dir, "splits.csv")) as f:
            n_fit = sum(line.strip().endswith((",train", ",val")) for line in f)
        batch_size = int(load_config(self.cfg_path)["training"].get("batch_size", 128))
        info = {"epochs": self.args.epochs, "resumed_from_epoch": epoch,
                "fit_rooms": n_fit, "batch_size": batch_size,
                "batches_per_epoch": n_fit // batch_size, "steps": steps,
                "steps_this_pass": steps - start_step, "train_s": seconds,
                "steps_per_s": (steps - start_step) / seconds}
        t1 = time.perf_counter()
        info["step_probe"] = _step_probe(self.cfg_path, self.args.device, state)
        info["step_probe"]["seconds"] = time.perf_counter() - t1
        info["final_epoch"] = final
        return info, {}

    # -- 3., 4. generate --------------------------------------------------
    def _generate(self, out_dir: str, n: int, seed: int, intersec: bool):
        from ..ops import attention, fused_resblock
        from . import generate_diffusion

        # --no_ema: at 0.9999 decay the EMA's horizon is ~10k steps, so after
        # this run's few thousand steps the EMA still carries much of the
        # random init (the JAX run measured CKL 0.234 from the EMA against
        # 0.031 from the raw weights): sample the raw weights
        counters = (fused_resblock.fused_resnet_block, attention.fused_set_attention)
        for c in counters:
            c.launches = 0
        stats = self._cli(generate_diffusion.main,
                          [self.cfg_path, out_dir, "--weight_file", self.ckpt_dir, "--no_ema",
                           "--n_sequences", str(n), "--batch_size", str(self.args.batch_size),
                           "--clip_denoised", "--fused", "--render"]
                          + (["--compute_intersec"] if intersec else []) + ["--seed", str(seed)])
        launches = {"B1": counters[0].launches, "B2": counters[1].launches}
        with open(os.path.join(out_dir, "timing.json")) as f:
            timing = json.load(f)
        return {"n_sequences": n, "batches": -(-n // self.args.batch_size),
                "launches": launches, "timing": timing}, stats

    def _generate_1000(self):
        info, stats = self._generate(self.gen_dir, self.args.n_sequences, 0, True)
        return info, {"generate_metrics": stats}

    def _generate_4000(self):
        info, stats = self._generate(self.gen_dir2, self.args.n_extra, 1, False)
        shutil.rmtree(self.fake, ignore_errors=True)   # stale links if generation re-ran
        os.makedirs(self.fake)
        n_linked = 0
        for src in (self.gen_dir, self.gen_dir2):
            for f in _pngs(src):
                if "persp" not in f:
                    os.link(os.path.join(src, f), os.path.join(self.fake, f"{n_linked:05d}.png"))
                    n_linked += 1
        return info, {"generate_extra_metrics": stats, "n_synth_renders": n_linked}

    # -- 5. GT renders ----------------------------------------------------
    def _render_gt(self):
        from ..eval.render import render_scene_dict, save_image

        os.makedirs(self.gt_dir, exist_ok=True)
        rooms = sorted(d for d in os.listdir(self.data_dir) if d.startswith("SynthRoom_"))
        if len(rooms) < self.n_gt:
            raise SystemExit(f"{len(rooms)} rooms, fewer than the {self.n_gt} GT renders")
        for i, room in enumerate(rooms[:self.n_gt]):
            out = os.path.join(self.gt_dir, f"{i:05d}.png")
            if os.path.exists(out):
                continue
            z = np.load(os.path.join(self.data_dir, room, "boxes.npz"))
            boxes = {k: z[k] for k in ("translations", "sizes", "angles", "class_labels")}
            save_image(render_scene_dict(boxes), out)
        return {"n_gt": self.n_gt}, {}

    # -- 6. FID/KID -------------------------------------------------------
    def _fid(self):
        from . import compute_fid_scores

        out = {}
        # the canonical backbones need locally shipped weights and refuse
        # without them: try them first so that the report records the
        # refusal, then the explicit pixel-feature opt-in (comparable: false)
        try:
            out["fid_protocol"] = self._cli(compute_fid_scores.main,
                                            [self.gt_dir, self.gen_dir, "--compare_all"])
        except FileNotFoundError as e:
            out["fid_protocol"] = {"blocked": str(e)}
        out["fid_protocol_pixel"] = self._cli(
            compute_fid_scores.main,
            [self.gt_dir, self.gen_dir, "--compare_all", "--features", "pixel"])
        return {}, out

    def _halves(self) -> Tuple[str, str]:
        return os.path.join(self.work, "gt_a"), os.path.join(self.work, "gt_b")

    def _fid_control(self):
        from . import compute_fid_scores

        gt_a, gt_b = self._halves()
        for d in (gt_a, gt_b):
            os.makedirs(d, exist_ok=True)
        for i, f in enumerate(_pngs(self.gt_dir)):
            dst = os.path.join(gt_a if i % 2 == 0 else gt_b, f)
            if not os.path.exists(dst):
                os.link(os.path.join(self.gt_dir, f), dst)
        return {}, {"fid_control_half_vs_half_pixel": self._cli(
            compute_fid_scores.main, [gt_a, gt_b, "--compare_all", "--features", "pixel"])}

    # -- 7. precision / recall --------------------------------------------
    def _ipr(self, fake: str, key: str, try_vgg: bool):
        from . import improved_precision_recall

        argv = [self.gt_dir, fake, "--num_samples", str(self.args.ipr_samples),
                "--k", str(self.args.k), "--realism"]
        out = {}
        if try_vgg:
            try:
                out["ipr_protocol"] = self._cli(improved_precision_recall.main, argv)
                return {}, out
            except FileNotFoundError as e:
                out["ipr_protocol"] = {"blocked": str(e)}
        out[key] = self._cli(improved_precision_recall.main, argv + ["--features", "pixel"])
        return {}, out

    # ---------------------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        a = self.args
        # each stage: (whether its outputs exist, the stage)
        stages = {
            "dataset": (lambda: (os.path.isfile(self.cfg_path) and os.path.isfile(
                os.path.join(self.data_dir, "splits.csv"))), self._dataset),
            "train": (lambda: os.path.isfile(self._final_checkpoint()), self._train),
            "generate_1000": (lambda: (os.path.isfile(os.path.join(self.gen_dir, "metrics.json"))
                                       and len(_pngs(self.gen_dir)) == a.n_sequences),
                              self._generate_1000),
            "generate_4000": (lambda: (os.path.isfile(os.path.join(self.gen_dir2, "metrics.json"))
                                       and len(_pngs(self.fake)) == self.n_gt),
                              self._generate_4000),
            "render_gt": (lambda: len(_pngs(self.gt_dir)) == self.n_gt, self._render_gt),
            "fid": (lambda: True, self._fid),
            "fid_control": (lambda: all(len(_pngs(d)) for d in self._halves()),
                            self._fid_control),
            "ipr_protocol": (lambda: True,
                             lambda: self._ipr(self.gen_dir, "ipr_protocol_pixel", True)),
            "ipr_5000x5000": (lambda: True,
                              lambda: self._ipr(self.fake, "ipr_5000x5000_pixel", False)),
        }
        for name in STAGES:
            self._stage(name, *stages[name])
        for name in ("generate_1000", "generate_4000"):
            self.report["card"]["launches"][name] = self.report["stages"][name]["launches"]
        self.report["total_seconds"] = sum(s["seconds"] for s in self.report["stages"].values())
        self.write()
        print(f"\nDONE -> {self.out}", flush=True)
        return self.report


def main(argv=None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device here; pass --device cpu "
                         f"to run the protocol on the CPU")
    return Protocol(args).run()


if __name__ == "__main__":
    main()
