"""Train the scene-layout diffusion model.

Port of ``diffuscene_tpu/cli/train_diffusion.py`` (reference
``scripts/train_diffusion.py:27-256``): datasets from the config, the
bounds saved beside the checkpoints, the epoch loop with the epoch-level LR
schedule, periodic checkpoints with auto-resume, validation and the stats
log.  The same flags, plus ``--device`` (the card unless ``--device cpu``).

    python -m diffuscene_tpu_torch.cli.train_diffusion \\
        configs/uncond/diffusion_bedrooms_instancond_lat32_v.yaml out

A room-mask model (``network.room_mask_condition: true``) trains on each
batch's (B, 1, H, W) ``room_layout``; its extractor is the config's
``feature_extractor`` section (name, feature_size, input_channels), which
the JAX CLI ignores for a ResNet18 of 64 features over 1 channel (the
shipped values).  The f32 configs train with TF32 off for matmuls and cuDNN
convolutions (the JAX package's f32 products are full f32); the bf16
configs (``compute_dtype: bfloat16``) run their matmuls in bf16 either way.

``--native_loader`` feeds packed targets from the native C++ batcher
(``data/loader.py:PackedDataLoader``; not for text encodings), as the JAX
CLI does; ``--async_checkpoints`` writes each epoch's checkpoint from a
background thread after copying the state to host memory, and the CLI
joins it before it exits; ``--profile_dir DIR`` writes a ``torch.profiler``
trace (host and CUDA activity) of ``--profile_steps`` steps, from the step
after the fourth (``utils/profiling.py:TraceWindow``), into DIR.
``--mixed_precision`` casts the f32 parameters to bf16 once a step, outside
the gradient (``Trainer(mixed_precision=True)``).  One flag of the JAX CLI
raises: ``--with_wandb_logger`` (W&B needs a network).  A warm start from a
reference ``.pt`` starts the EMA from the loaded weights (the JAX CLI
leaves it at the random init).

Launched by ``torchrun`` it joins a process group (of one rank too) and
trains data-parallel over its ranks, one card
a rank (``cuda:LOCAL_RANK``, NCCL; gloo with ``--device cpu``), as the JAX
CLI's trainer spreads its batch over every local device: every rank reads
the same batches and keeps its rows of each (``batch_size`` is the global
batch and must divide over the ranks), the gradients are averaged, and
rank 0 alone writes the bounds, checkpoints and ``stats.txt``; every rank
loads.

    torchrun --nproc_per_node=2 -m diffuscene_tpu_torch.cli.train_diffusion CONFIG OUT
"""
from __future__ import annotations

import argparse
import math
import os

import numpy as np

_REFUSED = {
    "with_wandb_logger": "W&B needs a network; the port logs to stats.txt",
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train a scene diffusion model (PyTorch port)")
    parser.add_argument("config_file", help="Path to the YAML config")
    parser.add_argument("output_directory", help="Where to save checkpoints/logs")
    parser.add_argument("--experiment_tag", default=None)
    parser.add_argument("--continue_from_epoch", type=int, default=0)
    parser.add_argument("--weight_file", default=None,
                        help="warm-start the model weights before training: a reference "
                        ".pt/.pth state_dict or an experiment dir with model_* checkpoints "
                        "(its parameters and EMA; the optimizer starts fresh)")
    parser.add_argument("--n_processes", type=int, default=0,
                        help="accepted for reference drop-in compatibility")
    parser.add_argument("--seed", type=int, default=27)
    parser.add_argument("--epochs", type=int, default=None, help="override config epochs")
    parser.add_argument("--with_wandb_logger", action="store_true", help="not available")
    parser.add_argument("--native_loader", action="store_true",
                        help="packed batches from the native C++ batcher (not for text "
                        "encodings)")
    parser.add_argument("--log_every", type=int, default=10,
                        help="fetch metrics to the host every N steps")
    parser.add_argument("--mixed_precision", action="store_true",
                        help="cast the f32 parameters to bf16 once a step, outside the "
                        "gradient; parameters, optimizer state and EMA stay f32")
    parser.add_argument("--async_checkpoints", action="store_true",
                        help="write epoch checkpoints from a background thread")
    parser.add_argument("--keep_last_checkpoints", type=int, default=None,
                        help="retain only the N highest-epoch checkpoints (default: keep all)")
    parser.add_argument("--steps_per_dispatch", type=int, default=1,
                        help="run N train steps per call (Trainer.train_step_scan); logging "
                        "then advances once per call")
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler trace of steady-state train steps to this "
                        "directory")
    parser.add_argument("--profile_steps", type=int, default=20,
                        help="how many steps the --profile_dir capture spans")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; f32 matmuls run with TF32 off")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    for flag, why in _REFUSED.items():
        if getattr(args, flag):
            raise SystemExit(f"--{flag}: {why}")

    import torch

    from ..parallel import launch, make_mesh, shutdown

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device, rank, _ = launch(args.device)       # the process group under torchrun
    try:
        mesh = make_mesh()
        if mesh.distributed and rank == 0:
            print(f"data-parallel over {mesh.n_data} rank(s), "
                  f"{torch.distributed.get_backend()}", flush=True)
        _train(args, device, rank, mesh)
    finally:
        shutdown()


def _train(args, device, rank, mesh):
    from ..data.factory import (apply_text_emb_dim_default, get_dataset_raw_and_encoded,
                                get_encoded_dataset)
    from ..data.loader import DataLoader, PackedDataLoader
    from ..models.scene_model import SceneDiffusion, SceneModelConfig
    from ..train.trainer import Trainer
    from ..utils.checkpoint import (load_checkpoint, load_model_weights, save_bounds,
                                    save_checkpoint, wait_for_checkpoints)
    from ..utils.config import load_config, save_experiment_params
    from ..utils.convert import reference_to_scene_state_dict
    from ..utils.profiling import TraceWindow
    from ..utils.stats_logger import StatsLogger

    main_rank = rank == 0      # rank 0 alone writes
    config = load_config(args.config_file)
    # a text model's token width (768 BERT-style, 50 GloVe, 512 CLIP) for
    # the data pipeline, so it matches fc_text_f
    apply_text_emb_dim_default(config)
    np.random.seed(args.seed)

    experiment_tag = args.experiment_tag or os.path.basename(args.config_file).rsplit(".", 1)[0]
    experiment_dir = os.path.join(args.output_directory, experiment_tag)
    os.makedirs(experiment_dir, exist_ok=True)
    if main_rank:
        save_experiment_params(args, experiment_tag, experiment_dir)

    keep_rl = bool(config["network"].get("room_mask_condition", True))
    train_raw, train_ds = get_dataset_raw_and_encoded(
        config["data"], augmentations=config["data"].get("augmentations"),
        split=config["training"].get("splits", ["train", "val"]), seed=args.seed,
        keep_room_layout=keep_rl)
    val_ds = get_encoded_dataset(
        config["data"], augmentations=None, split=config["validation"].get("splits", ["test"]),
        seed=args.seed, keep_room_layout=keep_rl)
    bounds = train_ds.bounds.as_device_bounds()
    if main_rank:
        save_bounds(experiment_dir, bounds)

    net_cfg = dict(config["network"])
    net_cfg.setdefault("sample_num_points", train_ds.max_length)
    cfg = SceneModelConfig.from_config(net_cfg, config.get("feature_extractor"))
    scene = SceneDiffusion(cfg, bounds=bounds if cfg.loss_iou else None, device=device)

    batch_size = int(config["training"].get("batch_size", 128))
    if args.native_loader:
        if "text" in config["data"]["encoding_type"]:
            raise SystemExit("--native_loader does not cover text encodings")
        train_loader = PackedDataLoader(
            train_raw, train_ds.bounds, max_length=train_ds.max_length,
            n_classes=train_ds.n_classes, batch_size=batch_size,
            rotation="fixed_rotations" if "fixed_rotations" in
            (config["data"].get("augmentations") or []) else None,
            seed=args.seed)
    else:
        train_loader = DataLoader(train_ds, batch_size, shuffle=True, seed=args.seed)
    val_loader = DataLoader(val_ds, int(config["validation"].get("batch_size", batch_size)),
                            shuffle=False, drop_last=True)
    steps_per_epoch = max(len(train_loader), 1)
    trainer = Trainer(scene, config["training"], steps_per_epoch=steps_per_epoch,
                      device=device, mesh=mesh,
                      mixed_precision=args.mixed_precision).init(args.seed)

    # warm start (train_diffusion.py:181): weights (and an experiment's
    # EMA) only, the optimizer starts fresh
    if args.weight_file:
        if args.weight_file.endswith((".pt", ".pth")):
            trainer.set_weights(reference_to_scene_state_dict(load_model_weights(args.weight_file)))
        else:
            warm = load_model_weights(args.weight_file, ema=False)
            trainer.set_weights(warm, load_model_weights(args.weight_file, ema=True))
        if main_rank:
            print(f"warm-started weights from {args.weight_file}")

    state, resumed = load_checkpoint(experiment_dir)
    if state is not None:
        trainer.load_state_dict(state)
    start_epoch = (resumed + 1) if resumed is not None else args.continue_from_epoch

    def save(epoch, blocking=True):
        if main_rank:
            save_checkpoint(trainer.state_dict(), experiment_dir, epoch, blocking=blocking,
                            keep_last=args.keep_last_checkpoints)

    logger = StatsLogger.instance()
    stats_file = open(os.path.join(experiment_dir, "stats.txt"), "a") if main_rank else None
    if stats_file is not None:
        logger.add_output_file(stats_file)

    def log(metrics, epoch, b):
        if main_rank:
            logger.update(metrics)
            logger.print_progress(epoch, b, metrics["loss"])
    try:
        epochs = args.epochs if args.epochs is not None else int(config["training"].get("epochs", 1000))
        save_every = int(config["training"].get("save_frequency", 10))
        val_every = int(config["validation"].get("frequency", 100))
        spd = max(args.steps_per_dispatch, 1)
        log_every = max(args.log_every, 1)
        since_log = log_every      # the first call of a run always logs
        trace_window = (TraceWindow(args.profile_dir, length=args.profile_steps)
                        if args.profile_dir else None)
        gstep = 0
        for epoch in range(start_epoch, epochs):
            pending = []
            n_batches = len(train_loader)
            for b, batch in enumerate(train_loader):
                pending.append(batch)
                if len(pending) < spd and (b + 1) < n_batches:
                    continue
                if len(pending) == 1:
                    metrics = trainer.train_step(trainer.put_batch(pending[0]))
                else:
                    metrics = trainer.train_step_scan(trainer.put_batches(pending))
                if trace_window is not None:
                    trace_window.tick(gstep)
                gstep += len(pending)
                since_log += len(pending)
                pending = []
                if since_log >= log_every:
                    since_log = 0
                    if not math.isfinite(metrics["loss"]):
                        # a recoverable state on disk instead of NaN updates
                        save(epoch)
                        raise RuntimeError(
                            f"non-finite loss at epoch {epoch} batch {b}; checkpoint saved to "
                            f"{experiment_dir}: resume with a lower lr or smaller max_grad_norm")
                    log(metrics, epoch, b + 1)
            if main_rank:
                logger["lr"].value = trainer.current_lr()
                logger.clear()

            if (epoch % save_every) == 0 and epoch > start_epoch:
                save(epoch, blocking=not args.async_checkpoints)
            if (epoch % val_every) == 0:
                for b, batch in enumerate(val_loader):
                    metrics = trainer.eval_step(trainer.put_batch(batch))
                    log(metrics, -1, b + 1)
                if main_rank:
                    logger.clear()
        if trace_window is not None:
            trace_window.close()
        save(epochs - 1)
        if main_rank:
            print(f"\ndone: {epochs - start_epoch} epochs, final step {trainer.step}")
    finally:
        wait_for_checkpoints()     # commit a save still in flight before exit
        if stats_file is not None:
            logger.remove_output_file(stats_file)


if __name__ == "__main__":
    main()
