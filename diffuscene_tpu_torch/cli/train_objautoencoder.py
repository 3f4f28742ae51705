"""Train the KL shape autoencoder on 3D-FUTURE point clouds.

Port of ``diffuscene_tpu/cli/train_objautoencoder.py`` (reference
``scripts/train_objautoencoder.py:23-294``), with the same flags and
``--device`` (the card unless ``--device cpu``).  Each step's chamfer runs
the CUDA kernel of ``ops/chamfer.py`` on the card.  Launched by
``torchrun`` it joins a process group (of one rank too) and trains
data-parallel over its ranks, one card a rank
(``cuda:LOCAL_RANK``, NCCL; gloo with ``--device cpu``): every rank draws
the same global batch and keeps its clouds, the BatchNorm moments are the
global batch's, and rank 0 alone writes checkpoints and ``stats.txt``.

    python -m diffuscene_tpu_torch.cli.train_objautoencoder \\
        configs/obj_autoencoder/bed_living_diningrooms_lat32.yaml out \\
        --path_to_pickled_dataset threed_future_model_bedroom.pkl
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train the shape autoencoder (PyTorch port)")
    parser.add_argument("config_file")
    parser.add_argument("output_directory")
    parser.add_argument("--experiment_tag", default=None)
    parser.add_argument("--path_to_pickled_dataset", default=None,
                        help="pickled ThreedFutureNormPCDataset (or reference pickle)")
    parser.add_argument("--seed", type=int, default=27)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--continue_from_epoch", type=int, default=0,
                        help="start epoch when no checkpoint is found in the "
                        "experiment dir (reference train_objautoencoder.py:43)")
    parser.add_argument("--weight_file", default=None,
                        help="warm-start weights before training: a reference "
                        ".pt/.pth state_dict or an experiment dir with model_* "
                        "checkpoints")
    parser.add_argument("--with_wandb_logger", action="store_true",
                        help="not available: the port logs to stats.txt only")
    parser.add_argument("--n_processes", type=int, default=0,
                        help="accepted for reference drop-in compatibility")
    parser.add_argument("--num_samples", type=int, default=None,
                        help="points served per object (reference fixes 2048)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.with_wandb_logger:
        raise SystemExit("--with_wandb_logger: W&B needs a network; the port logs to stats.txt")
    if not args.path_to_pickled_dataset:
        raise SystemExit("pass --path_to_pickled_dataset (a pickled 3D-FUTURE catalog whose "
                         "objects have raw_model_norm_pc.npz point clouds)")

    import torch

    from ..data.threed_future import ThreedFutureNormPCDataset
    from ..models.autoencoder import build_autoencoder
    from ..parallel import launch, make_mesh, shutdown
    from ..train.ae_trainer import AETrainer
    from ..utils.checkpoint import load_checkpoint, load_model_weights, save_checkpoint
    from ..utils.config import load_config, save_experiment_params
    from ..utils.stats_logger import StatsLogger

    device, rank, _ = launch(args.device)       # the process group under torchrun
    main_rank = rank == 0                       # rank 0 alone writes
    mesh = make_mesh()
    if mesh.distributed and main_rank:
        print(f"data-parallel over {mesh.n_data} rank(s), {torch.distributed.get_backend()}",
              flush=True)
    config = load_config(args.config_file)
    experiment_tag = args.experiment_tag or os.path.basename(args.config_file).rsplit(".", 1)[0]
    experiment_dir = os.path.join(args.output_directory, experiment_tag)
    os.makedirs(experiment_dir, exist_ok=True)
    if main_rank:
        save_experiment_params(args, experiment_tag, experiment_dir)

    kwargs = {"num_samples": args.num_samples} if args.num_samples else {}
    dataset = ThreedFutureNormPCDataset.from_pickled_dataset(
        args.path_to_pickled_dataset, **kwargs)

    model = build_autoencoder(config.get("network", {}), device=device)
    batch_size = int(config["training"].get("batch_size", 16))
    steps_per_epoch = max(len(dataset) // batch_size, 1)
    trainer = AETrainer(model, config["training"], steps_per_epoch=steps_per_epoch,
                        device=device, mesh=mesh).init(args.seed)
    # warm start (train_objautoencoder.py:212-215): weights only, the
    # optimizer starts fresh
    if args.weight_file:
        model.load_state_dict(load_model_weights(args.weight_file))
        if main_rank:
            print(f"warm-started weights from {args.weight_file}")
    state, resumed = load_checkpoint(experiment_dir)
    if state is not None:
        trainer.load_state_dict(state)
    start_epoch = (resumed + 1) if resumed is not None else args.continue_from_epoch

    logger = StatsLogger.instance()
    stats_file = open(os.path.join(experiment_dir, "stats.txt"), "a") if main_rank else None
    if stats_file is not None:
        logger.add_output_file(stats_file)
    epochs = args.epochs if args.epochs is not None else int(config["training"].get("epochs", 2000))
    save_every = int(config["training"].get("save_frequency", 100))
    rng = np.random.default_rng(args.seed)

    order = np.arange(len(dataset))
    try:
        for epoch in range(start_epoch, epochs):
            rng.shuffle(order)
            for b in range(steps_per_epoch):
                idxs = order[b * batch_size: (b + 1) * batch_size]
                pts = np.stack([dataset[int(i)]["points"] for i in idxs])
                metrics = trainer.train_step(trainer.put_batch(pts))
                if (b % 10) == 0 and main_rank:
                    logger.update(metrics)
                    logger.print_progress(epoch, b + 1, metrics["loss"])
            if main_rank:
                logger.clear()
                if (epoch % save_every) == 0 and epoch > start_epoch:
                    save_checkpoint(trainer.state_dict(), experiment_dir, epoch)
        if main_rank:
            save_checkpoint(trainer.state_dict(), experiment_dir, epochs - 1)
    finally:
        if stats_file is not None:
            logger.remove_output_file(stats_file)
        shutdown()


if __name__ == "__main__":
    main()
