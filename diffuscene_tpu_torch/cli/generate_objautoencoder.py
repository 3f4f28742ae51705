"""Export latent shape codes ("objfeats") with a trained shape autoencoder.

Port of ``diffuscene_tpu/cli/generate_objautoencoder.py`` (reference
``scripts/generate_objautoencoder.py:25-235``), with the same flags and
``--device`` (the card unless ``--device cpu``): run the deterministic
encoder over every catalog object, write per-model
``raw_model_norm_pc_<tag>.npz`` latents and ``lat{dim}_stats.json`` (the
latents' std and the scale factor 1/std, generate_objautoencoder.py:225-230).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description="Export shape-AE latents (PyTorch port)")
    parser.add_argument("config_file")
    parser.add_argument("weight_dir", metavar="output_directory",
                        help="experiment/output dir: weights load from here unless "
                        "--weight_file is given, and the latent std report is written here")
    parser.add_argument("--path_to_pickled_dataset", required=True)
    parser.add_argument("--output_directory", default=None,
                        help="write latents here instead of next to the models")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--weight_file", default=None,
                        help="a reference .pt/.pth state_dict or an experiment dir, "
                        "instead of the newest checkpoint in output_directory")
    parser.add_argument("--experiment_tag", default=None,
                        help="accepted for reference drop-in compatibility")
    parser.add_argument("--continue_from_epoch", type=int, default=0,
                        help="accepted for reference drop-in compatibility")
    parser.add_argument("--n_processes", type=int, default=0,
                        help="accepted for reference drop-in compatibility")
    parser.add_argument("--num_samples", type=int, default=None,
                        help="points fed to the encoder per object (default: "
                        "dataset's, i.e. 2048)")
    parser.add_argument("--lat_name", default=None,
                        help="latent filename tag: raw_model_norm_pc_<tag>.npz. "
                        "Defaults to lat{objfeat_dim}; pass --lat_name lat for the "
                        "file the reference loader reads as 64-d latents.")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from ..data.threed_future import ThreedFutureNormPCDataset
    from ..models.autoencoder import build_autoencoder
    from ..train.ae_trainer import AETrainer
    from ..utils.config import load_config
    from ..utils.checkpoint import load_model_weights

    config = load_config(args.config_file)
    kwargs = {"num_samples": args.num_samples} if args.num_samples else {}
    dataset = ThreedFutureNormPCDataset.from_pickled_dataset(
        args.path_to_pickled_dataset, **kwargs)

    model = build_autoencoder(config.get("network", {}), device=args.device)
    latent_dim = model.latent_dim
    trainer = AETrainer(model, config["training"], device=args.device).init(args.seed)
    source = args.weight_file or args.weight_dir
    model.load_state_dict(load_model_weights(source))
    print(f"loaded weights from {source}")

    lats = []
    tag = args.lat_name or f"lat{latent_dim}"
    for start in range(0, len(dataset), args.batch_size):
        idxs = list(range(start, min(start + args.batch_size, len(dataset))))
        pts = np.stack([dataset[i]["points"] for i in idxs])
        lat = trainer.encode(trainer.put_batch(pts)).cpu().numpy()
        lats.append(lat)
        for j, i in enumerate(idxs):
            obj = dataset.objects[i]
            out_dir = args.output_directory or os.path.dirname(
                getattr(obj, "raw_model_norm_pc_path", "") or ".")
            os.makedirs(out_dir, exist_ok=True)
            jid = dataset.get_model_jid(i)["model_jid"]
            name = f"raw_model_norm_pc_{tag}.npz" if not args.output_directory \
                else f"{jid}_norm_pc_{tag}.npz"
            np.savez(os.path.join(out_dir, name), latent=lat[j].astype(np.float32))
        print(f"encoded {min(start + args.batch_size, len(dataset))}/{len(dataset)}")

    all_lat = np.concatenate(lats)
    std = float(all_lat.std())
    stats = {
        "latent_dim": latent_dim,
        "std": std,
        "scale_factor": (1.0 / std) if std > 0 else 1.0,
        "min": float(all_lat.min()),
        "max": float(all_lat.max()),
        "n_objects": int(len(dataset)),
    }
    print(f"latent std: {stats['std']:.6f}  min: {stats['min']:.4f}  max: {stats['max']:.4f}")
    print(f"scale factor: {stats['scale_factor']:.6f}")
    with open(os.path.join(args.weight_dir, f"lat{latent_dim}_stats.json"), "w") as f:
        json.dump(stats, f)


if __name__ == "__main__":
    main()
