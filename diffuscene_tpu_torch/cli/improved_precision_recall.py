"""Improved Precision & Recall between real and generated render folders,
the features and the k-NN manifolds on the card.

Port of ``diffuscene_tpu/cli/improved_precision_recall.py`` (reference
``scripts/improved_precision_recall.py``; k=3, 5000 samples by default,
VGG16-fc2 features).  The features (``eval/fid.py``) and the distances,
radii and radius tests (``eval/ipr.py``, f64) run on ``--device`` (default
``cuda``).

    python -m diffuscene_tpu_torch.cli.improved_precision_recall REAL_DIR FAKE_DIR \\
        --features vgg --vgg_weights vgg16.pth
"""
from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Improved precision/recall over renders "
                                     "(PyTorch port)")
    parser.add_argument("path_to_real_renderings",
                        help="flat folder of real renders, a precalculated "
                        "manifold .npz, or (with path_to_annotations) a "
                        "preprocessed cached-dataset directory")
    parser.add_argument("path_to_synthesized_renderings")
    parser.add_argument("path_to_annotations", nargs="?", default=None,
                        help="scene_id,split CSV; when given, the real set is "
                        "the cached dataset's train+val renders like the "
                        "reference (improved_precision_recall.py:375,396-404)")
    parser.add_argument("--batch_size", type=int, default=100)
    parser.add_argument("--k", type=int, default=3)
    parser.add_argument("--num_samples", type=int, default=5000)
    parser.add_argument("--features", choices=["pixel", "vgg", "inception"], default="vgg",
                        help="'vgg' (default) = the reference's VGG16-fc2 "
                        "features (needs --vgg_weights; errors loudly without them). "
                        "'pixel' is an explicit offline opt-in and is flagged "
                        "comparable=false in the output JSON")
    parser.add_argument("--vgg_weights", default=None,
                        help="torchvision vgg16 state_dict (.pth) or .npz")
    parser.add_argument("--inception_weights", default=None)
    parser.add_argument("--fname_precalc", default="",
                        help="extract real-manifold features, save them to "
                        "this .npz, and exit (path_to_synthesized_renderings "
                        "is ignored); pass the .npz as path_to_real_renderings later")
    parser.add_argument("--realism", action="store_true",
                        help="also report realism scores of the synthesized set "
                        "against the real manifold (improved_precision_recall.py:273-281)")
    parser.add_argument("--toy", action="store_true",
                        help="self-check of the IPR math on synthetic gaussians "
                        "(improved_precision_recall.py:344-368)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from ..eval.fid import (
        InceptionFeatures, PixelFeatures, VGG16Features, load_image_folder, load_image_paths,
    )
    from ..eval.ipr import (
        compute_precision_recall, compute_realism_scores, load_manifold, save_manifold,
        subsample_features,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.toy:
        rng = np.random.default_rng(0)
        real = rng.normal(0, 1, (args.num_samples, 64))
        fake = rng.normal(0.5, 1, (args.num_samples, 64))
        pr = compute_precision_recall(real, fake, k=args.k, num_samples=args.num_samples,
                                      device=args.device)
        result = {"toy": True, "precision": pr.precision, "recall": pr.recall}
        print(json.dumps(result))
        return result

    # "comparable" = the reference's VGG16-fc2 feature space; any other
    # extractor yields self-consistent but not paper-comparable numbers.
    comparable = args.features == "vgg"
    if args.features == "vgg":
        fn = VGG16Features(args.vgg_weights, device=args.device)  # raises without weights
    elif args.features == "inception":
        fn = InceptionFeatures(args.inception_weights, device=args.device)
    else:
        fn = PixelFeatures(device=args.device)
        print("WARNING: pixel features are NOT comparable to the reference's "
              "VGG16-fc2 precision/recall; pass --features vgg with local weights")
    # features once per folder and one subsample each (the rng order of
    # compute_precision_recall), so precision/recall and the realism scores
    # see the same manifolds
    rng = np.random.default_rng(0)
    if args.path_to_real_renderings.endswith(".npz"):
        # a precalculated real manifold (improved_precision_recall.py:106)
        real_feats, _, _ = load_manifold(args.path_to_real_renderings)
        real_feats = subsample_features(real_feats, args.num_samples, rng)
    elif args.path_to_annotations:
        # real set = train+val renders of a preprocessed cached dataset
        # (improved_precision_recall.py:396-404)
        from ..data.splits import CSVSplitsBuilder
        from ..data.threed_front import CachedThreedFront

        ids = CSVSplitsBuilder(args.path_to_annotations).get_splits(["train", "val"])
        ds = CachedThreedFront(args.path_to_real_renderings,
                               config={"train_stats": "dataset_stats.txt"}, scene_ids=ids)
        paths = [p for p in ds.render_paths if p]
        if not paths:
            raise SystemExit(f"no renders found for train+val under "
                             f"{args.path_to_real_renderings}")
        print(f"real set: {len(paths)} renders from splits ['train', 'val']")
        real_feats = subsample_features(fn(load_image_paths(paths)), args.num_samples, rng)
    else:
        real_feats = subsample_features(
            fn(load_image_folder(args.path_to_real_renderings)), args.num_samples, rng)
    if args.fname_precalc:
        save_manifold(args.fname_precalc, real_feats, k=args.k, device=args.device)
        print(f"saved real manifold ({len(real_feats)} samples) to {args.fname_precalc}; "
              f"path_fake ({args.path_to_synthesized_renderings}) ignored for precalc")
        return None
    fake_feats = subsample_features(
        fn(load_image_folder(args.path_to_synthesized_renderings)), args.num_samples, rng)
    pr = compute_precision_recall(real_feats, fake_feats, k=args.k, num_samples=None,
                                  device=args.device)
    result = {"precision": pr.precision, "recall": pr.recall,
              "features": args.features, "comparable": comparable}
    if args.realism:
        scores = compute_realism_scores(real_feats, fake_feats, k=args.k, device=args.device)
        result["realism_mean"] = float(scores.mean())
        result["realism_max"] = float(scores.max())
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
