"""FID/KID between real and generated render folders, the features on the card.

Port of ``diffuscene_tpu/cli/compute_fid_scores.py`` (reference
``scripts/compute_fid_scores.py:41-118``, which calls cleanfid).  The
feature extractor is selectable: InceptionV3 (``eval/backbones.py``) with
local weights for paper-comparable numbers, or the offline pixel features
(relative comparisons only, see ``eval/fid.py``).  The features are
computed on ``--device`` (default ``cuda``); the Fréchet distance and KID on
the host in f64.

    python -m diffuscene_tpu_torch.cli.compute_fid_scores REAL_DIR FAKE_DIR \\
        --features inception --inception_weights pt_inception.pth
"""
from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Compute FID/KID between render folders "
                                     "(PyTorch port)")
    parser.add_argument("path_to_real_renderings",
                        help="flat folder of real render images, or (with the "
                        "path_to_annotations positional) a preprocessed "
                        "cached-dataset directory whose per-scene renders "
                        "form the real set")
    parser.add_argument("path_to_synthesized_renderings")
    parser.add_argument("path_to_annotations", nargs="?", default=None,
                        help="scene_id,split CSV; when given, the real set is "
                        "the cached dataset's train+val renders like the "
                        "reference (compute_fid_scores.py:67-83)")
    parser.add_argument("--compare_all", action="store_true",
                        help="with annotations, include the test split in the real set too")
    parser.add_argument("--features", choices=["pixel", "inception"], default="inception",
                        help="'inception' (default) needs --inception_weights "
                        "and errors loudly without them; 'pixel' is an "
                        "explicit offline opt-in, flagged comparable=false "
                        "in the output JSON")
    parser.add_argument("--inception_weights", default=None)
    parser.add_argument("--inception_variant", choices=["fid", "torchvision"], default="fid",
                        help="'fid': canonical FID-network pooling (use with FID-network "
                        "weights); 'torchvision': plain ImageNet inception_v3 semantics "
                        "incl. transform_input")
    parser.add_argument("--kid_subset_size", type=int, default=1000)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from ..eval.fid import (
        InceptionFeatures, PixelFeatures, fid_from_features, kid_from_features,
        load_image_folder, load_image_paths,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # "comparable" = the canonical Inception FID-network feature space
    # (fid_pools); anything else is self-consistent but not paper-comparable.
    comparable = args.features == "inception" and args.inception_variant == "fid"
    if args.features == "inception":
        # raises FileNotFoundError without weights, rather than printing a
        # pixel-FID number
        fn = InceptionFeatures(args.inception_weights,
                               fid_pools=args.inception_variant == "fid",
                               transform_input=args.inception_variant == "torchvision",
                               device=args.device)
    else:
        fn = PixelFeatures(device=args.device)
        print("WARNING: pixel features are not comparable to published "
              "Inception-FID numbers; pass --features inception with local weights")

    if args.path_to_annotations:
        # real set = split-selected renders of a preprocessed cached dataset
        # (compute_fid_scores.py:67-83); --compare_all adds the test split
        from ..data.splits import CSVSplitsBuilder
        from ..data.threed_front import CachedThreedFront

        splits = ["train", "val", "test"] if args.compare_all else ["train", "val"]
        ids = CSVSplitsBuilder(args.path_to_annotations).get_splits(splits)
        ds = CachedThreedFront(args.path_to_real_renderings,
                               config={"train_stats": "dataset_stats.txt"}, scene_ids=ids)
        paths = [p for p in ds.render_paths if p]
        if not paths:
            raise SystemExit(f"no renders found for splits {splits} under "
                             f"{args.path_to_real_renderings}")
        print(f"real set: {len(paths)} renders from splits {splits}")
        real = load_image_paths(paths)
    else:
        real = load_image_folder(args.path_to_real_renderings)
    fake = load_image_folder(args.path_to_synthesized_renderings)
    real_feats, fake_feats = fn(real), fn(fake)
    fid = fid_from_features(real_feats, fake_feats)
    kid = kid_from_features(real_feats, fake_feats, subset_size=args.kid_subset_size)
    result = {"fid": fid, "kid": kid, "features": args.features, "comparable": comparable}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
