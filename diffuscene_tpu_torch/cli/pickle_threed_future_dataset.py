"""Pickle the deduped 3D-FUTURE furniture catalog for one room type.

Port of ``diffuscene_tpu/cli/pickle_threed_future_dataset.py`` (reference
``scripts/pickle_threed_fucture_dataset.py:13-115``), with the same flags:
the rooms of the filtered 3D-FRONT split (``data/raw.py``,
``data/filters.py``), their furniture deduped by jid, pickled as
``threed_future_model_<room>.pkl``, the catalog that the shape-AE CLIs and
the sampling CLIs' mesh retrieval read.  Host work only.

    python -m diffuscene_tpu_torch.cli.pickle_threed_future_dataset OUT \
        3D-FRONT 3D-FUTURE-model 3D-FUTURE-model/model_info.json \
        --annotation_file configs/splits/bedroom_threed_front_splits.csv
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="Pickle the 3D-FUTURE catalog (PyTorch port)")
    parser.add_argument("output_directory")
    parser.add_argument("path_to_3d_front_dataset_directory")
    parser.add_argument("path_to_3d_future_dataset_directory")
    parser.add_argument("path_to_model_info")
    parser.add_argument("--annotation_file", required=True)
    parser.add_argument("--dataset_filtering", default="threed_front_bedroom",
                        choices=["threed_front_bedroom", "threed_front_livingroom",
                                 "threed_front_diningroom", "threed_front_library"])
    parser.add_argument("--path_to_invalid_scene_ids", default=None)
    parser.add_argument("--path_to_invalid_bbox_jids", default=None)
    parser.add_argument("--without_lamps", action="store_true",
                        help="exclude ceiling/pendant lamps from the scene "
                        "filter (pickle_threed_fucture_dataset.py:69-72)")
    args = parser.parse_args(argv)

    from ..data.filters import filter_function
    from ..data.raw import ThreedFront
    from ..data.threed_future import ThreedFutureDataset

    filter_cfg = {
        "filter_fn": args.dataset_filtering,
        "path_to_invalid_scene_ids": args.path_to_invalid_scene_ids,
        "path_to_invalid_bbox_jids": args.path_to_invalid_bbox_jids,
        "annotation_file": args.annotation_file,
    }
    scenes = ThreedFront.from_dataset_directory(
        args.path_to_3d_front_dataset_directory, args.path_to_model_info,
        args.path_to_3d_future_dataset_directory,
        filter_fn=filter_function(filter_cfg, ["train", "val", "test"],
                                  args.without_lamps),
    )
    # dedupe objects by jid (pickle_threed_fucture_dataset.py:75-90)
    seen, objects = set(), []
    for room in scenes.scenes:
        for obj in room.bboxes:
            if obj.model_jid not in seen:
                seen.add(obj.model_jid)
                objects.append(obj)
    dataset = ThreedFutureDataset(objects)
    room = args.dataset_filtering.replace("threed_front_", "")
    os.makedirs(args.output_directory, exist_ok=True)
    out = os.path.join(args.output_directory, f"threed_future_model_{room}.pkl")
    dataset.pickle(out)
    print(f"pickled {len(dataset)} unique objects -> {out}")


if __name__ == "__main__":
    main()
