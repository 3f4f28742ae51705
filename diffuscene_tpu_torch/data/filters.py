"""Scene filter predicates + per-room-type filter stacks.

Copy of ``diffuscene_tpu/data/filters.py`` (numpy only), so the port does not
import the JAX package.

Re-design of the reference filter machinery
(`scene_synthesis/datasets/common.py:96-210` filter combinators,
`scene_synthesis/datasets/__init__.py:71-176` per-room stacks).  Filters are
plain composable functions ``scene -> scene | False`` applied to the raw
`Room` records from `data/raw.py`.  The furniture label maps live in
`furniture_labels.json` (data asset) and are loaded by `load_furniture_map`.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional, Sequence

from .splits import CSVSplitsBuilder

Filter = Callable


_LABELS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "furniture_labels.json")


def load_furniture_map(room_type: str) -> Dict[str, str]:
    """Raw 3D-FUTURE category -> canonical class for a room family.

    Equivalent of base.py's THREED_FRONT_{BEDROOM,LIBRARY,LIVINGROOM}_FURNITURE
    dicts (base.py:2-92), stored as a JSON data asset.
    """
    with open(_LABELS_PATH) as f:
        maps = json.load(f)
    key = {"bedroom": "bedroom", "library": "library",
           "livingroom": "livingroom", "diningroom": "livingroom"}[room_type]
    return maps[key]


# --- combinators (common.py:96-210) ---

def with_valid_scene_ids(invalid_scene_ids):
    return lambda s: s if s.scene_id not in invalid_scene_ids else False


def with_scene_ids(scene_ids):
    scene_ids = set(scene_ids)
    return lambda s: s if s.scene_id in scene_ids else False


def with_room(scene_type: str):
    return lambda s: s if scene_type in s.scene_type else False


def room_smaller_than_along_axis(max_size, axis=1):
    return lambda s: s if s.bbox[1][axis] <= max_size else False


def room_larger_than_along_axis(min_size, axis=1):
    return lambda s: s if s.bbox[0][axis] >= min_size else False


def floor_plan_with_limits(limit_x, limit_y, axis=(0, 2)):
    def inner(scene):
        min_bbox, max_bbox = scene.floor_plan_bbox
        t_x = max_bbox[axis[0]] - min_bbox[axis[0]]
        t_y = max_bbox[axis[1]] - min_bbox[axis[1]]
        return scene if (t_x <= limit_x and t_y <= limit_y) else False
    return inner


def with_valid_boxes(box_types):
    def inner(scene):
        scene.bboxes = [b for b in scene.bboxes if b.label in box_types]
        return scene
    return inner


def without_box_types(box_types):
    def inner(scene):
        scene.bboxes = [b for b in scene.bboxes if b.label not in box_types]
        return scene
    return inner


def with_generic_classes(box_types_map: Dict[str, str]):
    def inner(scene):
        for box in scene.bboxes:
            box.label = box_types_map[box.label]
        return scene
    return inner


def with_valid_bbox_jids(invalid_bbox_jids):
    return lambda s: (False if any(b.model_jid in invalid_bbox_jids for b in s.bboxes) else s)


def at_most_boxes(n: int):
    return lambda s: s if len(s.bboxes) <= n else False


def at_least_boxes(n: int):
    return lambda s: s if len(s.bboxes) >= n else False


def with_object_types(objects):
    objects = set(objects)
    return lambda s: s if all(b.label in objects for b in s.bboxes) else False


def contains_object_types(objects):
    objects = set(objects)
    return lambda s: s if any(b.label in objects for b in s.bboxes) else False


def without_object_types(objects):
    objects = set(objects)
    return lambda s: (False if any(b.label in objects for b in s.bboxes) else s)


def filter_compose(*filters: Filter) -> Filter:
    def inner(scene):
        s = scene
        for f in filters:
            if not s:
                return False
            s = f(s)
        return s
    return inner


def _read_lines(path: Optional[str]) -> set:
    if not path or not os.path.isfile(path):
        return set()
    with open(path, "r") as f:
        return set(l.strip() for l in f)


def filter_function(config: Dict, split: Sequence[str] = ("train", "val"),
                    without_lamps: bool = False) -> Filter:
    """Per-room-type filter stacks (datasets/__init__.py:71-176).

    bedroom: 3-13 boxes, must contain a bed, room height <= 4m, floor <= 6x6m;
    living/dining: 3-21 boxes, floor <= 12x12m; library: >= 3 boxes, 6x6m.
    """
    name = config.get("filter_fn", "no_filtering")
    if name == "no_filtering":
        return lambda s: s
    if name == "non_empty":
        return lambda s: s if len(s.bboxes) > 0 else False

    invalid_scene_ids = _read_lines(config.get("path_to_invalid_scene_ids"))
    invalid_bbox_jids = _read_lines(config.get("path_to_invalid_bbox_jids"))
    split_scene_ids = CSVSplitsBuilder(config["annotation_file"]).get_splits(split)
    lamp_types = ["ceiling_lamp", "pendant_lamp"] if without_lamps else [""]

    def stack(room_key, room_substr, max_boxes, floor_limit, extra=()):
        fmap = load_furniture_map(room_key)
        return filter_compose(
            with_room(room_substr),
            at_least_boxes(3),
            *( [at_most_boxes(max_boxes)] if max_boxes else [] ),
            with_object_types(list(fmap.keys())),
            with_generic_classes(fmap),
            with_valid_scene_ids(invalid_scene_ids),
            with_valid_bbox_jids(invalid_bbox_jids),
            *extra,
            room_smaller_than_along_axis(4.0, axis=1),
            room_larger_than_along_axis(-0.005, axis=1),
            floor_plan_with_limits(floor_limit, floor_limit, axis=(0, 2)),
            without_box_types(lamp_types),
            with_scene_ids(split_scene_ids),
        )

    if "threed_front_bedroom" in name:
        return stack("bedroom", "bed", 13, 6,
                     extra=(contains_object_types(["double_bed", "single_bed", "kids_bed"]),))
    if "threed_front_livingroom" in name:
        return stack("livingroom", "living", 21, 12)
    if "threed_front_diningroom" in name:
        return stack("diningroom", "dining", 21, 12)
    if "threed_front_library" in name:
        return stack("library", "library", None, 6)
    raise NotImplementedError(name)
