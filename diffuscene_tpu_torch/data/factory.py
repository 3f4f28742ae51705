"""Dataset factory: config dict -> raw / encoded datasets.

Copy of ``diffuscene_tpu/data/factory.py`` (numpy only), so the port does not
import the JAX package.

Equivalent of the reference factories
(`scene_synthesis/datasets/__init__.py:11-69`): builds CachedThreedFront from
the config's dataset_directory + CSV splits, then composes the encoding
pipeline from the `encoding_type` micro-DSL string.  Raw (non-cached)
3D-FRONT parsing lives in `data/raw`.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from .encoding import build_encoding
from .loader import EncodedDataset
from .splits import CSVSplitsBuilder
from .threed_front import MAX_LENGTH_BY_ROOM, CachedThreedFront


def get_raw_dataset(config: Dict, split: Sequence[str] = ("train", "val")) -> CachedThreedFront:
    dataset_type = config.get("dataset_type", "cached_threedfront")
    if "cached" not in dataset_type:
        raise NotImplementedError(
            "raw (non-cached) datasets are handled by data.raw.parse_threed_front_scenes; "
            "training always reads the cached format"
        )
    splits_builder = CSVSplitsBuilder(config["annotation_file"])
    scene_ids = splits_builder.get_splits(split)
    return CachedThreedFront(config["dataset_directory"], config=config, scene_ids=scene_ids)


def _max_length_from_config(config: Dict, raw: CachedThreedFront) -> int:
    if "max_length" in config:
        return int(config["max_length"])
    # infer from the dataset directory name like the reference room types
    # (threed_front.py:204-216: bedroom 12, living/dining 21, library 11)
    directory = config.get("dataset_directory", "").lower()
    for key, n in MAX_LENGTH_BY_ROOM.items():
        if key in directory:
            return n
    return 12


def get_dataset_raw_and_encoded(
    config: Dict,
    augmentations: Optional[Sequence[str]] = None,
    split: Sequence[str] = ("train", "val"),
    max_length: Optional[int] = None,
    seed: int = 0,
    keep_room_layout: bool = False,
) -> Tuple[CachedThreedFront, EncodedDataset]:
    raw = get_raw_dataset(config, split)
    ml = max_length if max_length is not None else _max_length_from_config(config, raw)
    encoding = build_encoding(
        config["encoding_type"],
        bounds=raw.bounds,
        max_length=ml,
        class_labels=raw.class_labels,
        class_frequencies=raw.class_frequencies,
        augmentations=augmentations if augmentations is not None else config.get("augmentations", ()),
        box_ordering=config.get("box_ordering", None),
        text_emb_dim=int(config.get("text_emb_dim", 50)),
        glove_path=config.get("glove_path", None),
        seed=seed,
    )
    return raw, EncodedDataset(raw, encoding, keep_room_layout=keep_room_layout)


def apply_text_emb_dim_default(config: Dict) -> Dict:
    """Derive ``data.text_emb_dim`` from the network's text flags on a full
    (reference-format) config, in place.  Single entry point for every CLI so
    the data pipeline and fc_text_f can never disagree."""
    from ..models.scene_model import text_emb_dim_for_network

    if config.get("network", {}).get("text_condition"):
        config.setdefault("data", {}).setdefault(
            "text_emb_dim", text_emb_dim_for_network(config["network"]))
    return config


def get_encoded_dataset(config: Dict, augmentations=None,
                        split=("train", "val"), max_length=None, seed: int = 0,
                        keep_room_layout: bool = False) -> EncodedDataset:
    _, enc = get_dataset_raw_and_encoded(config, augmentations, split, max_length,
                                         seed, keep_room_layout=keep_room_layout)
    return enc
