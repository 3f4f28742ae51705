"""CSV split files (scene_id,split) -> per-split scene id lists.

Copy of ``diffuscene_tpu/data/splits.py`` (numpy only), so the port does not
import the JAX package.

Equivalent of reference CSVSplitsBuilder (`scene_synthesis/datasets/splits_builder.py`).
"""
from __future__ import annotations

import csv
from typing import Dict, List, Sequence


class CSVSplitsBuilder:
    def __init__(self, annotation_path: str):
        self._path = annotation_path
        self._splits: Dict[str, List[str]] = {}

    def _parse(self):
        if self._splits:
            return
        with open(self._path, newline="") as f:
            for row in csv.reader(f):
                if len(row) < 2:
                    continue
                scene_id, split = row[0].strip(), row[1].strip()
                self._splits.setdefault(split, []).append(scene_id)

    def get_splits(self, keep_splits: Sequence[str] = ("train", "val")) -> List[str]:
        if isinstance(keep_splits, str):
            keep_splits = [keep_splits]
        self._parse()
        out: List[str] = []
        for s in keep_splits:
            out.extend(self._splits.get(s, []))
        return out
