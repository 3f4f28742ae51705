"""The per-scene box statistics that the generate and completion CLIs
write: each scene's box intersection and symmetry figures, the running
line of ``iou_states.txt`` and their means (reference
completion_rearrange.py:430-446, generate_diffusion.py:394-429)."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..eval.metrics import compute_intersection, compute_symmetry, scene_bboxes_from_params


def scene_box_stats(boxes: Dict[str, np.ndarray],
                    pair_intersects: Optional[Callable[[int, int], bool]] = None
                    ) -> Tuple[float, ...]:
    """A post-processed scene -> (objects, pairs, mean pair IoU, mean
    intersection, overlap ratio, symmetric pairs).  ``pair_intersects``
    (``eval/mesh_intersect.py``) judges each box pair with a positive IoU
    by its retrieved meshes."""
    bb = scene_bboxes_from_params(np.asarray(boxes["translations"]).reshape(-1, 3),
                                  np.asarray(boxes["sizes"]).reshape(-1, 3))
    cls = np.asarray(boxes["class_labels"])
    cls = cls[0] if cls.ndim == 3 else cls
    return (*compute_intersection(bb, pair_intersects=pair_intersects),
            compute_symmetry(bb, cls))


def append_iou_states(path: str, per_scene_stats: Sequence[Tuple[float, ...]]) -> None:
    """Append the running line over the scenes so far to ``path``."""
    arr = np.asarray(per_scene_stats, np.float64)
    with open(path, "a") as f:
        f.write(f"num scenes: {len(arr)} - num objects avg: {arr[:, 0].mean():f}"
                f" - std: {arr[:, 0].std():f} - num pairs: {arr[:, 1].mean():f}"
                f" - box iou: {arr[:, 2].mean():f}"
                f" - box intersec: {arr[:, 3].mean():f}"
                f" - overlap ratio: {arr[:, 4].mean():f}"
                f" - total num symmetries: {int(arr[:, 5].sum())}\n")


def mean_box_stats(per_scene_stats: List[Tuple[float, ...]]) -> Dict[str, float]:
    """The means over the scenes, under the JAX CLIs' metric names."""
    arr = np.asarray(per_scene_stats, np.float64)
    return {"avg_objects": float(arr[:, 0].mean()), "avg_pair_iou": float(arr[:, 2].mean()),
            "avg_intersec": float(arr[:, 3].mean()),
            "avg_overlap_ratio": float(arr[:, 4].mean()),
            "avg_symmetry": float(arr[:, 5].mean())}
