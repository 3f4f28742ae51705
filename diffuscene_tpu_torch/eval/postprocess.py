"""Sample post-processing: empty-slot filtering + descaling (host-side).

Copy of ``diffuscene_tpu/eval/postprocess.py`` (numpy only), so the port does not
import the JAX package.

Equivalent of the reference `delete_empty_from_network_samples` /
`delete_empty_boxes` (`diffusion_scene_layout_ddpm.py:352-454`) and the
dataset `post_process` descaling (`threed_front_dataset.py:515-535`).

Device-side the sampler emits fixed-shape (B, N, C) arrays; the ragged
"delete empty" step is inherently host-side (variable object counts per
scene), so it lives here as numpy, outside jit.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..diffusion.gaussian import AttributeSpec


def split_network_samples(
    spec: AttributeSpec, samples: np.ndarray, keep_empty: bool = False
) -> List[Dict[str, np.ndarray]]:
    """Per-scene attribute dicts with empty slots removed.

    Matches delete_empty_from_network_samples semantics
    (diffusion_scene_layout_ddpm.py:352-406): a slot is empty when the last
    class channel ("end") is >= 0 (or the objectness channel < 0 when
    objectness_dim > 0); class_labels are returned as raw probability maps
    WITHOUT the empty channel.  Returns one dict per batch element, each with
    leading axis = number of kept objects.
    """
    samples = np.asarray(samples)
    B = samples.shape[0]
    bd, cd = spec.bbox_dim, spec.class_dim
    out = []
    for b in range(B):
        s = samples[b]
        if spec.objectness_dim > 0:
            empty = s[:, spec.empty_slice][:, 0] < 0
        else:
            empty = s[:, bd + cd - 1] >= 0
        keep = np.ones_like(empty, bool) if keep_empty else ~empty
        d = {
            "translations": s[keep, spec.trans_slice],
            "sizes": s[keep, spec.size_slice],
            "angles": s[keep, spec.angle_slice],
            "class_labels": s[keep, bd : bd + cd - (0 if spec.objectness_dim else 1)],
            "objectness": s[keep][:, spec.empty_slice],
        }
        if spec.objfeat_dim > 0:
            d["objfeats"] = s[keep, spec.objfeat_slice]
        out.append(d)
    return out


def one_hot_from_probs(class_probs: np.ndarray, n_classes: Optional[int] = None) -> np.ndarray:
    """argmax -> one-hot (the 'class_labels' of samples_dict,
    diffusion_scene_layout_ddpm.py:355-358)."""
    n = n_classes or class_probs.shape[-1]
    idx = class_probs.argmax(-1)
    return np.eye(n, dtype=np.float32)[idx]
