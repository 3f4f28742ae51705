"""3D-FUTURE furniture catalog: pickled objects, nearest-furniture retrieval
and the point-cloud dataset of the shape autoencoder.

Copy of ``diffuscene_tpu/data/threed_future.py`` (reference
``scene_synthesis/datasets/threed_future_dataset.py:9-137``).  The
retrieval queries are vectorized numpy over per-label stacked arrays (the
reference sorts a Python dict per query): the same winners.  A catalog
pickled by the JAX package names that package's modules; importing those
imports JAX, so :meth:`ThreedFutureDataset.from_pickled_dataset` reads
pickles with an unpickler that maps ``diffuscene_tpu.data.*`` classes to
the port's copies (``data/raw.py``, this module) and refuses every other
class of the JAX package.
"""
from __future__ import annotations

import importlib
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

# JAX-package module -> the port's copy of its classes
_MODULE_MAP = {
    "diffuscene_tpu.data.raw": "diffuscene_tpu_torch.data.raw",
    "diffuscene_tpu.data.threed_future": "diffuscene_tpu_torch.data.threed_future",
}


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "diffuscene_tpu" or module.startswith("diffuscene_tpu."):
            if module not in _MODULE_MAP:
                raise pickle.UnpicklingError(
                    f"{module}.{name} has no copy in the port (only {sorted(_MODULE_MAP)})")
            port = importlib.import_module(_MODULE_MAP[module])
            if not hasattr(port, name):
                raise pickle.UnpicklingError(f"{module}.{name} has no copy in {port.__name__}")
            return getattr(port, name)
        return super().find_class(module, name)


class ThreedFutureDataset:
    """Furniture catalog with nearest-object retrieval: a list of model
    objects (``data/raw.py``) exposing label, size and latents."""

    def __init__(self, objects: Sequence):
        assert len(objects) > 0
        self.objects = list(objects)
        self._by_label: Dict[str, Dict] = {}

    def __len__(self):
        return len(self.objects)

    def __str__(self):
        return f"Dataset contains {len(self)} objects"

    def __getitem__(self, idx):
        return self.objects[idx]

    # ------------------------------------------------------------------
    def _label_cache(self, label: str, need_lat: Optional[int] = None) -> Dict:
        # a catalog pickled before this cache existed has no _by_label
        by_label = self.__dict__.setdefault("_by_label", {})
        cache = by_label.get(label)
        if cache is None:
            objs = [o for o in self.objects if o.label == label]
            cache = {"objects": objs,
                     "sizes": np.stack([np.asarray(o.size, np.float64) for o in objs])
                     if objs else np.zeros((0, 3))}
            by_label[label] = cache
        if need_lat is not None and f"lat{need_lat}" not in cache:
            feats = []
            for o in cache["objects"]:
                if need_lat == 32:
                    feats.append(np.asarray(o.raw_model_norm_pc_lat32(), np.float64))
                else:
                    feats.append(np.asarray(o.raw_model_norm_pc_lat(), np.float64))
            cache[f"lat{need_lat}"] = np.stack(feats) if feats else np.zeros((0, need_lat))
        return cache

    def get_closest_furniture_to_box(self, query_label: str, query_size):
        """argmin over size MSE (threed_future_dataset.py:27-34)."""
        c = self._label_cache(query_label)
        d = ((c["sizes"] - np.asarray(query_size, np.float64)) ** 2).sum(-1)
        return c["objects"][int(np.argmin(d))]

    def get_closest_furniture_to_2dbox(self, query_label: str, query_size):
        """argmin over (x, z) footprint MSE (threed_future_dataset.py:36-46)."""
        c = self._label_cache(query_label)
        d = (c["sizes"][:, 0] - query_size[0]) ** 2 + (c["sizes"][:, 2] - query_size[1]) ** 2
        return c["objects"][int(np.argmin(d))]

    def get_closest_furniture_to_objfeats(self, query_label: str, query_objfeat):
        """argmin over latent-shape-code MSE (threed_future_dataset.py:48-58)."""
        lat = 32 if np.asarray(query_objfeat).shape[0] == 32 else 64
        c = self._label_cache(query_label, need_lat=lat)
        d = ((c[f"lat{lat}"] - np.asarray(query_objfeat, np.float64)) ** 2).sum(-1)
        return c["objects"][int(np.argmin(d))]

    def get_closest_furniture_to_objfeats_and_size(self, query_label, query_objfeat, query_size):
        """lexsort by (size MSE primary, feat MSE secondary)
        (threed_future_dataset.py:60-76)."""
        lat = 32 if np.asarray(query_objfeat).shape[0] == 32 else 64
        c = self._label_cache(query_label, need_lat=lat)
        mses_feat = ((c[f"lat{lat}"] - np.asarray(query_objfeat, np.float64)) ** 2).sum(-1)
        mses_size = ((c["sizes"] - np.asarray(query_size, np.float64)) ** 2).sum(-1)
        ind = np.lexsort((mses_feat, mses_size))
        return c["objects"][int(ind[0])]

    # ------------------------------------------------------------------
    @classmethod
    def from_pickled_dataset(cls, path: str, **kwargs) -> "ThreedFutureDataset":
        """Load a pickled catalog (written by this package or the JAX one);
        extra kwargs (e.g. ``num_samples`` for ThreedFutureNormPCDataset) are
        applied to the returned dataset.  Unpickle only catalogs you made."""
        with open(path, "rb") as f:
            dataset = _PortUnpickler(f).load()
        if isinstance(dataset, cls):
            for k, v in kwargs.items():
                setattr(dataset, k, v)
            return dataset
        # a catalog pickled as another class (the base class, or the
        # reference's): re-wrap its objects
        return cls(getattr(dataset, "objects", dataset), **kwargs)

    def pickle(self, path: str):
        with open(path, "wb") as f:
            pickle.dump(self, f)


class ThreedFutureNormPCDataset(ThreedFutureDataset):
    """Serves normalized point-cloud subsamples for shape-AE training
    (threed_future_dataset.py:94-137): ``num_samples`` points drawn with
    replacement per item, as the reference's np.random.choice."""

    def __init__(self, objects: Sequence, num_samples: int = 2048, seed: int = 0):
        super().__init__(objects)
        self.num_samples = num_samples
        self._rng = np.random.default_rng(seed)

    def __getitem__(self, idx: int) -> Dict:
        obj = self.objects[idx]
        points = np.asarray(obj.raw_model_norm_pc(), np.float32)
        sel = self._rng.choice(points.shape[0], self.num_samples)
        return {"points": points[sel], "idx": idx}

    def get_model_jid(self, idx: int) -> Dict:
        return {"model_jid": self.objects[idx].model_jid}

    def collate_fn(self, samples: List[Dict]) -> Dict[str, np.ndarray]:
        samples = [s for s in samples if s is not None]
        return {
            "points": np.stack([s["points"] for s in samples]),
            "idx": np.asarray([s["idx"] for s in samples], np.int64),
        }
