"""Batched host-side data loading: fixed-shape numpy batches.

Copy of ``diffuscene_tpu/data/loader.py`` (numpy, and the native batcher of
``native/``).

Replaces the reference's torch DataLoader + per-sample decorator chain
(`scripts/train_diffusion.py:150-163`).  Encoding runs in the host Python
process (or, with :class:`PackedDataLoader`, in the native C++ batcher),
producing (B, N, C) float32 arrays ready for a device put.
"""
from __future__ import annotations

import threading
import queue as queue_mod
from typing import Dict, Iterator, List, Optional

import numpy as np

from .encoding import EncodingPipeline


class EncodedDataset:
    """Dataset wrapper applying an EncodingPipeline to raw cached samples."""

    def __init__(self, raw_dataset, encoding: EncodingPipeline, keep_room_layout: bool = False):
        self.raw = raw_dataset
        self.encoding = encoding
        self.keep_room_layout = keep_room_layout

    def __len__(self):
        return len(self.raw)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        s = self.encoding(self.raw[i])
        if not self.keep_room_layout:
            s.pop("room_layout", None)
        return s

    def post_process(self, batch):
        return self.encoding.post_process(batch)

    @property
    def bounds(self):
        return self.encoding.bounds

    @property
    def max_length(self):
        return self.encoding.max_length

    @property
    def class_labels(self):
        return self.encoding.class_labels

    @property
    def n_classes(self):
        return len(self.encoding.class_labels)


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack fixed-shape samples into a batch; strings collected as lists."""
    out: Dict[str, np.ndarray] = {}
    keys = samples[0].keys()
    for k in keys:
        v0 = samples[0][k]
        if isinstance(v0, str):
            out[k] = [s[k] for s in samples]  # type: ignore[assignment]
        else:
            out[k] = np.stack([np.asarray(s[k]) for s in samples], axis=0)
    return out


class DataLoader:
    """Infinite (or epoch-wise) shuffling batch iterator with prefetch.

    A background thread assembles the next batches while the device computes —
    the host-side analogue of double buffering.
    """

    def __init__(
        self,
        dataset: EncodedDataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._epoch_indices()
        nb = len(self)
        q: "queue_mod.Queue" = queue_mod.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            try:
                for b in range(nb):
                    batch_idx = idx[b * self.batch_size : (b + 1) * self.batch_size]
                    q.put(collate([self.dataset[int(i)] for i in batch_idx]))
                q.put(sentinel)
            except BaseException as e:  # surface worker errors in the consumer
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            yield item

    def infinite(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield from iter(self)


class PackedDataLoader:
    """Loader on the native C++ batch encoder (``native/batcher.cpp``).

    Yields {'packed': (B, N, point_dim) float32} batches: the whole
    augmentation/scaling/permutation/padding/packing pipeline runs as one
    multithreaded native pass a batch, and ``SceneDiffusion.get_loss``
    takes the packed target directly.  Covers the
    ``cached_diffusion_cosin_angle_objfeatsnorm_lat32`` family (no text);
    use :class:`DataLoader` otherwise.  Batch b of epoch e draws from seed
    e * 1000003 + b, as the JAX package's does.
    """

    def __init__(self, raw_dataset, bounds, max_length: int, n_classes: int,
                 batch_size: int, objfeat_dim: int = 32, shuffle: bool = True,
                 permute: bool = True, rotation: Optional[str] = "fixed_rotations",
                 seed: int = 0, drop_last: bool = True):
        from ..native import NativeBatchEncoder

        self.raw = raw_dataset
        self.encoder = NativeBatchEncoder(
            bounds, max_length, n_classes, objfeat_dim,
            permute=permute, rotation=rotation, seed=seed,
        )
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    def __len__(self):
        n = len(self.raw)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = np.arange(len(self.raw))
        if self.shuffle:
            self._rng.shuffle(idx)
        self._epoch += 1
        for b in range(len(self)):
            rows = idx[b * self.batch_size: (b + 1) * self.batch_size]
            raw = [self.raw[int(i)] for i in rows]
            yield {"packed": self.encoder(raw, seed=self._epoch * 1_000_003 + b)}

    def infinite(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield from iter(self)
