"""The native (C++) batch encoder, built at first use and loaded with ctypes.

Port of ``diffuscene_tpu/native/__init__.py``.  ``batcher.cpp`` here is the
port's own copy of the JAX package's source; it is compiled with the JAX
build's flags (``g++ -O3 -march=native -std=c++17 -shared -fPIC
-pthread``), so on one machine both libraries compute bit for bit the same.
The library goes into the git-ignored ``build/native/`` under a name that
carries a hash of the source, the flags and the host CPU's model and
feature flags (as ``ops/build.py`` names the kernels), so an edit rebuilds
and a library built for one CPU's ``-march=native`` is never loaded on
another, even where ``build/`` was copied along with the checkout.  A failed build
raises; there is no fallback.

:class:`NativeBatchEncoder` produces the same packed (B, N, point_dim)
diffusion targets as the numpy pipeline (``data/encoding.py``) for the
``cached_diffusion_cosin_angle_objfeatsnorm_lat32`` family: scaling to
[-1, 1], cos/sin angles, objfeats normalization, an optional random object
permutation and rotation augmentation, padding with the "end" one-hot,
classes mapped to {-1, +1}, all in one multithreaded pass a batch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().with_name("batcher.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")
ABI_VERSION = 1

_lib: Optional[ctypes.CDLL] = None


def _cpu_key() -> bytes:
    """The host CPU's model name and feature flags (what -march=native reads)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags", "Features"))]
        return "".join(sorted(set(lines))).encode()
    except OSError:
        return platform.processor().encode()


def library_path() -> Path:
    """The build output, keyed by the source's bytes, the flags and the CPU."""
    blob = SOURCE.read_bytes() + " ".join(FLAGS).encode() + _cpu_key()
    digest = hashlib.sha256(blob).hexdigest()[:16]
    return BUILD_DIR / f"libdiffuscene_batcher_v{ABI_VERSION}_{digest}.so"


def build() -> Path:
    """Compile the library unless it is there; raises if g++ fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native batcher cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cxx, *FLAGS, str(SOURCE), "-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ {SOURCE.name} failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises on failure."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    if lib.diffuscene_native_abi_version() != ABI_VERSION:
        raise RuntimeError(f"{library_path()} has another ABI version")
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.encode_diffusion_batch.argtypes = [
        f32p, f32p, f32p, f32p, f32p,            # translations, sizes, angles, classes, objfeats
        ctypes.POINTER(ctypes.c_int),            # lengths
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p,                                    # bounds
        ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        f32p,                                    # out
        ctypes.c_int,
    ]
    lib.encode_diffusion_batch.restype = None
    _lib = lib
    return lib


class NativeBatchEncoder:
    """Batch encoding of raw cached scenes in one native pass (see the
    module docstring); ``rotation`` is None, "fixed_rotations" or
    "rotations", each scene's draws come from a splitmix64 stream seeded by
    (seed, scene index)."""

    ROTATION_MODES = {None: 0, "none": 0, "fixed_rotations": 1, "rotations": 2}

    def __init__(self, bounds, max_length: int, n_classes: int,
                 objfeat_dim: int = 32, permute: bool = True,
                 rotation: Optional[str] = "fixed_rotations",
                 seed: int = 0, n_threads: Optional[int] = None):
        self.lib = load_library()
        self.max_length = max_length
        self.n_classes = n_classes
        self.objfeat_dim = objfeat_dim
        self.permute = permute
        self.rotation_mode = self.ROTATION_MODES[rotation]
        self.seed = seed
        self.n_threads = n_threads or (os.cpu_count() or 4)
        t_lo, t_hi = bounds.translations
        s_lo, s_hi = bounds.sizes
        a_lo, a_hi = bounds.angles
        f = bounds.objfeats_32 if objfeat_dim == 32 else bounds.objfeats
        self._bounds = np.concatenate([
            np.asarray(t_lo, np.float32).reshape(3),
            np.asarray(t_hi, np.float32).reshape(3),
            np.asarray(s_lo, np.float32).reshape(3),
            np.asarray(s_hi, np.float32).reshape(3),
            np.asarray([a_lo, a_hi], np.float32).reshape(2),
            np.asarray([f[1], f[2]], np.float32).reshape(2),
        ]).astype(np.float32)

    @property
    def point_dim(self) -> int:
        return 3 + 3 + 2 + (self.n_classes - 1) + self.objfeat_dim

    def __call__(self, raw_samples, seed: Optional[int] = None) -> np.ndarray:
        """raw_samples: dicts of unpadded (n_i, ...) arrays -> the packed
        (B, max_length, point_dim) float32 target."""
        B = len(raw_samples)
        max_in = max(len(s["translations"]) for s in raw_samples)
        trans = np.zeros((B, max_in, 3), np.float32)
        sizes = np.zeros((B, max_in, 3), np.float32)
        angles = np.zeros((B, max_in), np.float32)
        classes = np.zeros((B, max_in, self.n_classes), np.float32)
        feats = np.zeros((B, max_in, max(self.objfeat_dim, 1)), np.float32)
        lengths = np.zeros(B, np.int32)
        feat_key = "objfeats_32" if self.objfeat_dim == 32 else "objfeats"
        for i, s in enumerate(raw_samples):
            n = len(s["translations"])
            lengths[i] = n
            trans[i, :n] = s["translations"]
            sizes[i, :n] = s["sizes"]
            angles[i, :n] = np.asarray(s["angles"]).reshape(n)
            classes[i, :n] = s["class_labels"]
            if self.objfeat_dim > 0:
                feats[i, :n] = s[feat_key]

        out = np.empty((B, self.max_length, self.point_dim), np.float32)
        p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        self.lib.encode_diffusion_batch(
            p(trans), p(sizes), p(angles), p(classes), p(feats),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            B, max_in, self.n_classes, self.objfeat_dim,
            p(self._bounds), self.max_length,
            ctypes.c_uint64(self.seed if seed is None else seed),
            int(self.permute), self.rotation_mode, p(out), self.n_threads,
        )
        return out
