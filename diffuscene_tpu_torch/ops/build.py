"""Build the hand-written CUDA sources of ``csrc/`` and load them with ctypes.

Each source is one shared library with a plain C interface, compiled by
``nvcc`` for sm_90a at first use into the git-ignored ``build/kernels/``.
The library's name carries a hash of the source, the shared headers and the
flags, so an edit rebuilds.  :func:`build` starts one ``nvcc`` per missing library, all at
once, and waits for them together; the compiler's register and
shared-memory report goes to ``<lib>.ptxas.txt`` beside each library.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# the kernels' dtype argument
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(source: Path) -> Path:
    """Build output path of ``source``, keyed by its bytes, the bytes of the
    headers in ``csrc/`` (which a source may include) and the flags."""
    blob = source.read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(blob + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def build(sources: Sequence[Path]) -> List[Path]:
    """Compile every source whose library is missing, one nvcc each, all
    started together; return the library paths.  Raises if any build fails."""
    outs = [library_path(s) for s in sources]
    jobs = []
    for src, out in zip(sources, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((src, out, tmp, proc))
    errors = []
    for src, out, tmp, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc {src.name} failed ({proc.returncode}):\n{err}")
            continue
        out.with_suffix(".ptxas.txt").write_text(err)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


def load(source: Path) -> ctypes.CDLL:
    """Build ``source`` if needed and load its library."""
    return ctypes.CDLL(str(build([source])[0]))


# torch's own raw-stream getter (what its generated kernels launch on), a
# tenth of the host time of torch.cuda.current_stream(); the public call
# where a build of torch lacks it
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_ptr(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as an integer handle, for a
    kernel launch through ctypes."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def check_operand(name: str, t: torch.Tensor, device, dtype, shape) -> None:
    """Raise unless ``t`` is what a kernel reads through a raw pointer: on
    ``device``, of ``dtype`` and ``shape``, contiguous, 16-byte aligned.
    Kernel wrappers call this on every launch, so the passing case is one
    test."""
    if (t.dtype == dtype and t.shape == tuple(shape) and t.is_contiguous()
            and not t.data_ptr() % 16 and t.device == device):
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    raise ValueError(f"{name} must be 16-byte aligned")


def prepared(owner: torch.Tensor, deps: Sequence[Optional[torch.Tensor]],
             make: Callable[[], Any], key: Any = None) -> Any:
    """A kernel operand derived from weights (packed, cast, stacked), made by
    ``make()`` once and kept on ``owner`` while it lives: remade when
    ``owner`` or any of ``deps`` is another tensor or was changed in place,
    or ``key`` (the compute dtype, say) differs.
    Sampling calls a kernel with the same prepared weights at every step, so
    the hit is a few attribute reads."""
    versions = [key, owner._version] + [t._version for t in deps if t is not None]
    hit = getattr(owner, "_kernel_operands", None)
    if (hit is not None and hit[0] == versions and len(hit[1]) == len(deps)
            and all(a is b for a, b in zip(hit[1], deps))):
        return hit[2]
    value = make()
    prepared.made += 1
    owner._kernel_operands = (versions, tuple(deps), value)
    return value


# operands made by ``prepared`` (and the chain kernel's packed weights): a
# capture that makes one would keep it in the graph's memory and make it
# again at every replay, so a CUDA graph of a step checks it made none
prepared.made = 0

# the tallies of the CUDA graphs being captured, innermost last
_TALLIES: List[collections.Counter] = []


def count_launch(counter: Callable, kernel: Optional[str] = None) -> None:
    """One launch of ``kernel`` by the wrapper ``counter``: added to
    ``counter.launches`` (and ``counter.by_kernel[kernel]``), or, while the
    current stream is captured into a CUDA graph, to that capture's tally
    (:func:`launch_tally`), which each replay adds (:func:`add_tally`): the
    counts are what the card runs.  A capture outside ``launch_tally``
    raises."""
    if torch.cuda.is_current_stream_capturing():
        if not _TALLIES:
            raise RuntimeError("a kernel launch is captured into a CUDA graph outside "
                               "build.launch_tally(): its replays would go uncounted")
        _TALLIES[-1][(counter, kernel)] += 1
        return
    counter.launches += 1
    if kernel is not None:
        counter.by_kernel[kernel] = counter.by_kernel.get(kernel, 0) + 1


@contextlib.contextmanager
def launch_tally():
    """Collect the kernel launches captured inside the block into a tally,
    {(wrapper, kernel name): launches}, instead of counting them."""
    tally: collections.Counter = collections.Counter()
    _TALLIES.append(tally)
    try:
        yield tally
    finally:
        _TALLIES.pop()


def add_tally(tally: collections.Counter, replays: int = 1) -> None:
    """Count the launches of ``replays`` replays of a graph whose capture
    made ``tally``, on the wrappers' counters as they are now."""
    for (counter, kernel), n in tally.items():
        counter.launches += n * replays
        if kernel is not None:
            counter.by_kernel[kernel] = counter.by_kernel.get(kernel, 0) + n * replays
