"""Checkpoints in torch format, with the reference's ``model_{epoch:05d}``
naming and auto-resume.

Port of ``diffuscene_tpu/utils/checkpoint.py`` (reference
``scripts/training_utils.py:62-97``): each checkpoint is one file
``<experiment_dir>/model_{epoch:05d}`` written by ``torch.save`` (the whole
trainer state: step, model, EMA, optimizer moments in their dtypes,
accumulator, generator), and resume picks the highest epoch.  The
train-set bounds go beside them as ``bounds.npz``
(train_diffusion.py:128-137).  ``save_checkpoint(blocking=False)`` copies
the state to host memory and writes it from a background thread (the JAX
package's orbax AsyncCheckpointer): one save in flight at a time, and
:func:`wait_for_checkpoints` joins it (and raises its error) before the
process exits or reads a checkpoint back.  ``keep_last`` prunes after a
save has been written.
"""
from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_CKPT_RE = re.compile(r"^model_(\d+)$")


def checkpoint_path(experiment_dir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(experiment_dir), f"model_{epoch:05d}")


def latest_epoch(experiment_dir: str) -> Optional[int]:
    """Highest epoch with a saved checkpoint, or None (training_utils.py:62-75)."""
    if not os.path.isdir(experiment_dir):
        return None
    ids = [int(m.group(1)) for f in os.listdir(experiment_dir)
           if (m := _CKPT_RE.match(f)) and os.path.isfile(os.path.join(experiment_dir, f))]
    return max(ids) if ids else None


_IN_FLIGHT: Optional[threading.Thread] = None
_ERRORS: list = []


def _to_host(obj: Any) -> Any:
    """A copy of ``obj`` with every tensor copied to host memory (so the
    caller may go on updating its tensors in place)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _write(state: Any, path: str, experiment_dir: str, epoch: int,
           keep_last: Optional[int]) -> None:
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    if keep_last:
        prune_checkpoints(experiment_dir, keep_last, protect=epoch)


def _write_in_background(*args) -> None:
    try:
        _write(*args)
    except BaseException as e:  # raised again by wait_for_checkpoints
        _ERRORS.append(e)


def save_checkpoint(state: Any, experiment_dir: str, epoch: int, blocking: bool = True,
                    keep_last: Optional[int] = None) -> str:
    """Write ``state`` to model_{epoch:05d}, through a temporary file so that
    an interrupted save leaves no partial checkpoint, then keep only the
    ``keep_last`` highest epochs when it is given.  ``blocking=False``
    copies the state to host memory, returns, and writes it from a
    background thread, after any save still in flight."""
    global _IN_FLIGHT
    os.makedirs(experiment_dir, exist_ok=True)
    path = checkpoint_path(experiment_dir, epoch)
    if blocking:
        wait_for_checkpoints()
        _write(state, path, experiment_dir, epoch, keep_last)
        return path
    snapshot = _to_host(state)
    wait_for_checkpoints()
    _IN_FLIGHT = threading.Thread(target=_write_in_background, daemon=False,
                                  args=(snapshot, path, experiment_dir, epoch, keep_last))
    _IN_FLIGHT.start()
    return path


def wait_for_checkpoints() -> None:
    """Join the save in flight, if any; raise the error a background save hit."""
    global _IN_FLIGHT
    if _IN_FLIGHT is not None:
        _IN_FLIGHT.join()
        _IN_FLIGHT = None
    if _ERRORS:
        raise _ERRORS.pop()


def prune_checkpoints(experiment_dir: str, keep_last: int, protect: Optional[int] = None) -> list:
    """Delete all but the ``keep_last`` highest-epoch checkpoints (never
    ``protect``); returns the removed epochs."""
    if not os.path.isdir(experiment_dir):
        return []
    ids = sorted(int(m.group(1)) for f in os.listdir(experiment_dir)
                 if (m := _CKPT_RE.match(f)) and os.path.isfile(os.path.join(experiment_dir, f)))
    doomed = [e for e in ids[:-keep_last] if e != protect] if keep_last < len(ids) else []
    for e in doomed:
        os.remove(checkpoint_path(experiment_dir, e))
    return doomed


def load_checkpoint(experiment_dir: str, epoch: Optional[int] = None,
                    map_location: Any = "cpu") -> Tuple[Optional[Any], Optional[int]]:
    """The latest (or given-epoch) checkpoint: (state, epoch), or (None, None)
    when there is none, the reference's silent no-op resume.  A save still
    in flight is joined first."""
    wait_for_checkpoints()
    if epoch is None:
        epoch = latest_epoch(experiment_dir)
    if epoch is None:
        return None, None
    state = torch.load(checkpoint_path(experiment_dir, epoch), map_location=map_location,
                       weights_only=True)
    return state, epoch


def load_model_weights(path: str, ema: bool = True) -> Dict[str, Any]:
    """A model state_dict from a reference ``.pt``/``.pth`` file (the port's
    modules carry the reference names) or from the newest checkpoint of an
    experiment dir: its EMA weights when it has them and ``ema`` is set,
    else its raw weights."""
    if path.endswith((".pt", ".pth")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return dict(sd.state_dict() if hasattr(sd, "state_dict") else sd)
    state, epoch = load_checkpoint(path)
    if epoch is None:
        raise FileNotFoundError(f"no model_* checkpoints under {path}")
    if ema and state.get("ema") is not None:
        return state["ema"]
    return state["model"]


def save_bounds(experiment_dir: str, bounds: Dict[str, np.ndarray]) -> None:
    """The train-set normalization bounds next to the checkpoints
    (train_diffusion.py:128-137)."""
    os.makedirs(experiment_dir, exist_ok=True)
    np.savez(os.path.join(experiment_dir, "bounds.npz"), **bounds)
