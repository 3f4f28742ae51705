"""Profiling and throughput counters on ``torch.profiler``.

Port of ``diffuscene_tpu/utils/profiling.py``:

- :func:`trace` captures the enclosed region (host and CUDA activity) and
  writes a Chrome/TensorBoard trace (``*.pt.trace.json``) into ``logdir``;
- :class:`TraceWindow` captures steps [start, start + length) of a host
  loop: call ``tick(step)`` after each step and ``close()`` after the loop
  (which also ends a capture the loop cut short);
- :func:`annotate` names a host phase in the trace
  (``torch.profiler.record_function``);
- :class:`ThroughputMeter` keeps steps/s and items/s as an exponential
  moving average without synchronizing the device, unless
  :meth:`ThroughputMeter.synced_tick` is asked to.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _start(logdir: str) -> torch.profiler.profile:
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=_activities(),
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
    prof.start()
    return prof


def _stop(prof: torch.profiler.profile) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the enclosed region into ``logdir``."""
    prof = _start(logdir)
    try:
        yield prof
    finally:
        _stop(prof)


def annotate(name: str):
    """A named range for a host phase; it shows up in the trace."""
    return torch.profiler.record_function(name)


class TraceWindow:
    """Step-windowed ``torch.profiler`` capture for a host loop: the capture
    opens at the ``tick`` of step ``start`` (so it sees steps from
    ``start + 1`` on, past the first steps' one-off costs) and closes at the
    ``tick`` of step ``start + length``, or at ``close()``.  ``prof`` is the
    profiler of the last capture (its ``key_averages()`` after it closed)."""

    def __init__(self, logdir: str, start: int = 3, length: int = 20):
        self.logdir = logdir
        self.start = start
        self.stop = start + length
        self.prof: Optional[torch.profiler.profile] = None
        self._active = False
        self._done = False

    def tick(self, step: int) -> None:
        if self._done:
            return
        if not self._active and self.start <= step < self.stop:
            self.prof = _start(self.logdir)
            self._active = True
        elif self._active and step >= self.stop:
            self.close()

    def close(self) -> None:
        if self._active:
            _stop(self.prof)
            self._active = False
        self._done = True


class ThroughputMeter:
    """steps/s and items/s, smoothed exponentially."""

    def __init__(self, items_per_step: int = 1, ema: float = 0.9):
        self.items_per_step = items_per_step
        self.ema = ema
        self._last: Optional[float] = None
        self._steps = 0
        self._rate: Optional[float] = None  # steps/s EMA
        self._t0 = time.perf_counter()

    def tick(self, n_steps: int = 1) -> None:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            if dt > 0:
                inst = n_steps / dt
                self._rate = inst if self._rate is None else (
                    self.ema * self._rate + (1 - self.ema) * inst)
        self._last = now
        self._steps += n_steps

    def synced_tick(self, result: torch.Tensor, n_steps: int = 1) -> None:
        """Wait for ``result``'s device to finish its work, then tick."""
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
        self.tick(n_steps)

    @property
    def steps_per_sec(self) -> float:
        return self._rate or 0.0

    @property
    def items_per_sec(self) -> float:
        return self.steps_per_sec * self.items_per_step

    @property
    def total_steps(self) -> int:
        return self._steps

    @property
    def average_steps_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._steps / dt if dt > 0 else 0.0

    def metrics(self, prefix: str = "perf") -> Dict[str, float]:
        return {
            f"{prefix}.steps_per_sec": self.steps_per_sec,
            f"{prefix}.items_per_sec": self.items_per_sec,
        }
