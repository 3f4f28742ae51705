"""Stats logging: named running averages, a progress line and file sinks.

Copy of ``diffuscene_tpu/utils/stats_logger.py`` (reference
``scene_synthesis/stats_logger.py:7-64``) without the W&B sink: the port's
machines have no network.
"""
from __future__ import annotations

import sys
from typing import Dict, Optional, TextIO


class AverageAggregator:
    """(stats_logger.py:7-19) — assignment accumulates; read returns the mean."""

    def __init__(self):
        self._value = 0.0
        self._count = 0

    @property
    def value(self) -> float:
        return self._value / max(self._count, 1)

    @value.setter
    def value(self, val: float):
        self._value += float(val)
        self._count += 1


class StatsLogger:
    __INSTANCE: Optional["StatsLogger"] = None

    def __init__(self):
        if StatsLogger.__INSTANCE is not None:
            raise RuntimeError("StatsLogger should not be directly created")
        self._values: Dict[str, AverageAggregator] = {}
        self._loss = AverageAggregator()
        self._output_files = [sys.stdout]

    def add_output_file(self, f: TextIO):
        self._output_files.append(f)

    def remove_output_file(self, f: TextIO):
        """Detach (and close) a per-run stats file.  The logger is a
        process-wide singleton (stats_logger.py:22-64 semantics), so CLIs
        that run multiple trainings in one process must detach their file
        when done or later runs keep writing into it."""
        if f in self._output_files:
            self._output_files.remove(f)
        f.close()

    def __getitem__(self, key: str) -> AverageAggregator:
        if key not in self._values:
            self._values[key] = AverageAggregator()
        return self._values[key]

    def update(self, metrics: Dict[str, float]):
        """Push a whole metrics dict (e.g. a train step's output)."""
        for k, v in metrics.items():
            self[k].value = float(v)

    def clear(self):
        self._values.clear()
        self._loss = AverageAggregator()
        for f in self._output_files:
            if f.isatty():
                print(file=f, flush=True)

    def print_progress(self, epoch: int, batch: int, loss: float, precision="{:.5f}"):
        self._loss.value = loss
        fmt = "epoch: {} - batch: {} - loss: " + precision
        msg = fmt.format(epoch, batch, self._loss.value)
        for k, v in self._values.items():
            msg += " - " + k + ": " + precision.format(v.value)
        for f in self._output_files:
            if f.isatty():
                print(msg + "\b" * len(msg), end="", flush=True, file=f)
            else:
                print(msg, flush=True, file=f)

    @classmethod
    def instance(cls) -> "StatsLogger":
        if StatsLogger.__INSTANCE is None:
            StatsLogger.__INSTANCE = cls()
        return StatsLogger.__INSTANCE

    @classmethod
    def reset_instance(cls):
        cls.__INSTANCE = None
