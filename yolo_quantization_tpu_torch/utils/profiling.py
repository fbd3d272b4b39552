"""Profiling and metrics: the counterpart of
``yolo_quantization_tpu/utils/profiling.py``.

  - ``trace(logdir)``: a ``torch.profiler`` context over the enclosed block
    (CPU, and CUDA where there is a card) that writes a Chrome trace into
    ``logdir``, viewable in Perfetto or chrome://tracing;
  - ``StepTimer``: wall-clock step time with an exponential moving average;
    given a CUDA device it synchronizes it before reading the clock, since
    the card runs behind the host;
  - ``MetricsWriter``: append-only JSONL metrics, one object per step.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block; on exit write
    ``<logdir>/trace_<pid>_<ns>.json`` (Chrome trace format).  Yields the
    profiler, whose ``key_averages()`` gives a table."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@dataclass
class StepTimer:
    """Rolling-average step timer (an EMA, like darknet's avg loss).
    ``device``: a CUDA device to synchronize in ``start`` and ``stop``."""

    decay: float = 0.9
    avg: float | None = None
    device: torch.device | str | None = None
    _t0: float = field(default=0.0, repr=False)

    def _sync(self):
        if self.device is not None and torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        self._sync()
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        self._sync()
        dt = time.perf_counter() - self._t0
        self.avg = dt if self.avg is None else self.decay * self.avg + (1 - self.decay) * dt
        return dt


class MetricsWriter:
    """Append-only JSONL metrics, one object per step or event."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def write(self, step: int, **metrics):
        rec = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        self._f.close()
