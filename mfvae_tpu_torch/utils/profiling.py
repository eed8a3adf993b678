"""Tracing and profiling hooks (mirror of ``mfvae_tpu/utils/profiling.py``).

- ``trace(log_dir)``: a context manager over ``torch.profiler.profile``
  (host and, where there is one, CUDA activity) that writes a
  TensorBoard-viewable trace into ``log_dir`` through
  ``tensorboard_trace_handler`` when it closes.  It waits for the device
  before the trace stops, so the kernels queued inside it are in the
  trace.  Open it with ``tensorboard --logdir <log_dir>`` (the PyTorch
  Profiler plugin) or load the ``*.pt.trace.json`` file in Perfetto.
- ``annotate(name)``: a named span in the trace
  (``torch.profiler.record_function``).
- ``StepTimer``: per-step wall timing with an EMA, for the metrics path.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()


def annotate(name: str):
    return record_function(name)


class StepTimer:
    def __init__(self, ema: float = 0.9):
        self._ema = ema
        self._avg: Optional[float] = None
        self._t0: Optional[float] = None
        self.last: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.last = time.perf_counter() - self._t0
        self._avg = (
            self.last
            if self._avg is None
            else self._ema * self._avg + (1 - self._ema) * self.last
        )
        return False

    @property
    def avg(self) -> Optional[float]:
        return self._avg

    def rate(self, items: int) -> Optional[float]:
        return items / self._avg if self._avg else None
