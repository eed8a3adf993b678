"""The port's tracing: profiler traces, named spans and counters.

- ``trace(log_dir)``: a context manager over ``torch.profiler.profile``
  (host and, where there is one, CUDA activity) that writes a
  TensorBoard-viewable trace into ``log_dir`` through
  ``tensorboard_trace_handler`` when it closes.  It waits for the device
  before the trace stops, so the kernels queued inside it are in the
  trace.  Open it with ``tensorboard --logdir <log_dir>`` (the PyTorch
  Profiler plugin) or load the ``*.pt.trace.json`` file in Perfetto.
- ``span(name)``: a named span at a layer boundary.  While
  ``torch.profiler`` records, it is the host event
  ``mfvae.<name>`` (``record_function``), on the profiler's clock beside
  the device operations, inside the span around it; with CUDA activity
  the profiler also draws it on the device timeline (its
  ``gpu_user_annotation`` range), which times the kernels launched in it.
  With no profiler recording, a span is one shared ``nullcontext``: one
  flag check, no event.
- ``count(name, n=1)``: integer counters, always on; ``counters()`` is a
  copy of them, ``reset_counters()`` clears them.  The kernels K1-K3w
  (``ops/fused_elbo.py``) count their launches as ``k1.launches``,
  ``k2.launches``, ``k3.launches`` and ``k3w.launches``, K4
  (``ops/lookup_grad.py``) as ``k4.launches``; ``WorldModel`` (``inference.py``)
  its rollout steps as ``rollout.graph_replays`` (a step served by a CUDA
  graph) or ``rollout.eager_steps`` (a step run eagerly), and its captures
  as ``rollout.graph_captures``: replays over all steps is the graphs'
  hit share.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler

PREFIX = "mfvae."
_OFF = contextlib.nullcontext()
_COUNTERS: Dict[str, int] = {}


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


def span(name: str):
    """The span ``mfvae.<name>`` while a profiler records, else a no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return record_function(PREFIX + name)


def count(name: str, n: int = 1) -> None:
    _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counters() -> Dict[str, int]:
    return dict(_COUNTERS)


def reset_counters() -> None:
    _COUNTERS.clear()
