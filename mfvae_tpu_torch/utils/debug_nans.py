"""The ``train.debug_nans`` guard.

The JAX package sets ``jax_debug_nans``, which raises
``FloatingPointError`` on the first NaN that any primitive outputs, forward
or backward, a Pallas call included.  Eager PyTorch has no such switch, so
``NanGuard`` builds one for a run:

- a forward hook on every module of the model raises on a NaN in the
  module's outputs, naming the module (the innermost module fires first);
- the ELBO-tail wrappers (``ops/fused_elbo.py``) check the outputs of
  K1-K3, or of their plain versions on the CPU, naming the kernel;
- ``torch.autograd.set_detect_anomaly(True, check_nan=True)`` checks every
  backward function's outputs; its error is raised again as
  ``FloatingPointError``.

Unlike JAX's global flag, the guard holds only inside its ``with`` block:
the hooks are removed, the kernels' check unset and the anomaly mode put
back as it was when the block ends, so nothing leaks into a later run in
the same process.  Each check reads a flag back from the device: a host
sync per module and kernel, paid only while the guard is on.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mfvae_tpu_torch.ops import fused_elbo

_ANOMALY_NAN = "returned nan values"  # torch's anomaly-mode message


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def check_nan(where: str, *outputs) -> None:
    """Raise ``FloatingPointError`` if any floating tensor in ``outputs``
    holds a NaN (infinities pass, as under ``jax_debug_nans``)."""
    for t in _tensors(outputs):
        if t.is_floating_point() and bool(torch.isnan(t).any()):
            raise FloatingPointError(f"debug_nans: NaN in the output of {where}")


class NanGuard:
    """``with NanGuard(model): ...`` raises ``FloatingPointError`` on the
    first NaN out of a module of ``model``, out of K1-K3, or out of a
    backward function."""

    def __init__(self, model: nn.Module):
        self.model = model
        self._handles = []
        self._anomaly: Optional[tuple] = None

    def __enter__(self) -> "NanGuard":
        root = type(self.model).__name__
        for name, module in self.model.named_modules():
            where = f"module {name or root} ({type(module).__name__})"
            self._handles.append(module.register_forward_hook(
                lambda m, args, out, where=where: check_nan(where, out)))
        fused_elbo.set_nan_check(check_nan)
        self._anomaly = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
        torch.autograd.set_detect_anomaly(True, check_nan=True)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        for h in self._handles:
            h.remove()
        self._handles.clear()
        fused_elbo.set_nan_check(None)
        torch.autograd.set_detect_anomaly(*self._anomaly)
        if isinstance(exc, RuntimeError) and _ANOMALY_NAN in str(exc):
            raise FloatingPointError(f"debug_nans: NaN in the backward: {exc}") from exc
        return False
