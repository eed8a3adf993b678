"""Checkpoint/resume with ``torch.save`` (the JAX package uses orbax).

A checkpoint is a dict of tensors, numbers, lists and dicts — the full
training carry flattened by ``training/experiment.py`` — written to
``<dir>/ckpt_<step>.pt`` through a temporary file and a rename, so a crash
mid-write never leaves a truncated checkpoint under the final name.  It is
read back with ``weights_only=True`` onto the CPU; the caller moves it to
its device.

``restore`` takes the JAX package's ``like=`` and does not need it: orbax
restores against a template of shapes and dtypes, while a torch payload
describes itself.  Saves are synchronous, so ``wait`` and ``close`` have
nothing in flight to wait for.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Dict, Optional

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class NullCheckpointManager:
    """Checkpointing disabled (train.checkpoint_dir='').  Same surface as
    CheckpointManager; save/wait/close are no-ops, restore finds nothing."""

    directory = None

    def save(self, step, payload) -> None:
        pass

    def restore(self, step=None, like=None):
        return None

    def latest_step(self):
        return None

    def wait(self):
        pass

    def close(self):
        pass


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        if not directory:
            raise ValueError("CheckpointManager needs a directory; use NullCheckpointManager")
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> Path:
        return self.directory / f"ckpt_{step}.pt"

    def steps(self):
        found = (_NAME.match(p.name) for p in self.directory.iterdir())
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, payload: Dict[str, Any]) -> None:
        tmp = self.directory / f".ckpt_{step}.pt.tmp.{os.getpid()}"
        torch.save(payload, tmp)
        tmp.replace(self._path(step))
        for old in self.steps()[: -self.max_to_keep]:
            self._path(old).unlink(missing_ok=True)

    def restore(self, step: Optional[int] = None, like: Optional[Dict[str, Any]] = None
                ) -> Optional[Dict[str, Any]]:
        """Load ``step`` (default: the latest) onto the CPU; None if there
        is no checkpoint.  ``like`` (the JAX package's restore template) is
        accepted and unused: the payload carries its own shapes and dtypes."""
        del like
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def wait(self):
        """Saves are synchronous; kept for the JAX package's surface."""

    def close(self):
        """Waits for any save in flight (none: saves are synchronous) and
        releases the manager; a second close is harmless."""
        self.wait()
