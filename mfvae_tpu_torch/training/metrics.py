"""Metrics sinks with the JAX package's tag names (Loss/Train,
Loss/State_Train, Loss/Reward_Train, Loss/KL_Train and the *_Test
variants).  JSONL always; TensorBoard too where tensorboardX imports;
wandb (``WandbLogger``) where it imports and is asked for."""

from __future__ import annotations

import json
import time
import weakref
from datetime import datetime
from pathlib import Path
from typing import Optional


class MetricsLogger:
    def __init__(self, log_dir: str, run_name: str = ""):
        if not run_name:
            run_name = f"run_{datetime.now().strftime('%Y-%m-%d-%H:%M:%S')}"
        self.run_dir = Path(log_dir) / run_name
        self.run_dir.mkdir(parents=True, exist_ok=True)
        try:  # imported here: it takes a second, which every rank process would pay
            from tensorboardX import SummaryWriter
        except ImportError:  # pragma: no cover
            SummaryWriter = None
        self._tb = SummaryWriter(str(self.run_dir)) if SummaryWriter is not None else None
        if self._tb is not None:
            # at exit, before multiprocessing closes the queue its writer
            # thread reads (which raised in every spawned rank)
            weakref.finalize(self, self._tb.close)
        self._jsonl = open(self.run_dir / "metrics.jsonl", "a")

    def scalar(self, tag: str, value: float, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        self._jsonl.write(
            json.dumps({"tag": tag, "value": float(value), "step": int(step), "ts": time.time()})
            + "\n"
        )

    def losses(self, outs, step: int, suffix: str = "Train"):
        """Write the four per-phase tags of a LossOutputs of floats."""
        self.scalar(f"Loss/{suffix}", float(outs.loss), step)
        self.scalar(f"Loss/State_{suffix}", float(outs.s_loss), step)
        self.scalar(f"Loss/Reward_{suffix}", float(outs.r_loss), step)
        self.scalar(f"Loss/KL_{suffix}", float(outs.kl_loss), step)

    def flush(self):
        if self._tb is not None:
            self._tb.flush()
        self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()


class NullLogger(MetricsLogger):
    """The logger of a rank other than 0 under a mesh: the same ``run_dir``,
    nothing written."""

    def __init__(self, log_dir: str, run_name: str = ""):
        self.run_dir = Path(log_dir) / run_name

    def scalar(self, tag: str, value: float, step: int):
        pass

    def flush(self):
        pass

    def close(self):
        pass


class WandbLogger:
    """Optional wandb sink (the baselines' per-update metrics).  A no-op
    for ``mode="disabled"``, and with one warning when wandb is not
    installed, so configs carrying wandb settings still run."""

    def __init__(self, project: str = "mfvae_tpu", mode: str = "disabled", **init_kwargs):
        self._run = None
        if mode == "disabled":
            return
        try:
            import wandb

            self._run = wandb.init(project=project, mode=mode, **init_kwargs)
        except ImportError:
            print("wandb not installed; WandbLogger is a no-op")

    def log(self, metrics: dict, step: Optional[int] = None):
        if self._run is not None:
            self._run.log(metrics, step=step)

    def finish(self):
        if self._run is not None:
            self._run.finish()
