"""Multi-seed training on one device (mirror of
``mfvae_tpu/training/multiseed.py``).

The JAX package vmaps its fused epoch program over a seed axis.  Here N
independent replicas, each with its own env carry, buffers, parameters,
optimizer and PopArt state on the device, advance in lockstep, epoch by
epoch.  Replica i is built and run exactly as the single-seed
``Experiment`` with ``train.seed`` = seeds[i] (``Experiment.build`` and
``run_epoch``: the same streams, drawn in the same order), so
``run_multiseed(cfg, [s])`` gives ``Experiment(cfg with seed s).run()``'s
losses, and a replica depends on its seed's value, not on its position.

Memory grows linearly with the seed count: each replica holds two
``buffer.max_size`` rings.  ``replica_batch`` runs a larger sweep as
groups of that many replicas, one group after another.
"""

from __future__ import annotations

import copy
import time
from typing import Optional, Sequence

import numpy as np
import torch

from mfvae_tpu_torch.config import ExperimentConfig
from mfvae_tpu_torch.training.experiment import Experiment


def _summary(cfg: ExperimentConfig, seeds, train_final, test_final) -> dict:
    train_final = np.asarray(train_final, dtype=np.float32)
    return {
        "seeds": [int(s) for s in seeds],
        "loss_train": [float(x) for x in train_final],
        "loss_test": [float(x) for x in test_final],
        "train_mean": float(train_final.mean()),
        "train_std": float(train_final.std()),
        "train_min": float(train_final.min()),
        "train_max": float(train_final.max()),
        "epochs": int(cfg.train.epoch_num),
        "n_seeds": len(train_final),
    }


def run_multiseed(
    cfg: ExperimentConfig,
    seeds: Sequence[int],
    epochs_per_dispatch: Optional[int] = None,
    replica_batch: Optional[int] = None,
    tail_metrics: bool = False,
    device="cuda",
) -> dict:
    """Train len(seeds) independent replicas of the experiment in lockstep.
    Returns the per-seed final losses and their spread: ``seeds``,
    ``loss_train``, ``loss_test``, ``train_mean``/``std``/``min``/``max``,
    ``epochs``, ``n_seeds``; with ``tail_metrics``, ``test_loss_tail``, the
    per-seed test losses of the epochs of the last chunk of K =
    ``epochs_per_dispatch`` (or ``train.epochs_per_dispatch``) epochs
    ([N, k]), as the JAX package returns its last dispatch's.  Beside
    JAX's keys, ``epoch_wall_s``: the wall seconds of each lockstep epoch
    of all the replicas, each ending in a device sync (summed over the
    groups under ``replica_batch``).

    Single-env only (``train.n_envs`` must be 1), as in the JAX package.
    Nothing is logged or checkpointed."""
    if cfg.train.n_envs != 1:
        raise ValueError("multiseed runs the single-env epoch program: train.n_envs must be 1")
    seeds = list(seeds)
    if replica_batch and replica_batch < len(seeds):
        parts = [
            run_multiseed(cfg, seeds[i : i + replica_batch], epochs_per_dispatch,
                          tail_metrics=tail_metrics, device=device)
            for i in range(0, len(seeds), replica_batch)
        ]
        out = _summary(
            cfg, sum((p["seeds"] for p in parts), []),
            sum((p["loss_train"] for p in parts), []), sum((p["loss_test"] for p in parts), []),
        )
        out["epoch_wall_s"] = [sum(w) for w in zip(*(p["epoch_wall_s"] for p in parts))]
        if tail_metrics:
            out["test_loss_tail"] = sum((p["test_loss_tail"] for p in parts), [])
        return out

    K = epochs_per_dispatch or max(cfg.train.epochs_per_dispatch, 1)
    n_epochs = cfg.train.epoch_num
    tail_from = K * ((n_epochs - 1) // K)  # the last chunk's first epoch
    replicas = []
    for seed in seeds:
        rcfg = copy.deepcopy(cfg)
        rcfg.train.seed = int(seed)
        replicas.append(Experiment(rcfg, device).build())
    train_loss = [[] for _ in replicas]  # on the device until the end
    test_loss = [[] for _ in replicas]
    epoch_wall = []
    for _ in range(n_epochs):
        t_epoch = time.perf_counter()
        for i, exp in enumerate(replicas):
            m = exp.run_epoch()
            train_loss[i].append(m.train.loss)
            test_loss[i].append(m.test.loss)
        if replicas[0].device.type == "cuda":
            torch.cuda.synchronize(replicas[0].device)
        epoch_wall.append(time.perf_counter() - t_epoch)
    train = torch.stack([torch.stack(x) for x in train_loss]).cpu().numpy()  # [N, epochs]
    test = torch.stack([torch.stack(x) for x in test_loss]).cpu().numpy()
    out = _summary(cfg, seeds, train[:, -1], test[:, -1])
    out["epoch_wall_s"] = epoch_wall
    if tail_metrics:
        out["test_loss_tail"] = test[:, tail_from:].tolist()
    return out
