"""Data-parallel training over the mesh's 'data' axis (mirror of
``mfvae_tpu/parallel/dp.py``).

Each data rank computes the loss and gradients of its own rows; the
gradients are summed over 'data' and divided by its size before the
global-norm clip and Adam (JAX's ``pmean`` before ``tx.update``), so every
rank applies the same update to the same parameters.  The PopArt batch
moments come from summed sums and sums of squares, never from local
moments, and the losses are averaged over 'data'.  A mean of per-rank means
is the global mean because the ranks' row counts are equal.  At one data
rank the step is the plain train step, and computes the same bits.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from mfvae_tpu_torch.config import LossConfig
from mfvae_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
from mfvae_tpu_torch.rng import stream_seed


def broadcast_parameters_(module: torch.nn.Module, mesh: Mesh) -> None:
    """Every parameter overwritten with world rank 0's, in one collective."""
    params = [p.data for p in module.parameters()]
    flat = mesh.broadcast_(_flatten_dense_tensors(params), src=0)
    for p, src in zip(params, _unflatten_dense_tensors(flat, params)):
        p.copy_(src)


def average_gradients(params, mesh: Mesh) -> None:
    """Every ``.grad`` replaced by its mean over 'data', in one collective."""
    n = mesh.shape[DATA_AXIS]
    if n == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = mesh.all_reduce(_flatten_dense_tensors(grads), DATA_AXIS) / n
    for g, avg in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(avg)


def mean_over_data(xs, mesh: Mesh):
    """A tuple of scalar tensors averaged over 'data', in one collective."""
    n = mesh.shape[DATA_AXIS]
    if n == 1:
        return xs
    avg = mesh.all_reduce(torch.stack(list(xs)), DATA_AXIS) / n
    return type(xs)(*avg.unbind())


def make_dp_train_step(
    loss_cfg: LossConfig,
    mesh: Mesh,
    mode: str = "Adam",
    popart_beta: float = 3e-4,
) -> Callable:
    """``step(state, batch, generator) -> (state, LossOutputs)``: ``batch``
    holds this data rank's rows (its block of the global batch), the state
    is replicated.

    As in the JAX package the eps of each data rank are decorrelated by
    folding the rank into the key: at more than one data rank one seed is
    drawn from ``generator`` (the same on every rank) and the rank's
    generator is seeded from (seed, rank).  At one data rank the generator
    is used as it is, so the step is the plain step.  (The experiment's
    sharded epoch instead draws every eps at its global shape and keeps the
    rank's rows: ``training/trainer.py``.)"""
    from mfvae_tpu_torch.training.trainer import make_train_step  # it imports this module

    inner = make_train_step(loss_cfg, mode, popart_beta, mesh=mesh)
    ndev = mesh.shape[DATA_AXIS]

    def step(state, batch, generator):
        if ndev > 1:
            seed = int(torch.randint(0, 2**62, (), generator=generator, device=generator.device))
            generator = torch.Generator(device=generator.device)
            generator.manual_seed(stream_seed(seed, mesh.index(DATA_AXIS)))
        return inner(state, batch, generator)

    return step
