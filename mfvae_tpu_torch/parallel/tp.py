"""The tensor-parallel MAVAE forward over the mesh's 'model' axis.

The JAX package annotates parameter placements (``parallel/sharding.py``)
and XLA's partitioner inserts the collectives.  The port has no
partitioner, so this module carries the placements out by hand, with four
differentiable collectives over one mesh axis:

- ``copy``: identity forward, sum over the axis backward (a replicated
  input entering split work, Megatron's f);
- ``reduce``: sum over the axis forward, identity backward (the partial
  products of a row-parallel layer, Megatron's g);
- ``gather``: all-gather on a dim forward, this rank's slice backward;
- ``scatter``: this rank's slice forward, all-gather backward.

The loss is replicated on every model rank, so every backward here is the
one that gives each rank the true gradient.  The library's
``torch.distributed.nn.functional.all_reduce``/``all_gather`` sum the
gradient over the ranks in their backward instead, which would multiply
every gradient by the axis size.

``shard_model_`` keeps each rank's slice of the parameters that
``mavae_param_shardings`` splits and reroutes the forwards of the split
modules, so ``MAVAE.forward``/``fused_call``/``mean_call`` run unchanged:

- an encoder or action encoder takes its agents' rows of the replicated
  input and all-gathers its output on the agent axis.  So the latents (mu,
  logvar, the action embeddings) are whole before the reparameterization:
  K1/K2 run replicated on each model rank over the full [B, A, F], and K3
  over the full target, as a Pallas call under XLA's partitioner gets
  replicated operands; the decoder's column-parallel fc0 needs the whole
  input anyway;
- a decoder's even fc is column-parallel behind ``copy``, its odd fc
  row-parallel ahead of ``reduce`` and its bias; a column layer gathers its
  output where the next layer needs the whole of it (no row layer follows,
  or a LayerNorm does, and then the row layer scatters it again).

Parameter names, and so checkpoints, stay those of the unsharded model;
``full_state_dict``/``load_full_state_dict_`` and their optimizer
counterparts move between the shards and the whole tensors.
"""

from __future__ import annotations

import types
from typing import Dict

import torch

from mfvae_tpu_torch.models.layers import MLP, StackedDense, StackedMLP
from mfvae_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh
from mfvae_tpu_torch.parallel.sharding import mavae_param_shardings, split_dim


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axis), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _own(x, mesh: Mesh, axis: str, dim: int):
    n = x.shape[dim] // mesh.shape[axis]
    return x.narrow(dim, mesh.index(axis) * n, n)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.mesh, ctx.axis, ctx.dim).contiguous(), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _own(x, mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.axis, ctx.dim), None, None, None


def copy(x: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    return _Copy.apply(x, mesh, axis) if x.is_floating_point() else x


def reduce(x: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    return _Reduce.apply(x, mesh, axis)


def gather(x: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS, dim: int = -1) -> torch.Tensor:
    return _Gather.apply(x, mesh, axis, dim % x.dim())


def scatter(x: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS, dim: int = -1) -> torch.Tensor:
    return _Scatter.apply(x, mesh, axis, dim % x.dim())


# --------------------------------------------------------------- the forwards
def _agent_parallel_forward(self, x):
    """A stacked per-agent module on its agents' rows, gathered over 'model'."""
    x = _own(copy(x, self.tp_mesh), self.tp_mesh, MODEL_AXIS, 1)
    return gather(type(self).forward(self, x), self.tp_mesh, MODEL_AXIS, 1)


def _column_forward(self, x):
    y = type(self).forward(self, copy(x, self.tp_mesh))
    return gather(y, self.tp_mesh) if self.tp_gather else y


def _row_forward(self, x):
    if self.tp_scatter:
        x = scatter(x, self.tp_mesh)
    x = x.to(self.dtype)
    k = self.kernel.to(self.dtype)
    y = torch.einsum("bai,aio->bao", x, k) if isinstance(self, StackedDense) else x @ k
    y = reduce(y, self.tp_mesh)
    return y + (self.bias.to(self.dtype)[None] if isinstance(self, StackedDense) else self.bias.to(self.dtype))


def _route(module: torch.nn.Module, forward, mesh: Mesh, **flags) -> None:
    module.tp_mesh = mesh
    for k, v in flags.items():
        setattr(module, k, v)
    # a bound method: deepcopy rebinds it to the copied module
    module.forward = types.MethodType(forward, module)


def _shard_mlp(mlp, mesh: Mesh) -> None:
    """Megatron column/row pairs over an MLP's or StackedMLP's fc layers."""
    n = mlp.n_hidden
    for i in range(n):
        fc = getattr(mlp, f"fc{i}")
        if i % 2 == 0:
            whole_next = i + 1 == n or mlp.layernorm
            _route(fc, _column_forward, mesh, tp_gather=whole_next)
        else:
            _route(fc, _row_forward, mesh, tp_scatter=mlp.layernorm)


def shard_model_(model: torch.nn.Module, mesh: Mesh) -> None:
    """Keep this rank's slice of each parameter split over 'model' and
    route the forwards through the collectives (see the module docstring).
    Call before the optimizer is built; every rank calls it with the same
    whole parameters."""
    shardings = mavae_param_shardings(model, mesh)
    # the split dim of each parameter (None: replicated), kept on the module
    # so that a deepcopy keeps it
    model.tp_dims = {}
    for name, p in model.named_parameters():
        dim = model.tp_dims[name] = split_dim(shardings[name].spec)
        if dim is not None:
            p.data = _own(p.data, mesh, MODEL_AXIS, dim).clone()
    for enc in list(model.encoders) + list(model.action_encoders):
        _route(enc, _agent_parallel_forward, mesh)
    for name in ("decoder_trunk", "state_decoder", "reward_decoder"):
        mlp = getattr(model, name, None)
        if isinstance(mlp, (MLP, StackedMLP)):
            _shard_mlp(mlp, mesh)


def split_dims(model: torch.nn.Module) -> list:
    """The split dim of each of ``model.parameters()`` (None: replicated)."""
    dims = getattr(model, "tp_dims", {})
    return [dims.get(n) for n, _ in model.named_parameters()]


def is_sharded(model: torch.nn.Module) -> bool:
    return any(d is not None for d in split_dims(model))


# ------------------------------------------------- shards <-> whole tensors
def _whole(t: torch.Tensor, dim, mesh: Mesh) -> torch.Tensor:
    return t if dim is None else mesh.all_gather(t, MODEL_AXIS, dim)


def full_state_dict(model: torch.nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The whole parameters (gathered over 'model'), by the unsharded names."""
    return {n: _whole(p.detach(), d, mesh) for (n, p), d in zip(model.named_parameters(), split_dims(model))}


def load_full_state_dict_(model: torch.nn.Module, state: Dict[str, torch.Tensor], mesh: Mesh) -> None:
    with torch.no_grad():
        for (n, p), dim in zip(model.named_parameters(), split_dims(model)):
            t = state[n].to(p.device)
            p.copy_(t if dim is None else _own(t, mesh, MODEL_AXIS, dim))


def full_optimizer_state(optimizer: torch.optim.Optimizer, model: torch.nn.Module, mesh: Mesh) -> dict:
    """The optimizer's state_dict with every per-parameter tensor of a
    split parameter gathered whole."""
    sd = optimizer.state_dict()
    dims = split_dims(model)
    sd["state"] = {
        i: {k: _whole(v, dims[i], mesh) if torch.is_tensor(v) and v.dim() else v for k, v in s.items()}
        for i, s in sd["state"].items()
    }
    return sd


def load_full_optimizer_state_(optimizer: torch.optim.Optimizer, sd: dict, model: torch.nn.Module,
                               mesh: Mesh) -> None:
    dims = split_dims(model)
    local = dict(sd)
    local["state"] = {
        i: {k: _own(v, mesh, MODEL_AXIS, dims[int(i)]).clone()
            if torch.is_tensor(v) and v.dim() and dims[int(i)] is not None else v
            for k, v in s.items()}
        for i, s in sd["state"].items()
    }
    optimizer.load_state_dict(local)
