"""Tensor-parallel placements of MAVAE parameters (mirror of
``mfvae_tpu/parallel/sharding.py``).

The rules are the JAX package's ``_spec_for``, read on each parameter's
flax path (``models/convert.py`` ``flax_path``):

- the stacked per-agent encoders and action encoders split their agent
  axis over 'model' (each model rank owns a block of agents);
- the fused decoder trunk [2, in, out] and the unfused state/reward
  decoders split Megatron-style: even ``fc`` layers by column (the output
  dim, bias too), odd ``fc`` layers by row (the input dim, bias
  replicated), the ``out`` layer replicated;
- everything else (embeddings, heads, LayerNorms) is replicated.

A placement ``P`` holds one mesh-axis name or None per tensor dim, as
JAX's ``PartitionSpec``.  ``parallel/tp.py`` carries these placements out.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import torch

from mfvae_tpu_torch.models.convert import flax_path
from mfvae_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh


class P(tuple):
    """A placement: ``P('model', None)`` splits dim 0 over 'model'."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


class NamedSharding(NamedTuple):
    mesh: Mesh
    spec: P


def _spec_for(keys: Sequence[str], ndim: int) -> P:
    joined = "/".join(keys)

    # stacked per-agent kernels/biases: shard the agent axis
    if "encoders_" in joined or "action_encoders_" in joined:
        if ndim >= 2:
            return P(MODEL_AXIS, *([None] * (ndim - 1)))
        return P(MODEL_AXIS)

    # fused decoder trunk [2, in, out]: column/row alternation on the
    # trailing matmul dims, the decoder-id axis unsharded; its 'out' layer
    # (the last hidden layer) replicated
    if "decoder_trunk" in joined and keys[-1] == "kernel":
        layer_name = keys[-2]
        if layer_name.startswith("fc"):
            if int(layer_name[2:]) % 2 == 0:
                return P(None, None, MODEL_AXIS)
            return P(None, MODEL_AXIS, None)
        return P(None, None, None)
    if "decoder_trunk" in joined and keys[-1] == "bias":
        layer_name = keys[-2]
        if layer_name.startswith("fc") and int(layer_name[2:]) % 2 == 0:
            return P(None, MODEL_AXIS)
        return P(None, None)

    # joint decoders: alternate column/row split over fc layers
    if ("state_decoder" in joined or "reward_decoder" in joined) and keys[-1] == "kernel":
        layer_name = keys[-2]
        if layer_name.startswith("fc"):
            if int(layer_name[2:]) % 2 == 0:
                return P(None, MODEL_AXIS)  # column parallel
            return P(MODEL_AXIS, None)  # row parallel
        return P(None, None)  # output head replicated
    if ("state_decoder" in joined or "reward_decoder" in joined) and keys[-1] == "bias":
        layer_name = keys[-2]
        if layer_name.startswith("fc") and int(layer_name[2:]) % 2 == 0:
            return P(MODEL_AXIS)
        return P(None)

    return P(*([None] * ndim))


def _named_tensors(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def mavae_param_shardings(params, mesh: Mesh) -> Dict[str, NamedSharding]:
    """name -> ``NamedSharding`` for every parameter of a MAVAE (a module,
    or a name -> tensor dict such as its state_dict)."""
    return {
        name: NamedSharding(mesh, _spec_for(flax_path(name), t.dim()))
        for name, t in _named_tensors(params).items()
    }


def check_divisibility(params, shardings: Dict[str, NamedSharding]) -> Dict[str, str]:
    """The parameters whose split dim does not divide by its mesh axis's
    size, with the JAX package's message (XLA would pad; the port
    cannot)."""
    issues = {}
    for name, t in _named_tensors(params).items():
        sh = shardings[name]
        for axis_i, axis in enumerate(sh.spec):
            if axis is None:
                continue
            size = sh.mesh.shape[axis]
            if t.shape[axis_i] % size != 0:
                issues[name] = f"dim {axis_i} ({t.shape[axis_i]}) % {axis}({size}) != 0"
    return issues


def split_dim(spec: P, axis: str = MODEL_AXIS):
    """The tensor dim ``spec`` splits over ``axis``, or None."""
    return spec.index(axis) if axis in spec else None
