"""Bridge from the JAX package's parameters to the port's (the MAVAE, the
imagination networks, the baselines' Q-networks and QMIX mixer).

The port's layers keep flax's layouts and leaf names (``layers.py``), so a
flax path ``encoders_0/fc1/kernel`` is the port's ``encoders.0.fc1.kernel``
and ``state_decoder/ln0/scale`` is ``state_decoder.ln0.scale``: only
flax's numbered submodules differ, and ``action_delta_head_<g>`` (named
per group in flax) is entry g of the port's ``action_delta_heads``.  The input is the JAX
parameter tree as nested dicts of numpy arrays (``jax.device_get`` of
``variables`` or of ``variables["params"]``); this module never imports JAX.

The Q-network's flax paths are ``AgentRNN_0/{Dense_0, ScannedGRU_0/GRUCell_0/
{ir,iz,in,hr,hz,hn}, Dense_1}/{kernel,bias}`` (``VmapAgentRNN_0`` with a
leading [N] on every leaf for independent per-agent parameters), the
port's ``agent.{dense0, gru.cell.<gate>, dense1}.<leaf>``; the mixer's
``hyper_*/{kernel,bias}`` keep their names.  The inverses return the
nested flax tree under ``params``, and ``flatten_flax`` its ``/``-joined
keys, the layout of the ``.npz`` and safetensors files.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

_LIST_MODULE = re.compile(r"^(encoders|action_encoders|action_delta_head)_(\d+)$")
_LIST_NAME = {"action_delta_head": "action_delta_heads"}
_POLICY_MODULE = re.compile(r"^(Dense|LayerNorm)_(\d+)$")


def _flatten(tree: Dict[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX parameter tree -> a state_dict for ``MAVAE.load_state_dict``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}
    for path, leaf in _flatten(tree):
        parts = []
        for p in path:
            m = _LIST_MODULE.match(p)
            parts.extend([_LIST_NAME.get(m.group(1), m.group(1)), m.group(2)] if m else [p])
        out[".".join(parts)] = torch.from_numpy(np.array(leaf, dtype=np.float32))
    return out


def policy_params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX imagination network's tree -> its state_dict in the port."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}
    for path, leaf in _flatten(tree):
        m = _POLICY_MODULE.match(path[0])
        if m is None or len(path) != 2 or (m.group(1) == "LayerNorm" and m.group(2) != "0"):
            raise ValueError(f"not an imagination network leaf: {'/'.join(path)}")
        name = "norm" if m.group(1) == "LayerNorm" else f"dense.{m.group(2)}"
        out[f"{name}.{path[1]}"] = torch.from_numpy(np.array(leaf, dtype=np.float32))
    return out


_QNET_MODULE = {"Dense_0": "dense0", "Dense_1": "dense1", "ScannedGRU_0": "gru"}
_QNET_ROOTS = ("AgentRNN_0", "VmapAgentRNN_0")


def _as_tensor(leaf) -> torch.Tensor:
    return torch.from_numpy(np.array(leaf, dtype=np.float32))


def qnet_params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``VdnNetwork`` tree -> the port's ``VdnNetwork`` state_dict."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    if len(tree) != 1 or next(iter(tree)) not in _QNET_ROOTS:
        raise ValueError(f"not a VdnNetwork tree: top-level {sorted(tree)}")
    out = {}
    for path, leaf in _flatten(next(iter(tree.values()))):
        if path[0] not in _QNET_MODULE or (path[0] == "ScannedGRU_0" and path[1] != "GRUCell_0"):
            raise ValueError(f"not a VdnNetwork leaf: {'/'.join(path)}")
        parts = [_QNET_MODULE[path[0]]] + (["cell"] + list(path[2:]) if path[0] == "ScannedGRU_0" else list(path[1:]))
        out["agent." + ".".join(parts)] = _as_tensor(leaf)
    return out


def qnet_params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``VdnNetwork`` state_dict -> the JAX tree (numpy leaves)."""
    inverse = {v: k for k, v in _QNET_MODULE.items()}
    stacked = state_dict["agent.dense0.kernel"].dim() == 3
    root: Dict[str, Any] = {}
    for name, t in state_dict.items():
        parts = name.split(".")[1:]
        path = [inverse[parts[0]]] + (["GRUCell_0"] + parts[2:] if parts[0] == "gru" else parts[1:])
        node = root
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = t.detach().cpu().numpy()
    return {"params": {_QNET_ROOTS[stacked]: root}}


def mixer_params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``MixingNetwork`` tree -> the port's state_dict."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}
    for path, leaf in _flatten(tree):
        if len(path) != 2 or not path[0].startswith("hyper_"):
            raise ValueError(f"not a MixingNetwork leaf: {'/'.join(path)}")
        out[".".join(path)] = _as_tensor(leaf)
    return out


def mixer_params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for name, t in state_dict.items():
        module, leaf = name.split(".")
        root.setdefault(module, {})[leaf] = t.detach().cpu().numpy()
    return {"params": root}


def flatten_flax(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A nested flax tree -> {"a/b/c": leaf}."""
    return {"/".join(path): np.asarray(leaf) for path, leaf in _flatten(tree)}


def unflatten_flax(flat: Dict[str, Any]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for key, leaf in flat.items():
        *head, last = key.split("/")
        node = root
        for p in head:
            node = node.setdefault(p, {})
        node[last] = leaf
    return root
