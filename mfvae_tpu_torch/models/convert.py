"""Bridge from the JAX package's parameters to the port's (the MAVAE, the
imagination networks, the baselines' Q-networks and QMIX mixer, and the
VAE families).

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

The VAE families' dense layers keep flax's names and layout
(``encoder/fc0/kernel`` is ``encoder.fc0.kernel``; ``encoders_0`` is
``encoders.0``).  Their convolutions hold torch's layout: a flax ``Conv``
kernel HWIO becomes ``weight`` OIHW, a ``ConvTranspose`` kernel HWIO is
flipped in both spatial axes and becomes [in, out, kH, kW].  These
bridges raise on a leaf they do not know, and ``load_state_dict`` (strict
by default) on a missing one.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List

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


def flax_path(name: str) -> List[str]:
    """A MAVAE parameter name -> its flax path: ``encoders.0.fc1.kernel`` ->
    ``['encoders_0', 'fc1', 'kernel']``."""
    inverse = {v: k for k, v in _LIST_NAME.items()}
    parts = name.split(".")
    path, i = [], 0
    while i < len(parts):
        if i + 1 < len(parts) and parts[i + 1].isdigit():
            path.append(f"{inverse.get(parts[i], parts[i])}_{parts[i + 1]}")
            i += 2
        else:
            path.append(parts[i])
            i += 1
    return path


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A MAVAE state_dict -> the JAX parameter tree (nested dicts of numpy
    float32 arrays, without the ``params`` key): the inverse of
    ``params_from_jax``."""
    root: Dict[str, Any] = {}
    for name, t in state_dict.items():
        path = flax_path(name)
        node = root
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = t.detach().cpu().numpy()
    return root


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


_VAE_DENSE = re.compile(r"^(fc\d+|out)$")


def _dense_leaf(path, leaf, owner: str) -> torch.Tensor:
    if len(path) != 3 or not _VAE_DENSE.match(path[1]) or path[2] not in ("kernel", "bias"):
        raise ValueError(f"not a {owner} leaf: {'/'.join(path)}")
    return _as_tensor(leaf)


def vae_params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``VAE`` tree -> the port's ``VAE`` state_dict."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}
    for path, leaf in _flatten(tree):
        if path[0] not in ("encoder", "decoder"):
            raise ValueError(f"not a VAE leaf: {'/'.join(path)}")
        out[".".join(path)] = _dense_leaf(path, leaf, "VAE")
    return out


_CONV_MODULE = re.compile(r"^(enc|dec)(\d+)$")


def conv_vae_params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``ConvVAE`` tree -> the port's ``ConvVAE`` state_dict."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}
    for path, leaf in _flatten(tree):
        if len(path) != 2 or path[1] not in ("kernel", "bias"):
            raise ValueError(f"not a ConvVAE leaf: {'/'.join(path)}")
        t = _as_tensor(leaf)
        m = _CONV_MODULE.match(path[0])
        if path[0] in ("enc_head", "dec_head"):
            out[".".join(path)] = t
        elif m is None:
            raise ValueError(f"not a ConvVAE leaf: {'/'.join(path)}")
        elif path[1] == "bias":
            out[f"{path[0]}.bias"] = t
        elif m.group(1) == "enc":  # HWIO -> OIHW
            out[f"{path[0]}.weight"] = t.permute(3, 2, 0, 1).contiguous()
        else:  # HWIO, flipped in H and W -> [in, out, kH, kW]
            out[f"{path[0]}.weight"] = t.flip(0, 1).permute(2, 3, 0, 1).contiguous()
    return out


_FACTORIZED_MODULE = re.compile(r"^(encoders|decoders)_(\d+)$")


def factorized_params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``FactorizedMultimodalVAE`` tree -> the port's state_dict."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}
    for path, leaf in _flatten(tree):
        m = _FACTORIZED_MODULE.match(path[0])
        if m is None:
            raise ValueError(f"not a FactorizedMultimodalVAE leaf: {'/'.join(path)}")
        out[".".join((m.group(1), m.group(2)) + path[1:])] = _dense_leaf(path, leaf, "FactorizedMultimodalVAE")
    return out
