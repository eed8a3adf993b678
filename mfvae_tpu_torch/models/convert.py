"""Bridge from the JAX package's MAVAE parameters to the port's.

The port's layers keep flax's layouts and leaf names (``layers.py``), so a
flax path ``encoders_0/fc1/kernel`` is the port's ``encoders.0.fc1.kernel``
and ``state_decoder/ln0/scale`` is ``state_decoder.ln0.scale``: only
flax's numbered submodules differ, and ``action_delta_head_<g>`` (named
per group in flax) is entry g of the port's ``action_delta_heads``.  The input is the JAX
parameter tree as nested dicts of numpy arrays (``jax.device_get`` of
``variables`` or of ``variables["params"]``); this module never imports JAX.
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
