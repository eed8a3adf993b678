"""Reference-format MAVAE parameters in and out of the port (mirror of
``mfvae_tpu/models/import_reference.py``).

The reference pickles its flax parameter tree (``jax_ver/main.py:239-240``)
in per-agent modules: ``encoders_<agent>`` (hidden ``fc{i}`` and one
unnamed output Dense, ``Dense_0``), ``action_encoders_<agent>``, joint
``state_decoder``/``reward_decoder`` of unnamed Denses (``Dense_0..N``),
``idx_emb`` and ``reward_linear``.  ``import_reference_params`` restacks
that tree into the grouped layout (one stacked module per (obs_dim,
act_dim) group) as the JAX package does and hands it through the port's
bridge (``convert.params_from_jax``): the result is a state_dict for a
MAVAE with ``fused_decoders=False`` and matching widths.
``export_reference_params`` goes the other way, from either decoder
layout.

Pickles: the reference's file holds JAX arrays, and unpickling those
imports JAX, which the port never does.  ``load_reference_pickle`` reads
through a restricted unpickler that finds only numpy's array and scalar
classes and plain builtin containers and scalars; a pickle that needs
anything else (a JAX array, a flax ``FrozenDict``) is refused with a
``ValueError``: convert its leaves to numpy first, e.g. with
``pickle.dump(jax.tree.map(np.asarray, params), f)`` where JAX is
installed.

The torch reference's ``state_dict`` (``torch_ver/model.py:175-176``)
lacks the per-agent encoders, which it keeps in plain dicts;
``import_torch_state_dict`` transfers what it holds and lists the rest.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from mfvae_tpu_torch.models.convert import params_from_jax, params_to_jax
from mfvae_tpu_torch.models.mavae import AgentSpec

# what a pickle of numpy arrays in plain containers needs, and nothing else
_NUMPY_CLASSES = {
    ("numpy", "ndarray"), ("numpy", "dtype"), ("_codecs", "encode"),
    ("numpy.core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"), ("numpy._core.numeric", "_frombuffer"),
}
_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "int", "float", "complex", "bool",
             "str", "bytes", "bytearray", "slice", "range"}


class _NumpyUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if ((module, name) in _NUMPY_CLASSES
                or (module == "builtins" and name in _BUILTINS)
                or (module == "numpy.dtypes" and name.endswith("DType"))):
            return super().find_class(module, name)
        raise ValueError(
            f"this pickle needs {module}.{name}; the port loads only numpy arrays in plain "
            "containers: convert its leaves to numpy first (where JAX is installed: "
            "pickle.dump(jax.tree.map(np.asarray, params), f))"
        )


def load_numpy_pickle(path: str) -> Any:
    """``pickle.load`` restricted to numpy arrays in plain containers."""
    with open(path, "rb") as f:
        return _NumpyUnpickler(f).load()


def _unwrap(tree: Dict[str, Any]) -> Dict[str, Any]:
    return tree["params"] if "params" in tree and "idx_emb" not in tree else tree


def _ordered_dense_names(module_tree: Dict[str, Any]) -> list:
    """The reference MLP's layer order: the named hiddens fc0..fcN
    (Encoder), then the unnamed Dense_0..Dense_M in creation order."""
    fcs = sorted((k for k in module_tree if k.startswith("fc")), key=lambda s: int(s[2:]))
    denses = sorted((k for k in module_tree if k.startswith("Dense_")), key=lambda s: int(s.split("_")[1]))
    return fcs + denses


def _dense(leaf: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {"kernel": np.asarray(leaf["kernel"]), "bias": np.asarray(leaf["bias"])}


def _map_mlp(module_tree: Dict[str, Any]) -> Dict[str, Any]:
    """A reference MLP module -> {fc0..fcN, out}."""
    names = _ordered_dense_names(module_tree)
    return {("out" if i == len(names) - 1 else f"fc{i}"): _dense(module_tree[name]) for i, name in enumerate(names)}


def _stacked_mlp(module_trees) -> Dict[str, Any]:
    """One reference MLP module per agent of a group -> {fc0..fcN, out}
    with a leading agent axis on every leaf."""
    per_agent = [_map_mlp(t) for t in module_trees]
    return {layer: {k: np.stack([m[layer][k] for m in per_agent]) for k in ("kernel", "bias")}
            for layer in per_agent[0]}


def import_reference_params(ref_tree: Dict[str, Any], spec: AgentSpec) -> Dict[str, torch.Tensor]:
    """Restack a reference MAVAE parameter tree (numpy leaves, with or
    without the top-level ``params`` key) into the port's grouped layout.
    Returns the state_dict of ``MAVAE.from_config(cfg, spec)`` with
    ``fused_decoders=False`` and matching widths."""
    p = _unwrap(ref_tree)
    out: Dict[str, Any] = {
        "idx_emb": {"embedding": np.asarray(p["idx_emb"]["embedding"])},
        "reward_linear": _dense(p["reward_linear"]),
    }
    for dec in ("state_decoder", "reward_decoder"):
        out[dec] = _map_mlp(p[dec])
    for g, (_, idxs) in enumerate(spec.groups):
        names = [spec.agents[i] for i in idxs]
        out[f"encoders_{g}"] = _stacked_mlp([p[f"encoders_{a}"] for a in names])
        acts = [p[f"action_encoders_{a}"] for a in names]
        if "embedding" in acts[0]:  # discrete actions (the reference's Embedding)
            out[f"action_encoders_{g}"] = {"embedding": np.stack([np.asarray(t["embedding"]) for t in acts])}
        else:  # the continuous ActionEncoder MLP
            out[f"action_encoders_{g}"] = _stacked_mlp(acts)
    return params_from_jax(out)


def load_reference_pickle(path: str, spec: AgentSpec) -> Dict[str, torch.Tensor]:
    """Load the reference's ``model_state.pkl`` of numpy leaves (see the
    module docstring) and restack it."""
    return import_reference_params(load_numpy_pickle(path), spec)


# ------------------------------------------------------------------ export
def _unstack_mlp_to_ref(module_tree: Dict[str, Any], row: Optional[int], hidden_names_fc: bool) -> Dict[str, Any]:
    """{fc0..fcN, out} -> the reference's flax naming; ``row`` slices the
    leading stack axis (None: unstacked).  The reference Encoder names its
    hiddens fc{i} and leaves only its output unnamed (Dense_0); the
    Decoder and ActionEncoder leave every layer unnamed (Dense_0..N)."""
    fcs = sorted((k for k in module_tree if k.startswith("fc")), key=lambda s: int(s[2:]))

    def take(leaf):
        return {k: np.asarray(v if row is None else v[row]) for k, v in leaf.items()}

    out = {(f"fc{i}" if hidden_names_fc else f"Dense_{i}"): take(module_tree[name]) for i, name in enumerate(fcs)}
    out["Dense_0" if hidden_names_fc else f"Dense_{len(fcs)}"] = take(module_tree["out"])
    return out


def export_reference_params(model: Union[nn.Module, Dict[str, torch.Tensor]], spec: AgentSpec) -> Dict[str, Any]:
    """The port's MAVAE (a module or its state_dict) -> the reference's
    per-agent tree of numpy arrays, the structure
    ``pickle.dump(train_state.params)`` writes: the inverse of
    ``import_reference_params``.  Both decoder layouts: the fused trunk is
    unstacked (stack 0 = state, 1 = reward) and each output head closes its
    decoder.  ``det_features`` and ``latent_structure='shared_private'``
    widen the encoder output beyond 2·obs_features, which the reference
    tree cannot hold: ``ValueError``."""
    sd = model.state_dict() if isinstance(model, nn.Module) else model
    p = params_to_jax(sd)
    out: Dict[str, Any] = {
        "idx_emb": {"embedding": np.asarray(p["idx_emb"]["embedding"])},
        "reward_linear": _dense(p["reward_linear"]),
    }
    if "state_decoder" in p:
        for dec in ("state_decoder", "reward_decoder"):
            out[dec] = _unstack_mlp_to_ref(p[dec], None, hidden_names_fc=False)
    else:  # the fused trunk: [2, in, out] kernels; the heads close each decoder
        for row, (dec, head) in enumerate((("state_decoder", "state_head"), ("reward_decoder", "reward_head"))):
            tree = _unstack_mlp_to_ref(p["decoder_trunk"], row, hidden_names_fc=False)
            tree[f"Dense_{len(tree)}"] = _dense(p[head])
            out[dec] = tree
    for g, (_, idxs) in enumerate(spec.groups):
        names = [spec.agents[i] for i in idxs]
        enc, ae = p[f"encoders_{g}"], p[f"action_encoders_{g}"]
        for pos, a in enumerate(names):
            out[f"encoders_{a}"] = _unstack_mlp_to_ref(enc, pos, hidden_names_fc=True)
            if "embedding" in ae:  # discrete: a stacked embedding [A_g, n_act, F]
                out[f"action_encoders_{a}"] = {"embedding": np.asarray(ae["embedding"][pos])}
            else:
                out[f"action_encoders_{a}"] = _unstack_mlp_to_ref(ae, pos, hidden_names_fc=False)

    # the encoder output must be exactly 2·obs_features, with obs_features
    # read off the decoder input width n·(obs_f + act_f)
    enc_out = out[f"encoders_{spec.agents[0]}"]["Dense_0"]["kernel"].shape[1]
    act = out[f"action_encoders_{spec.agents[0]}"]
    act_f = act["embedding"].shape[-1] if "embedding" in act else act[sorted(act)[-1]]["kernel"].shape[1]
    obs_f = out["state_decoder"]["Dense_0"]["kernel"].shape[0] // spec.n_agents - act_f
    if enc_out != 2 * obs_f:
        raise ValueError(
            "model is not reference-representable: encoder output width "
            f"{enc_out} != 2*obs_features ({2 * obs_f}) — det_features / "
            "shared_private latents have no reference counterpart"
        )
    return out


def save_reference_pickle(model: Union[nn.Module, Dict[str, torch.Tensor]], spec: AgentSpec, path: str) -> None:
    """Write ``model_state.pkl`` as the reference does (the bare params
    dict, no ``params`` wrapper), with numpy leaves."""
    tree = export_reference_params(model, spec)
    with open(path, "wb") as f:
        pickle.dump(tree, f)


# --------------------------------------------------------------- torch side
def _torch_sequential_mlp(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    """torch_ver's Encoder/Decoder are nn.Sequential(Linear, ReLU, ...): the
    Linears sit at even indices (``{prefix}.net.0.weight`` ...), [out, in]
    where flax kernels are [in, out]."""
    idxs = sorted({int(k.split(".")[-2]) for k in sd if k.startswith(f"{prefix}.net.") and k.endswith(".weight")})
    out = {}
    for i, li in enumerate(idxs):
        ours = "out" if i == len(idxs) - 1 else f"fc{i}"
        out[ours] = {"kernel": sd[f"{prefix}.net.{li}.weight"].T, "bias": sd[f"{prefix}.net.{li}.bias"]}
    return out


def import_torch_state_dict(state_dict: Dict[str, Any], model: nn.Module) -> Tuple[Dict[str, torch.Tensor], list]:
    """Import the torch reference's saved ``state_dict`` on top of
    ``model``'s own parameters (the model is left as it is).

    The saved file lacks the per-agent encoders and action encoders (the
    reference keeps them in plain dicts, invisible to ``state_dict()``).
    What the target can hold transfers: the idx embedding, both joint
    decoders and the PopArt ``reward_linear`` head.  The reference's unused
    joint ``decoder`` has no counterpart and is reported.

    Returns (state_dict, missing): ``model``'s state_dict with the
    transferred modules replaced, and the target modules left at their
    values (the encoders) plus ``unmapped:<prefix>`` for saved modules with
    no target."""
    sd = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
          for k, v in state_dict.items()}
    params = params_to_jax(model.state_dict())
    if "idx_emb.weight" in sd:
        params["idx_emb"] = {"embedding": sd["idx_emb.weight"]}
    for dec in ("state_decoder", "reward_decoder"):
        if any(k.startswith(f"{dec}.net.") for k in sd):
            params[dec] = _torch_sequential_mlp(sd, dec)
    if "reward_linear.weight" in sd:
        params["reward_linear"] = {"kernel": sd["reward_linear.weight"].T, "bias": sd["reward_linear.bias"]}
    missing = sorted(k for k in params if k.startswith(("encoders_", "action_encoders_")))
    mapped = ("idx_emb", "state_decoder", "reward_decoder", "reward_linear")
    missing += [f"unmapped:{m}" for m in sorted({k.split(".")[0] for k in sd} - set(mapped))]
    return params_from_jax(params), missing


def load_torch_checkpoint(path: str, model: nn.Module) -> Tuple[Dict[str, torch.Tensor], list]:
    """Load the torch reference's ``test.pt`` (``torch_ver/main.py:111-112``;
    tensors only, ``weights_only``) and import it.  Returns (state_dict,
    missing)."""
    return import_torch_state_dict(torch.load(path, map_location="cpu", weights_only=True), model)
