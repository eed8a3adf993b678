"""The MF-VAE world model in plain PyTorch, in float32.

The multi-agent factorized VAE of anetnna/MF-VAE (``jax_ver/model.py``):
each agent is encoded from (its index embedding ‖ its observation) by the
MLP of its group (agents with one observation and action width share a
stacked set of per-agent weights), giving a Gaussian posterior (mu,
logvar) over ``obs_features`` latent dims, and, with ``det_features``, a
deterministic feature; each agent's discrete action is embedded per agent.
The decoder reads every agent's latent sample and action embedding (and
the deterministic features and, under ``state_skip``, the current global
state) and predicts the next global state [Σobs] and the per-agent reward
[A]: one two-stack trunk whose stacks feed a state head and a reward head
(``fused_decoders``), or two MLPs, each with a LayerNorm before every
dense layer under ``decoder_layernorm``.  The reward passes a final
[A, A] linear layer; under ``residual_state`` the state output is a delta
on the current state.

Parameters are a flat dict of float32 tensors; ``param_shapes`` gives
their names (the layout of the program's ``state_dict``, which is how the
benchmark hands one set of weights to both) and shapes.  Every product is
``Precision.mm``: float32 with TF32 off, or the control's fp8.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

FP8_MAX = 448.0  # the largest float8_e4m3fn


class Precision:
    """float32 products (TF32 must be off; ``benchmark.common`` turns it
    off), or with ``fp8`` each product's operands rounded to
    float8_e4m3fn under one scale a tensor (its amax to 448), the forward
    value of an fp8 product; the backward passes the rounding straight
    through."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return t
        scale = FP8_MAX / torch.clamp(t.detach().abs().amax(), min=1e-30)
        r = (t.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
        return t + (r - t).detach()

    def dense(self, x, kernel, bias):
        """x [..., in] @ kernel [in, out] + bias."""
        return self.q(x) @ self.q(kernel) + bias

    def stacked(self, x, kernel, bias):
        """x [B, S, in] with kernel [S, in, out], bias [S, out]."""
        return torch.einsum("bsi,sio->bso", self.q(x), self.q(kernel)) + bias


class Spec:
    """Agent groups of equal (obs, action) width, in first-seen order."""

    def __init__(self, obs_dims: Sequence[int], act_dims: Sequence[int]):
        self.obs_dims = tuple(obs_dims)
        self.act_dims = tuple(act_dims)
        self.n = len(obs_dims)
        members: Dict[Tuple[int, int], List[int]] = {}
        for i, key in enumerate(zip(obs_dims, act_dims)):
            members.setdefault(key, []).append(i)
        self.groups = [(key, tuple(idx)) for key, idx in members.items()]
        if [i for _, idx in self.groups for i in idx] != list(range(self.n)):
            raise ValueError("the reference takes agents already in group order")
        self.sum_obs = sum(obs_dims)


def _mlp_shapes(prefix: str, widths: Sequence[int], out: int, stack: int = 0, layernorm: bool = False):
    lead = (stack,) if stack else ()
    shapes = OrderedDict()
    for i in range(len(widths) - 1):
        if layernorm:
            shapes[f"{prefix}.ln{i}.scale"] = (widths[i],)
            shapes[f"{prefix}.ln{i}.bias"] = (widths[i],)
        shapes[f"{prefix}.fc{i}.kernel"] = lead + (widths[i], widths[i + 1])
        shapes[f"{prefix}.fc{i}.bias"] = lead + (widths[i + 1],)
    if layernorm:
        shapes[f"{prefix}.ln_out.scale"] = (widths[-1],)
        shapes[f"{prefix}.ln_out.bias"] = (widths[-1],)
    shapes[f"{prefix}.out.kernel"] = lead + (widths[-1], out)
    shapes[f"{prefix}.out.bias"] = lead + (out,)
    return shapes


def decoder_input(m: dict, spec: Spec) -> int:
    width = spec.n * (m["obs_features"] + m["action_features"] + m["det_features"])
    return width + (spec.sum_obs if m["state_skip"] else 0)


def param_shapes(m: dict, spec: Spec) -> "OrderedDict[str, tuple]":
    """name -> shape of every parameter, for the model section ``m`` of a
    configuration (the keys of the program's ``ModelConfig``)."""
    f, af, det = m["obs_features"], m["action_features"], m["det_features"]
    shapes = OrderedDict({"idx_emb.embedding": (spec.n, m["idx_features"])})
    for g, ((od, ad), idx) in enumerate(spec.groups):
        widths = [m["idx_features"] + od, *m["encoder_hidden"]]
        shapes.update(_mlp_shapes(f"encoders.{g}", widths, 2 * f + det, stack=len(idx)))
    for g, ((od, ad), idx) in enumerate(spec.groups):
        shapes[f"action_encoders.{g}.embedding"] = (len(idx), ad, af)
    hidden = list(m["decoder_hidden"])
    d_in = decoder_input(m, spec)
    ln = m["decoder_layernorm"]
    if m["fused_decoders"]:
        shapes.update(_mlp_shapes("decoder_trunk", [d_in, *hidden[:-1]], hidden[-1], stack=2, layernorm=ln))
        shapes["state_head.kernel"] = (hidden[-1], spec.sum_obs)
        shapes["state_head.bias"] = (spec.sum_obs,)
        shapes["reward_head.kernel"] = (hidden[-1], spec.n)
        shapes["reward_head.bias"] = (spec.n,)
    else:
        shapes.update(_mlp_shapes("state_decoder", [d_in, *hidden], spec.sum_obs, layernorm=ln))
        shapes.update(_mlp_shapes("reward_decoder", [d_in, *hidden], spec.n, layernorm=ln))
    shapes["reward_linear.kernel"] = (spec.n, spec.n)
    shapes["reward_linear.bias"] = (spec.n,)
    return shapes


def check_supported(m: dict) -> None:
    """The options this reference implements; any other raises."""
    fixed = {"discrete_act": True, "latent_structure": "private", "reward_head_mode": "linear",
             "reward_head_input": "latent", "action_delta_head": False, "rng_mode": "vectorized"}
    for key, want in fixed.items():
        if m.get(key, want) != want:
            raise NotImplementedError(f"the reference has no model.{key}={m[key]!r}")


def layernorm(x, scale, bias, eps: float = 1e-6):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def _mlp(p, prefix, x, n_hidden, pr: Precision, stacked: bool, ln: bool):
    layer = pr.stacked if stacked else pr.dense
    for i in range(n_hidden):
        if ln:
            x = layernorm(x, p[f"{prefix}.ln{i}.scale"], p[f"{prefix}.ln{i}.bias"])
        x = torch.relu(layer(x, p[f"{prefix}.fc{i}.kernel"], p[f"{prefix}.fc{i}.bias"]))
    if ln:
        x = layernorm(x, p[f"{prefix}.ln_out.scale"], p[f"{prefix}.ln_out.bias"])
    return layer(x, p[f"{prefix}.out.kernel"], p[f"{prefix}.out.bias"])


def encode(p, m: dict, spec: Spec, obs: Sequence[torch.Tensor], actions: Sequence[torch.Tensor],
           pr: Precision):
    """Per group obs [B, A_g, od] and actions [B, A_g] -> (mu, logvar,
    action embedding [B, A, F], det [B, A, D] or None), agents in order."""
    f = m["obs_features"]
    mus, lvs, aembs, dets = [], [], [], []
    for g, (_, idx) in enumerate(spec.groups):
        b = obs[g].shape[0]
        emb = p["idx_emb.embedding"][list(idx)]
        x = torch.cat([emb[None].expand(b, -1, -1), obs[g]], dim=-1)
        latent = _mlp(p, f"encoders.{g}", x, len(m["encoder_hidden"]), pr, stacked=True, ln=False)
        mus.append(latent[..., :f])
        lvs.append(latent[..., f:2 * f])
        dets.append(latent[..., 2 * f:])
        table = p[f"action_encoders.{g}.embedding"]
        aembs.append(table[torch.arange(len(idx), device=table.device)[None, :], actions[g].long()])
    det = torch.cat(dets, dim=1) if m["det_features"] else None
    return torch.cat(mus, dim=1), torch.cat(lvs, dim=1), torch.cat(aembs, dim=1), det


def decode(p, m: dict, spec: Spec, z, aemb, det, base: Optional[torch.Tensor], pr: Precision):
    """-> (next state [B, Σobs], rewards [B, A])."""
    b = z.shape[0]
    parts = [z.reshape(b, -1), aemb.reshape(b, -1)]
    if det is not None:
        parts.append(det.reshape(b, -1))
    if m["state_skip"]:
        parts.append(base)
    flat = torch.cat(parts, dim=-1)
    hidden = list(m["decoder_hidden"])
    ln = m["decoder_layernorm"]
    if m["fused_decoders"]:
        h = torch.relu(_mlp(p, "decoder_trunk", flat[:, None, :].expand(b, 2, flat.shape[-1]),
                            len(hidden) - 1, pr, stacked=True, ln=ln))
        state = pr.dense(h[:, 0], p["state_head.kernel"], p["state_head.bias"])
        reward = pr.dense(h[:, 1], p["reward_head.kernel"], p["reward_head.bias"])
    else:
        state = _mlp(p, "state_decoder", flat, len(hidden), pr, stacked=False, ln=ln)
        reward = _mlp(p, "reward_decoder", flat, len(hidden), pr, stacked=False, ln=ln)
    reward = pr.dense(reward, p["reward_linear.kernel"], p["reward_linear.bias"])
    if m["residual_state"]:
        state = state + base
    return state, reward


def global_state(obs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per group [B, A_g, od] -> [B, Σobs], agents in order."""
    b = obs[0].shape[0]
    return torch.cat([o.reshape(b, -1) for o in obs], dim=-1)


def split_state(spec: Spec, state: torch.Tensor) -> List[torch.Tensor]:
    """[B, Σobs] -> per group [B, A_g, od]."""
    out, lo = [], 0
    for (od, _), idx in spec.groups:
        hi = lo + od * len(idx)
        out.append(state[:, lo:hi].reshape(state.shape[0], len(idx), od))
        lo = hi
    return out


def _base(m, obs):
    return global_state(obs) if (m["residual_state"] or m["state_skip"]) else None


def forward(p, m: dict, spec: Spec, obs, actions, eps: torch.Tensor, pr: Precision):
    """The training forward with ``z = mu + eps * exp(logvar / 2)``:
    (next state, rewards, mu, logvar)."""
    mu, logvar, aemb, det = encode(p, m, spec, obs, actions, pr)
    z = mu + eps * torch.exp(0.5 * logvar)
    state, reward = decode(p, m, spec, z, aemb, det, _base(m, obs), pr)
    return state, reward, mu, logvar


def mean_forward(p, m: dict, spec: Spec, obs, actions, pr: Precision):
    """The serving forward, ``z = mu``: (next state, rewards)."""
    mu, _, aemb, det = encode(p, m, spec, obs, actions, pr)
    return decode(p, m, spec, mu, aemb, det, _base(m, obs), pr)


def huber(x, y, delta: float):
    d = torch.abs(x - y)
    q = torch.clamp(d, max=delta)
    return torch.mean(0.5 * q * q + delta * (d - q))


def elbo(state, reward, next_state, rewards, mu, logvar, loss_cfg: dict):
    """The jax-family ELBO: ``s_weight·s·(1 - rw) + r·rw + kl·kw``, huber
    reconstruction terms and the KL to N(0, I) summed over latent dims and
    averaged over rows.  -> (loss, s, r, kl)."""
    if loss_cfg.get("family", "jax") != "jax" or not loss_cfg.get("use_huber", True):
        raise NotImplementedError("the reference implements the jax family's huber ELBO")
    for key in ("kl_anneal_steps", "free_bits", "contact_weight", "prey_dist_weight"):
        if loss_cfg.get(key):
            raise NotImplementedError(f"the reference has no loss.{key}")
    kw = 0.1 if loss_cfg.get("kl_weight") is None else loss_cfg["kl_weight"]
    rw = 0.5 if loss_cfg.get("r_weight") is None else loss_cfg["r_weight"]
    delta = loss_cfg.get("huber_delta", 1.0)
    s = huber(state, next_state, delta)
    r = huber(reward, rewards, delta)
    kl = torch.mean(torch.sum((-0.5 * (1.0 + logvar - mu * mu - torch.exp(logvar))).reshape(mu.shape[0], -1), dim=1))
    loss = loss_cfg.get("s_weight", 1.0) * s * (1.0 - rw) + r * rw + kl * kw
    return loss, s, r, kl
