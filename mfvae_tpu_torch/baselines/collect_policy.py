"""Learned-policy collection: a trained Q-learning agent drives the world
model's replay collection (mirror of ``mfvae_tpu/baselines/collect_policy.py``).

The greedy policy of a trained VDN/IQL agent (``baselines/vdn.py``
``VdnNetwork``) becomes ``train.collect_policy: "vdn:<path.npz>"`` of the
world-model experiment, so the model learns from the states an actual
policy visits: ``QCollectPolicy`` on the device path,
``HostQCollectPolicy`` in the host backend's collectors.

The policy file is the JAX package's ``.npz``, written and read with numpy
alone: every parameter under its ``/``-joined flax path
(``params/AgentRNN_0/Dense_0/kernel``, ...) plus ``__meta__``, the JSON
bytes of hidden_dim, param_share, action_dim and n_agents.  A file either
package wrote serves in both.

``QCollectPolicy`` follows the trainer's stateful protocol
(``envs/policies.py``): ``init_carry(leading)`` -> (hidden [*leading, N,
H],) and ``step(carry, stacked_obs, env_state, generator, noise=None)`` ->
(carry, actions [*leading, N]); the trainer resets the carry at episode
end, the hidden-state reset the agent trained with.
"""

from __future__ import annotations

import json
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mfvae_tpu_torch.baselines.vdn import VdnNetwork, pack_grouped
from mfvae_tpu_torch.models.convert import flatten_flax, qnet_params_from_jax, qnet_params_to_jax, unflatten_flax
from mfvae_tpu_torch.models.mavae import AgentSpec
from mfvae_tpu_torch.training.trainer import stacked_to_grouped


def save_policy(path: str, params, *, hidden_dim: int, param_share: bool, action_dim: int, n_agents: int) -> None:
    """One self-contained .npz: the flattened params (a ``VdnNetwork``, its
    state_dict, or the JAX tree) plus the meta record."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    if any(k.startswith("agent.") for k in params):
        params = qnet_params_to_jax(params)
    meta = json.dumps({
        "hidden_dim": int(hidden_dim),
        "param_share": bool(param_share),
        "action_dim": int(action_dim),
        "n_agents": int(n_agents),
    })
    np.savez(path, __meta__=np.frombuffer(meta.encode("utf-8"), np.uint8), **flatten_flax(params))


def load_policy(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Inverse of save_policy -> (the params as the JAX tree of numpy
    arrays, meta dict)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        flat = {k: np.asarray(z[k]) for k in z.files if k != "__meta__"}
    return unflatten_flax(flat), meta


class QNoise(NamedTuple):
    """The draws of one ``QCollectPolicy`` step over leading axes L."""

    rand: torch.Tensor  # [*L, N] the sampler's uniform actions
    mix: torch.Tensor  # [*L, N] uniforms: < epsilon -> the uniform action


class QCollectPolicy:
    """Greedy (epsilon-mixed) actions of a trained ``VdnNetwork`` inside
    the experiment's collection loop, over any leading env axes.  The
    packing is ``vdn.pack_grouped`` over the env's class tensors (the
    spec's groups), with no host work."""

    def __init__(self, env, spec: AgentSpec, params, meta: Dict[str, Any], epsilon: float, sample_fn):
        if not getattr(env, "discrete_actions", True):
            raise ValueError(
                "learned Q-policy collection needs discrete actions "
                "(VdnNetwork outputs per-action Q-values)"
            )
        if meta["n_agents"] != spec.n_agents:
            raise ValueError(
                f"policy was trained for {meta['n_agents']} agents but the "
                f"experiment population has {spec.n_agents}"
            )
        self.spec = spec
        self.epsilon = float(epsilon)
        self.sample_fn = sample_fn
        self.hidden_dim = int(meta["hidden_dim"])
        self.device = env.device
        self._d_pad = max(od for (od, _), _ in spec.groups)
        self.network = VdnNetwork(
            int(meta["action_dim"]), spec.n_agents, self.hidden_dim, bool(meta["param_share"]),
            in_dim=self._d_pad + spec.n_agents,
        )
        self.network.load_state_dict(qnet_params_from_jax(params))
        self.network.to(self.device).requires_grad_(False)
        self._eye = torch.eye(spec.n_agents, device=self.device)

    def init_carry(self, leading=()):
        return (torch.zeros(tuple(leading) + (self.spec.n_agents, self.hidden_dim), device=self.device),)

    def _pack(self, stacked_obs) -> torch.Tensor:
        """The class tensors ([*L, A_g, od] per group) -> [*L, N, d_pad + N]."""
        return pack_grouped(self.spec, stacked_to_grouped(self.spec, stacked_obs), self._eye)

    def draw_noise(self, generator: Optional[torch.Generator], lead=()) -> QNoise:
        rand = self.sample_fn(generator, lead)
        return QNoise(rand, torch.rand(tuple(lead) + (self.spec.n_agents,), generator=generator, device=self.device))

    @torch.no_grad()
    def step(self, carry, stacked_obs, env_state, generator, noise: Optional[QNoise] = None):
        del env_state  # learned policies act on observations
        (hidden,) = carry
        lead = tuple(hidden.shape[:-2])
        obs = self._pack(stacked_obs).reshape(-1, self.spec.n_agents, self._d_pad + self.spec.n_agents)
        m = obs.shape[0]
        h, q = self.network(hidden.reshape(m, self.spec.n_agents, self.hidden_dim), obs[None],
                            torch.zeros((1, m), dtype=torch.bool, device=self.device))
        greedy = torch.argmax(q[0], dim=-1).to(torch.int32).reshape(lead + (self.spec.n_agents,))
        if noise is None:
            noise = self.draw_noise(generator, lead)
        actions = torch.where(noise.mix < self.epsilon, noise.rand, greedy)
        return (h.reshape(hidden.shape),), actions


def load_collect_policy(path: str, env, spec: AgentSpec, epsilon: float, sample_fn) -> QCollectPolicy:
    """Config-surface loader for ``train.collect_policy: "vdn:<path>"``."""
    params, meta = load_policy(path)
    return QCollectPolicy(env, spec, params, meta, epsilon, sample_fn)


class HostQCollectPolicy:
    """Greedy (epsilon-mixed) actions of a saved policy for the host
    collectors (``envs/host_adapter.py`` ``AsyncCollector`` and
    ``NativeBatchedCollector``), which step numpy envs on the CPU.

    The port's ``VdnNetwork`` runs on the CPU under ``torch.no_grad``, one
    forward per collected step, batched over the K host envs; the obs are
    packed from the collectors' named-obs dicts in numpy, and the epsilon
    mixture draws from the collector's numpy generator, as the JAX
    package's does.  An episode reset zeroes the hidden rows of the envs
    that ended (the done-masking the agent trained with)."""

    def __init__(self, path: str, agents, obs_dims: Dict[str, int], epsilon: float,
                 rng: np.random.Generator, n_envs: int = 1):
        params, meta = load_policy(path)
        self.agents = list(agents)
        n = len(self.agents)
        if meta["n_agents"] != n:
            raise ValueError(f"policy was trained for {meta['n_agents']} agents but the host env has {n}")
        self.epsilon = float(epsilon)
        self.rng = rng
        self.n_envs = int(n_envs)
        self.action_dim = int(meta["action_dim"])
        self.hidden_dim = int(meta["hidden_dim"])
        self._d_pad = max(int(obs_dims[a]) for a in self.agents)
        self.network = VdnNetwork(self.action_dim, n, self.hidden_dim, bool(meta["param_share"]),
                                  in_dim=self._d_pad + n)
        self.network.load_state_dict(qnet_params_from_jax(params))
        self.network.requires_grad_(False)
        self._no_done = torch.zeros((1, self.n_envs), dtype=torch.bool)
        self.reset()

    def reset(self, done_mask: Optional[np.ndarray] = None) -> None:
        """Zero the hidden state, everywhere or only where done."""
        if done_mask is None:
            self._h = torch.zeros((self.n_envs, len(self.agents), self.hidden_dim))
        else:
            self._h[torch.from_numpy(np.asarray(done_mask, bool))] = 0.0

    def _pack(self, obs: Dict[str, np.ndarray]) -> np.ndarray:
        """named obs (each [od] or [K, od]) -> [K, N, d_pad + N]."""
        b, n = self.n_envs, len(self.agents)
        out = np.zeros((b, n, self._d_pad + n), np.float32)
        for i, a in enumerate(self.agents):
            v = np.asarray(obs[a], np.float32).reshape(b, -1)
            out[:, i, : v.shape[1]] = v
            out[:, i, self._d_pad + i] = 1.0
        return out

    @torch.no_grad()
    def actions(self, obs: Dict[str, np.ndarray]) -> np.ndarray:
        """Greedy eps-mixed actions [K, N] int32 from the named obs."""
        packed = torch.from_numpy(self._pack(obs))
        self._h, q = self.network(self._h, packed[None], self._no_done)
        acts = torch.argmax(q[0], dim=-1).to(torch.int32).numpy()
        take = self.rng.random(acts.shape) < self.epsilon
        rand = self.rng.integers(0, self.action_dim, size=acts.shape)
        return np.where(take, rand, acts).astype(np.int32)
