"""MAVAE — the multi-agent factorized VAE world model, in PyTorch.

A port of ``mfvae_tpu/models/mavae.py`` on its reference structure
(private latents): per-agent Gaussian encoders over (agent-index embedding
‖ observation), stacked per agent group; per-agent action embeddings; a
joint decoder of the next global state and the per-agent reward, as one
fused two-stack trunk (``fused_decoders``, the default) or as two MLPs.

Noise: the JAX model draws eps from a key inside the call.  Here every
sampling call takes an optional explicit ``eps`` [B, A, F] in *grouped*
agent order — the shape ``_eps`` draws — or draws it from a
``torch.Generator``.  Both train-step routes call ``_eps`` the same way,
so from one generator state they see the same noise.

Options the port has not implemented raise ``NotImplementedError`` at
construction, naming their ROADMAP item.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from mfvae_tpu_torch.config import ModelConfig
from mfvae_tpu_torch.models.layers import (
    Dense,
    Embedding,
    MLP,
    StackedEmbedding,
    StackedMLP,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclass(frozen=True)
class AgentSpec:
    """Static description of the agent population.  ``groups`` partitions
    agents by (obs_dim, act_dim), in first-seen order; each group becomes
    one stacked-parameter module."""

    agents: Tuple[str, ...]
    obs_dims: Tuple[int, ...]
    act_dims: Tuple[int, ...]

    @classmethod
    def from_dicts(
        cls, agents: Sequence[str], obs_dim: Dict[str, int], act_dim: Dict[str, int]
    ) -> "AgentSpec":
        agents = tuple(agents)
        return cls(
            agents=agents,
            obs_dims=tuple(int(obs_dim[a]) for a in agents),
            act_dims=tuple(int(act_dim[a]) for a in agents),
        )

    @property
    def n_agents(self) -> int:
        return len(self.agents)

    @cached_property
    def groups(self) -> Tuple[Tuple[Tuple[int, int], Tuple[int, ...]], ...]:
        """((obs_dim, act_dim), member agent indices) per group."""
        order: List[Tuple[int, int]] = []
        members: Dict[Tuple[int, int], List[int]] = {}
        for i, key in enumerate(zip(self.obs_dims, self.act_dims)):
            if key not in members:
                members[key] = []
                order.append(key)
            members[key].append(i)
        return tuple((k, tuple(members[k])) for k in order)

    @cached_property
    def perm_from_grouped(self) -> Tuple[int, ...]:
        """perm[i] = position of original agent i in the grouped concat."""
        grouped_order = [i for _, idxs in self.groups for i in idxs]
        inv = [0] * len(grouped_order)
        for pos, orig in enumerate(grouped_order):
            inv[orig] = pos
        return tuple(inv)

    @property
    def grouped_is_identity(self) -> bool:
        return self.perm_from_grouped == tuple(range(self.n_agents))


def zero_actions_grouped(spec: AgentSpec, batch_size: Optional[int], device=None):
    """Per-group zero discrete actions int32 [B, A_g] ([A_g] when
    ``batch_size`` is None)."""
    lead = () if batch_size is None else (batch_size,)
    return tuple(
        torch.zeros(lead + (len(idxs),), dtype=torch.int32, device=device)
        for _, idxs in spec.groups
    )


class GroupedBatch(NamedTuple):
    """Model input, one entry per AgentSpec group (in group order).

    obs[g]:     [B, A_g, obs_dim_g] float
    actions[g]: [B, A_g] int
    """

    obs: Tuple[torch.Tensor, ...]
    actions: Tuple[torch.Tensor, ...]


def agent_order_concat(spec: AgentSpec, grouped: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-group [B, A_g, D_g] -> the agent-order flat global state
    [B, Σ obs_dims], the decoder's state target layout."""
    b = grouped[0].shape[0]
    if spec.grouped_is_identity:
        return torch.cat([g.reshape(b, -1) for g in grouped], dim=-1)
    group_of_agent = {}
    for g, (_, idxs) in enumerate(spec.groups):
        for pos, agent_idx in enumerate(idxs):
            group_of_agent[agent_idx] = (g, pos)
    parts = []
    for i in range(spec.n_agents):
        g, pos = group_of_agent[i]
        parts.append(grouped[g][:, pos, :])
    return torch.cat(parts, dim=-1)


def state_to_grouped(spec: AgentSpec, state: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """[B, Σobs] agent-order global state -> per-group obs [B, A_g, od];
    the inverse of agent_order_concat."""
    offsets = [0]
    for d in spec.obs_dims:
        offsets.append(offsets[-1] + d)
    return tuple(
        torch.stack([state[:, offsets[i] : offsets[i] + od] for i in idxs], dim=1)
        for (od, _), idxs in spec.groups
    )


def _refuse_unported(cfg: ModelConfig) -> None:
    off_path = {
        "det_features": (cfg.det_features != 0, "M10"),
        "latent_structure=shared_private": (cfg.latent_structure != "private", "M10"),
        "residual_state": (cfg.residual_state, "M10"),
        "state_skip": (cfg.state_skip, "M10"),
        "decoder_layernorm": (cfg.decoder_layernorm, "M10"),
        "reward_head_mode=twohot": (cfg.reward_head_mode != "linear", "M10"),
        "reward_head_input=pred_state": (cfg.reward_head_input != "latent", "M10"),
        "action_delta_head": (cfg.action_delta_head, "M10"),
        "discrete_act=false (continuous actions)": (not cfg.discrete_act, "M10"),
        "rng_mode=reference": (cfg.rng_mode != "vectorized", "M20"),
        "remat": (cfg.remat, "M20"),
    }
    for name, (on, item) in off_path.items():
        if on:
            raise NotImplementedError(
                f"model.{name} is not ported to the PyTorch package yet (ROADMAP {item})"
            )


class MAVAE(nn.Module):
    """Reference-structure MAVAE.  Public calls return float32 outputs:
    ``forward`` -> (recon_state [B, Σobs], recon_reward [B, A],
    mu_all [B, A·F], logvar_all [B, A·F]) in agent order."""

    def __init__(self, spec: AgentSpec, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _refuse_unported(cfg)
        if cfg.reward_head_init not in ("lecun", "popart"):
            raise ValueError(f"unknown reward_head_init {cfg.reward_head_init!r}")
        self.spec = spec
        self.obs_features = f = cfg.obs_features
        self.fused_decoders = cfg.fused_decoders
        self.dtype = dtype = DTYPES[cfg.compute_dtype]
        n = spec.n_agents
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.idx_emb = Embedding(n, cfg.idx_features, **kw)
        self.encoders = nn.ModuleList()
        self.action_encoders = nn.ModuleList()
        for (obs_dim, act_dim), idxs in spec.groups:
            self.encoders.append(
                StackedMLP(len(idxs), cfg.idx_features + obs_dim, cfg.encoder_hidden, 2 * f, **kw)
            )
            self.action_encoders.append(
                StackedEmbedding(len(idxs), act_dim, cfg.action_features, **kw)
            )
        dec_in = n * (f + cfg.action_features)
        hidden = tuple(cfg.decoder_hidden)
        if self.fused_decoders:
            # state + reward decoders share hidden widths: one two-stack trunk
            self.decoder_trunk = StackedMLP(2, dec_in, hidden[:-1], hidden[-1], **kw)
            self.state_head = Dense(hidden[-1], sum(spec.obs_dims), **kw)
            self.reward_head = Dense(hidden[-1], n, **kw)
        else:
            self.state_decoder = MLP(dec_in, hidden, sum(spec.obs_dims), **kw)
            self.reward_decoder = MLP(dec_in, hidden, n, **kw)
        # PopArt output head: all-ones kernel under 'popart', lecun otherwise
        self.reward_linear = Dense(
            n, n, kernel_init="ones" if cfg.reward_head_init == "popart" else "lecun", **kw
        )
        self.register_buffer(
            "_perm", torch.tensor(spec.perm_from_grouped, device=device), persistent=False
        )

    @classmethod
    def from_config(cls, cfg: ModelConfig, spec: AgentSpec, device=None,
                    generator: Optional[torch.Generator] = None) -> "MAVAE":
        return cls(spec, cfg, device=device, generator=generator)

    # ---------------------------------------------------------------- encode
    def encode(self, batch: GroupedBatch, agent_ids=None):
        """(mu, logvar, action_emb), each [B, A, ·] in *grouped* agent order."""
        f = self.obs_features
        mus, logvars, aembs = [], [], []
        for g, (_, idxs) in enumerate(self.spec.groups):
            obs = batch.obs[g]
            if agent_ids is None:
                ids = torch.tensor(idxs, device=obs.device)[None, :].expand(obs.shape[0], -1)
            else:
                ids = agent_ids[g]
            enc_in = torch.cat([self.idx_emb(ids), obs.to(self.dtype)], dim=-1)
            latent = self.encoders[g](enc_in)  # [B, A_g, 2F]
            mus.append(latent[..., :f])
            logvars.append(latent[..., f : 2 * f])
            aembs.append(self.action_encoders[g](batch.actions[g]))
        return torch.cat(mus, dim=1), torch.cat(logvars, dim=1), torch.cat(aembs, dim=1)

    # ---------------------------------------------------------- reparam/eps
    def _eps(self, generator: Optional[torch.Generator], shape, eps=None) -> torch.Tensor:
        """The noise for ``shape`` = [B, A, F]: ``eps`` itself when given,
        else one standard-normal draw from ``generator``."""
        if eps is not None:
            if tuple(eps.shape) != tuple(shape):
                raise ValueError(f"eps has shape {tuple(eps.shape)}, expected {tuple(shape)}")
            return eps.to(torch.float32)
        if generator is None:
            raise ValueError("a sampling call needs a generator or an explicit eps")
        return torch.randn(tuple(shape), generator=generator, device=generator.device)

    @staticmethod
    def reparameterize(mu, logvar, eps):
        """z = mu + eps * exp(0.5*logvar), in float32."""
        std = torch.exp(0.5 * logvar.to(torch.float32))
        return mu.to(torch.float32) + eps * std

    def _to_agent_order(self, *xs):
        if self.spec.grouped_is_identity:
            return xs
        return tuple(x.index_select(1, self._perm) for x in xs)

    # ---------------------------------------------------------------- decode
    def decode(self, z: torch.Tensor, aemb: torch.Tensor):
        """z, aemb: [B, A, F] in *agent* order -> (recon_state [B, Σobs],
        recon_reward [B, A]), both float32."""
        b = z.shape[0]
        flat = torch.cat([z.reshape(b, -1), aemb.reshape(b, -1)], dim=-1).to(self.dtype)
        if self.fused_decoders:
            both = flat[:, None, :].expand(b, 2, flat.shape[-1])
            h = torch.relu(self.decoder_trunk(both))  # [B, 2, last_hidden]
            recon_state = self.state_head(h[:, 0])
            recon_reward = self.reward_linear(self.reward_head(h[:, 1]))
        else:
            recon_state = self.state_decoder(flat)
            recon_reward = self.reward_linear(self.reward_decoder(flat))
        return recon_state.to(torch.float32), recon_reward.to(torch.float32)

    # ------------------------------------------------------------ fused call
    def fused_call(self, batch: GroupedBatch, agent_ids=None,
                   generator: Optional[torch.Generator] = None, eps=None):
        """Forward through the fused reparam+KL kernel (ops/fused_elbo.py).
        Returns (recon_state, recon_reward, kl_rows [B, A]); the train step
        reduces kl as mean_B(sum_A), which equals kl_gaussian."""
        from mfvae_tpu_torch.ops.fused_elbo import fused_reparam_kl

        mu_g, logvar_g, aemb_g = self.encode(batch, agent_ids)
        eps = self._eps(generator, mu_g.shape, eps)
        z_g, kl_rows = fused_reparam_kl(
            mu_g.to(torch.float32), logvar_g.to(torch.float32), eps
        )
        z, aemb = self._to_agent_order(z_g, aemb_g)
        recon_state, recon_reward = self.decode(z, aemb)
        return recon_state, recon_reward, kl_rows

    # ------------------------------------------------------------- mean call
    def mean_call(self, batch: GroupedBatch, agent_ids=None):
        """Deterministic posterior-mean forward (z = mu), the serving
        prediction.  Returns (recon_state, recon_reward)."""
        mu_g, _, aemb_g = self.encode(batch, agent_ids)
        mu, aemb = self._to_agent_order(mu_g, aemb_g)
        return self.decode(mu.to(torch.float32), aemb)

    # ------------------------------------------------------------------ call
    def forward(self, batch: GroupedBatch, agent_ids=None,
                generator: Optional[torch.Generator] = None, eps=None):
        mu_g, logvar_g, aemb_g = self.encode(batch, agent_ids)
        z_g = self.reparameterize(mu_g, logvar_g, self._eps(generator, mu_g.shape, eps))
        mu, logvar, aemb, z = self._to_agent_order(mu_g, logvar_g, aemb_g, z_g)
        recon_state, recon_reward = self.decode(z, aemb)
        b = mu.shape[0]
        return (
            recon_state,
            recon_reward,
            mu.to(torch.float32).reshape(b, -1),
            logvar.to(torch.float32).reshape(b, -1),
        )
