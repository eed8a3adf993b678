"""MAVAE — the multi-agent factorized VAE world model, in PyTorch.

A port of ``mfvae_tpu/models/mavae.py``: per-agent Gaussian encoders over
(agent-index embedding ‖ observation), stacked per agent group; per-agent
action embeddings (discrete) or action MLPs (continuous); a joint decoder
of the next global state and the per-agent reward, as one fused two-stack
trunk (``fused_decoders``, the default) or as two MLPs.  Every model
option of the JAX package is here: ``det_features``, the
``shared_private`` latent with its product of experts, ``residual_state``,
``state_skip``, ``decoder_layernorm``, the two-hot reward head,
``reward_head_input='pred_state'`` and ``action_delta_head``.  Besides
a ``GroupedBatch``, the model takes the reference's per-agent
``idx_state``/``actions`` dicts (``group_dict_batch``), reading each
agent's embedding index from column 0 of its data.

Noise: the JAX model draws eps from a key inside the call.  Here every
sampling call takes an optional explicit ``eps`` [B, A, F] in *grouped*
agent order — the shape ``_eps`` draws — and, for the shared latent, an
explicit ``eps_shared`` [B, S]; or it draws both from a
``torch.Generator``, private first.  Both train-step routes draw the same
way, so from one generator state they see the same noise.

``rng_mode='reference'`` replays the reference's order of draws
(``jax_ver/model.py:161``: one key split off per agent, in sequence): eps
is one [B, F] normal per agent, drawn in sequence from the generator, and
draw i is row i of the *grouped* [B, A, F] tensor, as the JAX model gives
its i-th split key to grouped row i.  Both train-step routes take it
through ``_eps``, so the kernels K1/K2 see the same noise as the plain
route.  ``remat`` recomputes the Denses of the encoders, the continuous
action encoders and the decoders in the backward (``layers.py``), where
the JAX model wraps them in ``nn.remat``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

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

    @property
    def obs_dim_map(self) -> Dict[str, int]:
        return dict(zip(self.agents, self.obs_dims))

    @property
    def act_dim_map(self) -> Dict[str, int]:
        return dict(zip(self.agents, self.act_dims))

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


def zero_actions_grouped(spec: AgentSpec, batch_size: Optional[int], discrete: bool = True,
                         device=None):
    """Per-group zero actions: int32 [B, A_g] (discrete) or float32
    [B, A_g, act_dim_g] (continuous); no batch axis when ``batch_size`` is
    None."""
    lead = () if batch_size is None else (batch_size,)
    if discrete:
        return tuple(
            torch.zeros(lead + (len(idxs),), dtype=torch.int32, device=device)
            for _, idxs in spec.groups
        )
    return tuple(
        torch.zeros(lead + (len(idxs), ad), dtype=torch.float32, device=device)
        for (_, ad), idxs in spec.groups
    )


class GroupedBatch(NamedTuple):
    """Model input, one entry per AgentSpec group (in group order).

    obs[g]:     [B, A_g, obs_dim_g] float
    actions[g]: [B, A_g] int (discrete) or [B, A_g, act_dim_g] float
    """

    obs: Tuple[torch.Tensor, ...]
    actions: Tuple[torch.Tensor, ...]


def group_dict_batch(
    spec: AgentSpec,
    idx_state: Dict[str, torch.Tensor],
    actions: Dict[str, torch.Tensor],
) -> Tuple[GroupedBatch, Tuple[torch.Tensor, ...]]:
    """Stack the reference's per-agent dicts into grouped tensors.

    ``idx_state[agent]`` is [B, 1+obs_dim] with the agent index as column 0
    (the reference's create_dataset contract, jax_ver/trainer.py:23).
    Returns the grouped batch plus per-group [B, A_g] int32 agent indices
    read from the data by floor and a cast, as the reference reads them
    (jax_ver/model.py:152-153), on the data's device."""
    obs_g, act_g, ids_g = [], [], []
    for _, idxs in spec.groups:
        names = [spec.agents[i] for i in idxs]
        obs_g.append(torch.stack([idx_state[a][:, 1:] for a in names], dim=1))
        ids_g.append(torch.stack([torch.floor(idx_state[a][:, 0]).to(torch.int32) for a in names], dim=1))
        act_g.append(torch.stack([actions[a] for a in names], dim=1))
    return GroupedBatch(obs=tuple(obs_g), actions=tuple(act_g)), tuple(ids_g)


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




class MAVAE(nn.Module):
    """Public calls return float32 outputs in agent order: ``forward`` ->
    (recon_state [B, Σobs], recon_reward [B, A] — logits [B, A, K] under
    the two-hot head —, mu_all [B, A·F (+S)], logvar_all [B, A·F (+S)])."""

    def __init__(self, spec: AgentSpec, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.rng_mode not in ("vectorized", "reference"):
            raise ValueError(f"unknown rng_mode {cfg.rng_mode!r}")
        if cfg.reward_head_init not in ("lecun", "popart"):
            raise ValueError(f"unknown reward_head_init {cfg.reward_head_init!r}")
        if cfg.latent_structure not in ("private", "shared_private"):
            raise ValueError(f"unknown latent_structure {cfg.latent_structure!r}")
        if cfg.reward_head_mode not in ("linear", "twohot"):
            raise ValueError(f"unknown reward_head_mode {cfg.reward_head_mode!r}")
        if cfg.reward_head_input not in ("latent", "pred_state"):
            raise ValueError(f"unknown reward_head_input {cfg.reward_head_input!r}")
        if cfg.reward_head_input == "pred_state" and cfg.fused_decoders:
            raise ValueError(
                "reward_head_input='pred_state' needs fused_decoders=false (the "
                "fused trunk shares one input; the pred_state reward branch "
                "runs after the state decode)"
            )
        self.spec = spec
        self.obs_features = f = cfg.obs_features
        self.fused_decoders = cfg.fused_decoders
        self.discrete_act = cfg.discrete_act
        self.shared = cfg.latent_structure == "shared_private"
        self.shared_latent = s = cfg.shared_latent if self.shared else 0
        self.det_features = cfg.det_features
        self.residual_state = cfg.residual_state
        self.state_skip = cfg.state_skip
        self.twohot = cfg.reward_head_mode == "twohot"
        self.reward_bins = cfg.reward_bins
        self.pred_state_reward = cfg.reward_head_input == "pred_state"
        self.action_delta_head = cfg.action_delta_head
        self.reference_rng = cfg.rng_mode == "reference"
        self.dtype = dtype = DTYPES[cfg.compute_dtype]
        n, af, sum_obs = spec.n_agents, cfg.action_features, sum(spec.obs_dims)
        kw = dict(dtype=dtype, device=device, generator=generator)
        rkw = dict(kw, remat=cfg.remat)  # the JAX model's nn.remat sites
        self.idx_emb = Embedding(n, cfg.idx_features, **kw)
        self.encoders = nn.ModuleList()
        self.action_encoders = nn.ModuleList()
        enc_out = 2 * f + 2 * s + self.det_features
        for (obs_dim, act_dim), idxs in spec.groups:
            self.encoders.append(
                StackedMLP(len(idxs), cfg.idx_features + obs_dim, cfg.encoder_hidden, enc_out, **rkw)
            )
            if self.discrete_act:
                enc = StackedEmbedding(len(idxs), act_dim, af, **kw)
            else:
                enc = StackedMLP(len(idxs), act_dim, cfg.action_encoder_hidden, af, **rkw)
            self.action_encoders.append(enc)
        if self.action_delta_head:
            # zero-init: the pathway starts as an exact no-op
            self.action_delta_heads = nn.ModuleList(
                Dense(af, obs_dim, kernel_init="zeros", **kw) for (obs_dim, _), _ in spec.groups
            )
        dec_in = n * (f + af) + s + n * self.det_features
        if self.state_skip:
            dec_in += sum_obs
        hidden = tuple(cfg.decoder_hidden)
        ln = cfg.decoder_layernorm
        reward_out = n * cfg.reward_bins if self.twohot else n
        if self.fused_decoders:
            # state + reward decoders share hidden widths: one two-stack trunk
            self.decoder_trunk = StackedMLP(2, dec_in, hidden[:-1], hidden[-1], layernorm=ln, **rkw)
            self.state_head = Dense(hidden[-1], sum_obs, **kw)
            self.reward_head = Dense(hidden[-1], reward_out, **kw)
        else:
            self.state_decoder = MLP(dec_in, hidden, sum_obs, layernorm=ln, **rkw)
            r_in = dec_in
            if self.pred_state_reward:
                r_in = sum_obs + n * af + (sum_obs if self._needs_base else 0)
            self.reward_decoder = MLP(r_in, hidden, reward_out, layernorm=ln, **rkw)
        if not self.twohot:
            # PopArt output head: all-ones kernel under 'popart', lecun
            # otherwise; the two-hot head has none (as the JAX tree)
            self.reward_linear = Dense(
                n, n, kernel_init="ones" if cfg.reward_head_init == "popart" else "lecun", **kw
            )
        self.register_buffer(
            "_perm", torch.tensor(spec.perm_from_grouped, device=device), persistent=False
        )
        # each group's agent indices on the device once, so a call copies
        # nothing from the host (on the card such a copy waits for the
        # device, and no CUDA graph can capture it)
        for g, (_, idxs) in enumerate(spec.groups):
            self.register_buffer(f"_agent_ids{g}", torch.tensor(idxs, device=device), persistent=False)

    @classmethod
    def from_config(cls, cfg: ModelConfig, spec: AgentSpec, device=None,
                    generator: Optional[torch.Generator] = None) -> "MAVAE":
        return cls(spec, cfg, device=device, generator=generator)

    @property
    def _needs_base(self) -> bool:
        return self.residual_state or self.state_skip

    def _group_ids(self, g: int) -> torch.Tensor:
        """Group ``g``'s agent indices [A_g] (int64, on the model's device)."""
        return getattr(self, f"_agent_ids{g}")

    def _base(self, batch: GroupedBatch) -> Optional[torch.Tensor]:
        """The current global state [B, Σobs] where the decoder reads it."""
        return agent_order_concat(self.spec, batch.obs) if self._needs_base else None

    # ---------------------------------------------------------------- encode
    def encode(self, batch: GroupedBatch, agent_ids=None):
        """(mu, logvar, action_emb, shared_experts, det): the first three
        [B, A, ·] in *grouped* agent order; ``shared_experts`` the per-agent
        (mu, logvar) [B, A, S] over the shared latent, or None; ``det``
        [B, A, D] (grouped order) or None."""
        f, s = self.obs_features, self.shared_latent
        mus, logvars, aembs, smus, slvs, dets = [], [], [], [], [], []
        for g in range(len(self.spec.groups)):
            obs = batch.obs[g]
            if agent_ids is None:
                ids = self._group_ids(g)[None, :].expand(obs.shape[0], -1)
                emb = self.idx_emb(ids)
            else:
                emb = self.idx_emb.take(agent_ids[g])  # ids from data: JAX's rule
            enc_in = torch.cat([emb, obs.to(self.dtype)], dim=-1)
            latent = self.encoders[g](enc_in)  # [B, A_g, 2F (+2S) (+D)]
            mus.append(latent[..., :f])
            logvars.append(latent[..., f : 2 * f])
            off = 2 * f
            if self.shared:
                smus.append(latent[..., off : off + s])
                slvs.append(latent[..., off + s : off + 2 * s])
                off += 2 * s
            if self.det_features:
                dets.append(latent[..., off:])
            act = batch.actions[g]
            aembs.append(self.action_encoders[g](act if self.discrete_act else act.to(self.dtype)))
        experts = (torch.cat(smus, dim=1), torch.cat(slvs, dim=1)) if self.shared else None
        det = torch.cat(dets, dim=1) if self.det_features else None
        return torch.cat(mus, dim=1), torch.cat(logvars, dim=1), torch.cat(aembs, dim=1), experts, det

    # ---------------------------------------------------------- reparam/eps
    @staticmethod
    def _draw(generator: Optional[torch.Generator], shape, given, name: str) -> torch.Tensor:
        """``given`` itself when it is passed, else one standard-normal draw
        of ``shape`` from ``generator``."""
        if given is not None:
            if tuple(given.shape) != tuple(shape):
                raise ValueError(f"{name} has shape {tuple(given.shape)}, expected {tuple(shape)}")
            return given.to(torch.float32)
        if generator is None:
            raise ValueError("a sampling call needs a generator or an explicit eps")
        return torch.randn(tuple(shape), generator=generator, device=generator.device)

    def _eps(self, generator: Optional[torch.Generator], shape, eps=None) -> torch.Tensor:
        """The private noise for ``shape`` = [B, A, F] (grouped order): one
        draw, or under ``rng_mode='reference'`` one [B, F] draw per agent
        in sequence, draw i to grouped row i."""
        if eps is not None or not self.reference_rng:
            return self._draw(generator, shape, eps, "eps")
        b, a, f = shape
        return torch.stack([self._draw(generator, (b, f), None, "eps") for _ in range(a)], dim=1)

    def draw_eps(self, generator: torch.Generator, batch_size: int):
        """(eps [B, A, F], eps_shared [B, S] or None): the draws a sampling
        call over ``batch_size`` rows takes from ``generator``, in its order."""
        eps = self._eps(generator, (batch_size, self.spec.n_agents, self.obs_features))
        if not self.shared:
            return eps, None
        return eps, self._draw(generator, (batch_size, self.shared_latent), None, "eps_shared")

    @staticmethod
    def reparameterize(mu, logvar, eps):
        """z = mu + eps * exp(0.5*logvar), in float32."""
        std = torch.exp(0.5 * logvar.to(torch.float32))
        return mu.to(torch.float32) + eps * std

    @staticmethod
    def poe(experts):
        """Product of the per-agent Gaussian experts [B, A, S] with a unit
        prior: precision T = 1 + Σ_a exp(−lv_a), mu = Σ_a mu_a exp(−lv_a) / T,
        logvar = −log T."""
        mu_e, lv_e = experts
        prec = torch.exp(-lv_e.to(torch.float32))
        total = 1.0 + torch.sum(prec, dim=1)  # [B, S]
        mu = torch.sum(mu_e.to(torch.float32) * prec, dim=1) / total
        return mu, -torch.log(total)

    def _shared_sample(self, experts, generator, eps_shared):
        """(z_shared, mu_s, logvar_s) from the PoE posterior."""
        mu_s, logvar_s = self.poe(experts)
        eps_s = self._draw(generator, mu_s.shape, eps_shared, "eps_shared")
        return mu_s + eps_s * torch.exp(0.5 * logvar_s), mu_s, logvar_s

    def _to_agent_order(self, *xs):
        if self.spec.grouped_is_identity:
            return xs
        return tuple(None if x is None else x.index_select(1, self._perm) for x in xs)

    # ---------------------------------------------------------------- decode
    def _add_action_delta(self, recon: torch.Tensor, aemb: torch.Tensor) -> torch.Tensor:
        """The direct action -> own-obs-delta pathway (``action_delta_head``)."""
        deltas = tuple(
            self.action_delta_heads[g](aemb[:, self._group_ids(g), :])
            for g in range(len(self.spec.groups))
        )
        return recon + agent_order_concat(self.spec, deltas).to(recon.dtype)

    def decode(self, z: torch.Tensor, aemb: torch.Tensor, z_shared=None, det=None,
               base_state=None):
        """z, aemb [B, A, F] and det [B, A, D] in *agent* order, z_shared
        [B, S] -> (recon_state [B, Σobs], recon_reward [B, A] or logits
        [B, A, K]), both float32.  ``base_state`` [B, Σobs] (the current
        global state) is required under ``residual_state``/``state_skip``."""
        b = z.shape[0]
        if self._needs_base and base_state is None:
            raise ValueError(
                "residual_state/state_skip: decode() needs base_state (the "
                "current global state, agent_order_concat(spec, obs))"
            )
        parts = [z.reshape(b, -1), aemb.reshape(b, -1)]
        if z_shared is not None:
            parts.append(z_shared)
        if det is not None:
            parts.append(det.reshape(b, -1))
        if self.state_skip:
            parts.append(base_state)
        flat = torch.cat([p.to(torch.float32) for p in parts], dim=-1).to(self.dtype)
        if self.fused_decoders:
            both = flat[:, None, :].expand(b, 2, flat.shape[-1])
            h = torch.relu(self.decoder_trunk(both))  # [B, 2, last_hidden]
            recon_state = self.state_head(h[:, 0])
            if self.action_delta_head:
                recon_state = self._add_action_delta(recon_state, aemb)
            recon_reward = self.reward_head(h[:, 1])
        else:
            recon_state = self.state_decoder(flat)
            if self.action_delta_head:
                recon_state = self._add_action_delta(recon_state, aemb)
            r_in = flat
            if self.pred_state_reward:
                # reward from the predicted geometry, with no gradient into
                # the state path
                ns = recon_state.to(torch.float32)
                if self.residual_state:
                    ns = ns + base_state.to(torch.float32)
                parts_r = [ns.detach(), aemb.reshape(b, -1).to(torch.float32)]
                if base_state is not None:
                    parts_r.append(base_state.to(torch.float32))
                r_in = torch.cat(parts_r, dim=-1).to(self.dtype)
            recon_reward = self.reward_decoder(r_in)
        if self.twohot:
            recon_reward = recon_reward.reshape(b, self.spec.n_agents, self.reward_bins)
        else:
            recon_reward = self.reward_linear(recon_reward)
        recon_state = recon_state.to(torch.float32)
        if self.residual_state:
            recon_state = recon_state + base_state.to(torch.float32)
        return recon_state, recon_reward.to(torch.float32)

    # ------------------------------------------------------------ fused call
    def fused_call(self, batch: GroupedBatch, agent_ids=None,
                   generator: Optional[torch.Generator] = None, eps=None, eps_shared=None):
        """Forward through the fused reparam+KL kernel (ops/fused_elbo.py).
        Returns (recon_state, recon_reward, kl_rows [B, A (+1)]): the shared
        latent's KL is one extra column, so the train step's mean_B(sum_A)
        equals kl_gaussian over the whole posterior."""
        from mfvae_tpu_torch.ops.fused_elbo import fused_reparam_kl

        mu_g, logvar_g, aemb_g, experts, det = self.encode(batch, agent_ids)
        eps = self._eps(generator, mu_g.shape, eps)
        z_g, kl_rows = fused_reparam_kl(
            mu_g.to(torch.float32), logvar_g.to(torch.float32), eps
        )
        z, aemb, det = self._to_agent_order(z_g, aemb_g, det)
        z_shared = None
        if experts is not None:
            z_shared, mu_s, logvar_s = self._shared_sample(experts, generator, eps_shared)
            kl_s = -0.5 * torch.sum(1.0 + logvar_s - mu_s * mu_s - torch.exp(logvar_s), dim=-1)
            kl_rows = torch.cat([kl_rows, kl_s[:, None]], dim=1)
        recon_state, recon_reward = self.decode(z, aemb, z_shared, det, self._base(batch))
        return recon_state, recon_reward, kl_rows

    # ------------------------------------------------------------- mean call
    def mean_call(self, batch: GroupedBatch, agent_ids=None):
        """Deterministic posterior-mean forward (z = mu, and the PoE mean
        for the shared latent), the serving prediction.  Returns
        (recon_state, recon_reward [B, A]); the two-hot head's logits are
        collapsed to their expectation."""
        mu_g, _, aemb_g, experts, det = self.encode(batch, agent_ids)
        mu, aemb, det = self._to_agent_order(mu_g, aemb_g, det)
        z_shared = self.poe(experts)[0] if experts is not None else None
        recon_state, recon_reward = self.decode(
            mu.to(torch.float32), aemb, z_shared, det, self._base(batch)
        )
        if self.twohot:
            from mfvae_tpu_torch.models.losses import twohot_bins, twohot_expectation

            recon_reward = twohot_expectation(
                recon_reward, twohot_bins(self.reward_bins, recon_reward.device)
            )
        return recon_state, recon_reward

    # ------------------------------------------------------------------ call
    def forward(self, batch: Union[GroupedBatch, Dict[str, torch.Tensor]], agent_ids=None,
                generator: Optional[torch.Generator] = None, eps=None, eps_shared=None):
        """(recon_state [B, Σobs], recon_reward [B, A], mu, logvar [B, A*F
        (+S)]) in agent order.  ``batch`` is a GroupedBatch, with optional
        per-group ``agent_ids``; or the reference's ``idx_state`` dict
        (create_dataset's), and then the second argument is its actions
        dict and the agent ids are read from the data (``group_dict_batch``)."""
        if isinstance(batch, dict):
            batch, agent_ids = group_dict_batch(self.spec, batch, agent_ids)
        mu_g, logvar_g, aemb_g, experts, det = self.encode(batch, agent_ids)
        z_g = self.reparameterize(mu_g, logvar_g, self._eps(generator, mu_g.shape, eps))
        mu, logvar, aemb, z, det = self._to_agent_order(mu_g, logvar_g, aemb_g, z_g, det)
        b = mu.shape[0]
        mu_all = mu.to(torch.float32).reshape(b, -1)
        logvar_all = logvar.to(torch.float32).reshape(b, -1)
        z_shared = None
        if experts is not None:
            z_shared, mu_s, logvar_s = self._shared_sample(experts, generator, eps_shared)
            # the shared dims appended: KL over the concatenation is
            # KL(private) + KL(shared)
            mu_all = torch.cat([mu_all, mu_s], dim=-1)
            logvar_all = torch.cat([logvar_all, logvar_s], dim=-1)
        recon_state, recon_reward = self.decode(z, aemb, z_shared, det, self._base(batch))
        return recon_state, recon_reward, mu_all, logvar_all
