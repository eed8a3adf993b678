"""Scripted collection policies (mirror of ``mfvae_tpu/envs/policies.py``).

The reference fills its replay buffer with uniform-random actions only.  A
scripted pursuit/evade policy makes adversary-prey contacts common, and
``collect_epsilon`` mixes uniform-random actions back in for coverage.

Every policy takes the env state with any leading axes ([E, ...] on the
batched path, where the JAX package vmaps) and draws from a
``torch.Generator``.  Each policy draws the sampler's uniform actions
first, so at ``collect_epsilon`` 1 (pursuit), ``mix_frac`` 0
(episode_mix) or hold 0 (sticky) the action is the sampler's draw from the
generator state the policy was handed.  No step reads the device from the
host.  Each policy's ``draw_noise(generator, lead)`` takes one step's draws
in that order, and its step takes them as ``noise``: the data-parallel
collect draws them for every env of the run and keeps its own envs' rows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from mfvae_tpu_torch.envs.mpe import SimpleAdversaryEnv, SimpleTagEnv


def _toward_discrete(delta: torch.Tensor) -> torch.Tensor:
    """[..., N, 2] displacement -> discrete action along its dominant axis
    (1 -x, 2 +x, 3 -y, 4 +y); on target (|delta| < 1e-6) the no-op.  On a
    tie |dx| = |dy| the x axis wins, as ``jnp.argmax`` takes the first
    maximum."""
    ax_y = torch.abs(delta[..., 1]) > torch.abs(delta[..., 0])
    comp = torch.where(ax_y, delta[..., 1], delta[..., 0])
    pos = comp > 0
    act = torch.where(
        ax_y, torch.where(pos, 4, 3), torch.where(pos, 2, 1)
    )
    on_target = torch.linalg.vector_norm(delta, dim=-1) < 1e-6
    return torch.where(on_target, 0, act).to(torch.int32)


def _toward_continuous(delta: torch.Tensor) -> torch.Tensor:
    """[..., N, 2] displacement -> its direction, a force in Box(-1, 1)."""
    norm = torch.linalg.vector_norm(delta, dim=-1, keepdim=True)
    return delta / torch.clamp(norm, min=1e-6)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [..., M, 2] gathered at idx [..., K] along the entity axis."""
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, 2))


def _tag_deltas(env: SimpleTagEnv, state) -> torch.Tensor:
    """Per-agent pursuit/evade displacement [..., A, 2]: adversaries chase
    their nearest good agent; good agents flee their nearest adversary and
    turn back inside the arena edge (from |x| = 0.8), which is what lets
    the slower hunters corner them."""
    n_adv = env.num_adversaries
    adv = state.agent_pos[..., :n_adv, :]
    good = state.agent_pos[..., n_adv:, :]
    d = torch.linalg.vector_norm(adv[..., :, None, :] - good[..., None, :, :], dim=-1)
    chase = _take(good, torch.argmin(d, dim=-1)) - adv
    flee = good - _take(adv, torch.argmin(d, dim=-2))
    flee = flee / torch.clamp(torch.linalg.vector_norm(flee, dim=-1, keepdim=True), min=1e-6)
    wall_pull = -torch.sign(good) * torch.clamp(torch.abs(good) - 0.8, min=0.0) * 2.0
    return torch.cat([chase, flee + wall_pull], dim=-2)


def _adversary_deltas(env: SimpleAdversaryEnv, state) -> torch.Tensor:
    """Per-agent displacement [..., A, 2] on simple_adversary: the good
    agents head for the goal landmark; the adversary, which cannot see the
    goal, heads for its nearest good agent."""
    adv = state.agent_pos[..., :1, :]
    good = state.agent_pos[..., 1:, :]
    d = torch.linalg.vector_norm(adv[..., :, None, :] - good[..., None, :, :], dim=-1)
    chase = _take(good, torch.argmin(d, dim=-1)) - adv
    seek = SimpleAdversaryEnv.goal_pos(state) - good
    return torch.cat([chase, seek], dim=-2)


_DELTA_FNS = {SimpleTagEnv: _tag_deltas, SimpleAdversaryEnv: _adversary_deltas}


def host_pursuit_actions(
    kind: str,
    pos: np.ndarray,
    n_adv: int,
    rng: np.random.Generator,
    epsilon: float,
    discrete: bool = True,
    goal_pos=None,
):
    """Numpy pursuit actions.  ``kind``: 'tag' (chase/evade with
    wall-aware prey) or 'adversary' (goal-seek good agents, chasing
    goal-blind adversary, ``goal_pos`` required).  ``pos`` is [A, 2] for
    one env or [K, A, 2] batched (adversaries first either way;
    ``goal_pos`` then [2] or [K, 2]).  Returns [A] / [K, A] int32 or
    [A, 2] / [K, A, 2] float32; epsilon mixes uniform-random actions per
    agent.  The host collectors' policy (``envs/host_adapter.py``), in
    numpy: bit-equal to the JAX package's at one generator state."""
    pos = np.asarray(pos, np.float64)
    single = pos.ndim == 2
    p = pos[None] if single else pos  # [K, A, 2]
    adv, good = p[:, :n_adv], p[:, n_adv:]
    d = np.linalg.norm(adv[:, :, None, :] - good[:, None, :, :], axis=-1)
    nearest_prey = np.argmin(d, axis=2)  # [K, n_adv]
    chase = (
        np.take_along_axis(good, nearest_prey[:, :, None], axis=1) - adv
    )
    if kind == "tag":
        nearest_hunter = np.argmin(d, axis=1)  # [K, G]
        flee = good - np.take_along_axis(
            adv, nearest_hunter[:, :, None], axis=1
        )
        flee = flee / np.maximum(
            np.linalg.norm(flee, axis=-1, keepdims=True), 1e-6
        )
        wall = -np.sign(good) * np.maximum(np.abs(good) - 0.8, 0.0) * 2.0
        delta = np.concatenate([chase, flee + wall], axis=1)
    elif kind == "adversary":
        gp = np.asarray(goal_pos, np.float64)
        if single:
            gp = gp[None]
        seek = gp[:, None, :] - good
        delta = np.concatenate([chase, seek], axis=1)
    else:
        raise ValueError(f"unknown host pursuit kind {kind!r}")

    k, n = delta.shape[0], delta.shape[1]
    if discrete:
        ax = np.argmax(np.abs(delta), axis=-1)  # [K, A]
        comp = np.take_along_axis(delta, ax[..., None], axis=-1)[..., 0]
        act = np.where(ax == 0, np.where(comp > 0, 2, 1),
                       np.where(comp > 0, 4, 3))
        act = np.where(np.linalg.norm(delta, axis=-1) < 1e-6, 0, act)
        rand = rng.integers(0, 5, size=(k, n))
        take = rng.uniform(size=(k, n)) < epsilon
        out = np.where(take, rand, act).astype(np.int32)
        return out[0] if single else out
    norm = np.maximum(np.linalg.norm(delta, axis=-1, keepdims=True), 1e-6)
    act = delta / norm
    rand = rng.uniform(-1.0, 1.0, size=(k, n, 2))
    take = (rng.uniform(size=(k, n)) < epsilon)[..., None]
    out = np.where(take, rand, act).astype(np.float32)
    return out[0] if single else out


def _leading(state) -> tuple:
    return tuple(state.step.shape)


class CollectNoise(NamedTuple):
    """The draws of one ``ImaginationCollectPolicy`` step over leading axes L."""

    rand: torch.Tensor  # [*L, A(, d)] the sampler's uniform actions (epsilon mixture)
    eps: torch.Tensor  # [*L, A] uniforms, < epsilon -> the uniform action
    hold: torch.Tensor  # [*L, A] uniforms, < hold -> the previous action
    actor: object  # the policy actor's ActorNoise


class ImaginationCollectPolicy:
    """Collection with a saved imagination policy (``behavior.save_policy``
    as the port writes it): its plan agents act from the policy's sampled
    distribution, every agent takes a uniform action with probability
    ``epsilon`` and keeps its previous action with probability ``hold``
    (the collect_mix_frac knob, as sticky reuses it; never at an episode's
    first step).  Collecting with the learned behavior and retraining the
    world model closes the Dreamer iteration.

    carry = (prev_actions, fresh), reset at episode end.  ``step`` takes an
    explicit ``CollectNoise`` or draws one, the sampler's actions first."""

    def __init__(self, env, spec, path: str, epsilon: float, sample_fn, hold: float = 0.0):
        from mfvae_tpu_torch.behavior import load_policy  # it imports this module
        from mfvae_tpu_torch.imagination import make_policy_actor

        policy, meta = load_policy(path, device=env.device)
        self._actor = make_policy_actor(
            policy, env, spec, tuple(meta["plan_agents"]), greedy=False,
            centralized=bool(meta.get("centralized", False)),
        )
        self.epsilon = float(epsilon)
        self.hold = float(hold)
        self.n_agents = spec.n_agents
        self.discrete = getattr(env, "discrete_actions", True)
        self.act_shape = () if self.discrete else (spec.act_dims[0],)
        self.sample_fn = sample_fn
        self.device = env.device

    def init_carry(self, leading=()):
        dtype = torch.int32 if self.discrete else torch.float32
        prev = torch.zeros(tuple(leading) + (self.n_agents,) + self.act_shape, dtype=dtype, device=self.device)
        return (prev, torch.ones(leading, dtype=torch.bool, device=self.device))

    def draw_noise(self, generator, lead=()) -> CollectNoise:
        rand = self.sample_fn(generator, lead)
        eps = torch.rand(lead + (self.n_agents,), generator=generator, device=self.device)
        hold = torch.rand(lead + (self.n_agents,), generator=generator, device=self.device)
        return CollectNoise(rand, eps, hold, self._actor.draw_noise(generator, lead))

    def step(self, carry, stacked_obs, env_state, generator, noise: Optional[CollectNoise] = None):
        prev, fresh = carry
        if noise is None:
            noise = self.draw_noise(generator, _leading(env_state))
        act = self._actor(stacked_obs, noise=noise.actor)
        if self.epsilon > 0.0:
            override = noise.eps < self.epsilon
            act = torch.where(override if self.discrete else override[..., None], noise.rand, act)
        if self.hold > 0.0:
            keep = (noise.hold < self.hold) & ~fresh[..., None]
            act = torch.where(keep if self.discrete else keep[..., None], prev, act)
        return (act, torch.zeros_like(fresh)), act


class EpisodeMixPolicy:
    """Whole episodes under the scripted policy (probability ``mix_frac``)
    or under uniform random actions.  carry = (fresh, use_scripted), each
    bool [*leading]; the trainer resets it to ``init_carry`` at episode
    end, which re-arms ``fresh`` so the next step redraws the episode's
    policy."""

    def __init__(self, scripted, sample_fn, mix_frac: float, device):
        self.scripted = scripted
        self.sample_fn = sample_fn
        self.mix_frac = float(mix_frac)
        self.device = device

    def init_carry(self, leading=()):
        return (
            torch.ones(leading, dtype=torch.bool, device=self.device),
            torch.zeros(leading, dtype=torch.bool, device=self.device),
        )

    def draw_noise(self, generator, lead=()) -> tuple:
        """(the sampler's actions, the episode draw, the scripted policy's noise)."""
        rand = self.sample_fn(generator, lead)
        draw = torch.rand(lead, generator=generator, device=self.device)
        return rand, draw, self.scripted.draw_noise(generator, lead)

    def step(self, carry, stacked_obs, env_state, generator, noise=None):
        fresh, use_scripted = carry
        lead = _leading(env_state)
        rand, draw, scripted_noise = self.draw_noise(generator, lead) if noise is None else noise
        use_scripted = torch.where(fresh, draw < self.mix_frac, use_scripted)
        scripted = self.scripted(env_state, generator, scripted_noise)
        pick = use_scripted.reshape(lead + (1,) * (rand.dim() - len(lead)))
        act = torch.where(pick, scripted, rand)
        return (torch.zeros_like(fresh), use_scripted), act


class StickyRandomPolicy:
    """Each agent repeats its previous action with probability
    ``sticky_prob`` and resamples uniformly otherwise, so held directions
    accumulate displacement that multi-step objectives can see.  carry =
    (prev_actions, fresh); the trainer resets it at episode end."""

    def __init__(self, env, spec, sample_fn, sticky_prob: float):
        self.sample_fn = sample_fn
        self.sticky_prob = float(sticky_prob)
        self.n_agents = spec.n_agents
        self.discrete = getattr(env, "discrete_actions", True)
        self.act_shape = () if self.discrete else (spec.act_dims[0],)
        self.device = env.device

    def init_carry(self, leading=()):
        dtype = torch.int32 if self.discrete else torch.float32
        prev = torch.zeros(tuple(leading) + (self.n_agents,) + self.act_shape, dtype=dtype, device=self.device)
        return (prev, torch.ones(leading, dtype=torch.bool, device=self.device))

    def draw_noise(self, generator, lead=()) -> tuple:
        """(the sampler's actions, the per-agent hold uniforms)."""
        rand = self.sample_fn(generator, lead)
        return rand, torch.rand(lead + (self.n_agents,), generator=generator, device=self.device)

    def step(self, carry, stacked_obs, env_state, generator, noise=None):
        prev, fresh = carry
        rand, u = self.draw_noise(generator, _leading(env_state)) if noise is None else noise
        keep = (u < self.sticky_prob) & ~fresh[..., None]
        if not self.discrete:
            keep = keep[..., None]
        act = torch.where(keep, prev, rand)
        return (act, torch.zeros_like(fresh)), act


def reset_carry(policy, carry, done_all: torch.Tensor):
    """The policy carry with every env whose episode ended (``done_all``
    [*leading] bool) back at ``init_carry``."""
    init = policy.init_carry(tuple(done_all.shape))
    return tuple(
        torch.where(done_all.reshape(done_all.shape + (1,) * (p.dim() - done_all.dim())), i, p)
        for i, p in zip(init, carry)
    )


def make_collect_policy(env, spec, name: str, epsilon: float, sample_fn, mix_frac: float = 0.5):
    """A collection policy, or None for ``name='random'`` (the reference).

    - ``'pursuit'``: ``PursuitPolicy``, ``policy(state, generator)`` -> actions, scripted
      chase/evade (simple_tag) or chase/goal-seek (simple_adversary) with
      an epsilon-uniform mixture per agent; dominant-axis
      moves for discrete actions, normalized forces for continuous ones.
    - ``'episode_mix'``: ``EpisodeMixPolicy`` over pursuit and the sampler.
    - ``'sticky'``: ``StickyRandomPolicy`` with hold probability
      ``mix_frac``.
    - ``'imagination:<path>'``: ``ImaginationCollectPolicy`` over the
      policy file the port's ``behavior.save_policy`` wrote, with hold
      probability ``mix_frac``.

    ``sample_fn(generator, leading)`` is the trainer's uniform sampler
    (``make_action_sampler``), so the mixture keeps the env's own action
    bounds."""
    if name == "random":
        return None
    if name.startswith("imagination:"):
        return ImaginationCollectPolicy(env, spec, name[len("imagination:"):], epsilon, sample_fn, hold=mix_frac)
    if name == "episode_mix":
        scripted = make_collect_policy(env, spec, "pursuit", epsilon, sample_fn)
        return EpisodeMixPolicy(scripted, sample_fn, mix_frac, env.device)
    if name == "sticky":
        return StickyRandomPolicy(env, spec, sample_fn, mix_frac)
    if name != "pursuit":
        raise ValueError(f"unknown collect_policy {name!r}")
    delta_fn = next((fn for cls, fn in _DELTA_FNS.items() if isinstance(env, cls)), None)
    if delta_fn is None:
        raise ValueError(
            f"collect_policy='pursuit' is not defined for {type(env).__name__}"
            " (supported: simple_tag, simple_adversary)"
        )
    return PursuitPolicy(env, spec, delta_fn, epsilon, sample_fn)


class PursuitPolicy:
    """``policy(state, generator, noise=None)`` -> scripted actions with an
    epsilon-uniform mixture per agent; ``draw_noise`` takes the sampler's
    actions, then the mixture's uniforms."""

    def __init__(self, env, spec, delta_fn, epsilon: float, sample_fn):
        self.env = env
        self.delta_fn = delta_fn
        self.epsilon = float(epsilon)
        self.sample_fn = sample_fn
        self.n_agents = spec.n_agents
        self.discrete = getattr(env, "discrete_actions", True)

    def draw_noise(self, generator, lead=()) -> tuple:
        rand = self.sample_fn(generator, lead)
        return rand, torch.rand(lead + (self.n_agents,), generator=generator, device=self.env.device)

    def __call__(self, state, generator, noise=None):
        rand, u = self.draw_noise(generator, _leading(state)) if noise is None else noise
        take_rand = u < self.epsilon
        delta = self.delta_fn(self.env, state)
        if self.discrete:
            return torch.where(take_rand, rand, _toward_discrete(delta))
        return torch.where(take_rand[..., None], rand, _toward_continuous(delta))
