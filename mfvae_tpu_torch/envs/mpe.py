"""MPE simple_tag in PyTorch, on the run's device.

A port of ``mfvae_tpu/envs/mpe.py``'s ``SimpleTagEnv``: the same scenario
constants, integrator, observation layout and rewards, vectorised over
entities (pairwise contact forces are one [N, N, 2] broadcast) and over any
leading batch axes of the state.  The physics is deterministic, so
``tests/test_torch_env.py`` holds it against the JAX env by injecting one
state into both.  The other scenarios are not ported yet (ROADMAP M14).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from mfvae_tpu_torch.envs.spaces import Box, Discrete

DT = 0.1
DAMPING = 0.25
CONTACT_FORCE = 1e2
CONTACT_MARGIN = 1e-3
ADV_SIZE, GOOD_SIZE, LANDMARK_SIZE = 0.075, 0.05, 0.2
ADV_ACCEL, GOOD_ACCEL = 3.0, 4.0
ADV_MAX_SPEED, GOOD_MAX_SPEED = 1.0, 1.3
COLLISION_REWARD = 10.0
# 0 no-op, 1 -x, 2 +x, 3 -y, 4 +y
DISCRETE_DIRECTIONS = ((0.0, 0.0), (-1.0, 0.0), (1.0, 0.0), (0.0, -1.0), (0.0, 1.0))


class MPEState(NamedTuple):
    agent_pos: torch.Tensor  # [..., A, 2] adversaries first, then good agents
    agent_vel: torch.Tensor  # [..., A, 2]
    landmark_pos: torch.Tensor  # [..., L, 2]
    step: torch.Tensor  # [...] int32


class StackedObs(NamedTuple):
    adversary: torch.Tensor  # [..., n_adv, obs_dim_adv]
    good: torch.Tensor  # [..., n_good, obs_dim_good]


def _off_diagonal(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, cols) of every off-diagonal entry of an n×n grid, row-major."""
    return torch.nonzero(~torch.eye(n, dtype=torch.bool, device=device), as_tuple=True)


class SimpleTagEnv:
    """simple_tag with 10 good agents, 30 adversaries and 20 obstacles by
    default; every tensor lives on ``device``."""

    def __init__(
        self,
        num_good_agents: int = 10,
        num_adversaries: int = 30,
        num_obs: int = 20,
        max_steps: int = 1000,
        discrete_actions: bool = True,
        device="cuda",
    ):
        self.num_good_agents = num_good_agents
        self.num_adversaries = num_adversaries
        self.num_obs = num_obs
        self.max_steps = max_steps
        self.discrete_actions = discrete_actions
        self.device = torch.device(device)
        a, g, n = num_adversaries, num_good_agents, self.num_agents

        def per_class(adv, good):
            return torch.tensor([adv] * a + [good] * g, dtype=torch.float32, device=self.device)

        self._sizes = per_class(ADV_SIZE, GOOD_SIZE)
        self._accels = per_class(ADV_ACCEL, GOOD_ACCEL)
        self._max_speeds = per_class(ADV_MAX_SPEED, GOOD_MAX_SPEED)
        ent_size = torch.cat(
            [self._sizes, torch.full((num_obs,), LANDMARK_SIZE, device=self.device)]
        )
        self._dist_min = ent_size[:, None] + ent_size[None, :]
        self._not_self = 1.0 - torch.eye(n + num_obs, device=self.device)
        self._directions = torch.tensor(DISCRETE_DIRECTIONS, device=self.device)
        self._other_rows, self._other_cols = _off_diagonal(n, self.device)
        self._good_cols = _off_diagonal(g, self.device)[1]

    # ------------------------------------------------------------- metadata
    @property
    def agents(self) -> Tuple[str, ...]:
        return tuple(f"adversary_{i}" for i in range(self.num_adversaries)) + tuple(
            f"agent_{i}" for i in range(self.num_good_agents)
        )

    @property
    def num_agents(self) -> int:
        return self.num_adversaries + self.num_good_agents

    def obs_dim(self, adversary) -> int:
        # [self_vel(2), self_pos(2), landmark_rel(2L), other_rel(2(A-1)),
        #  good_vel(2 * visible good agents)]
        if isinstance(adversary, str):
            adversary = adversary.startswith("adversary")
        base = 4 + 2 * self.num_obs + 2 * (self.num_agents - 1)
        return base + 2 * (
            self.num_good_agents if adversary else self.num_good_agents - 1
        )

    def action_space(self, agent: str):
        if self.discrete_actions:
            return Discrete(5)
        return Box(-1.0, 1.0, (2,))

    def observation_space(self, agent: str):
        return Box(-math.inf, math.inf, (self.obs_dim(agent),))

    # ---------------------------------------------------------------- reset
    def reset_stacked(
        self, generator: Optional[torch.Generator] = None, batch_shape: Tuple[int, ...] = ()
    ) -> Tuple[StackedObs, MPEState]:
        def uniform(shape, lo, hi):
            u = torch.rand(*batch_shape, *shape, generator=generator, device=self.device)
            return u * (hi - lo) + lo

        state = MPEState(
            agent_pos=uniform((self.num_agents, 2), -1.0, 1.0),
            agent_vel=torch.zeros(*batch_shape, self.num_agents, 2, device=self.device),
            landmark_pos=uniform((self.num_obs, 2), -0.9, 0.9),
            step=torch.zeros(batch_shape, dtype=torch.int32, device=self.device),
        )
        return self._observe(state), state

    # ----------------------------------------------------------------- step
    def step_stacked(
        self, state: MPEState, actions: torch.Tensor
    ) -> Tuple[StackedObs, MPEState, torch.Tensor, torch.Tensor, Dict]:
        """actions: [..., A] int (discrete) or [..., A, 2] float.  Returns
        stacked obs, the new state, rewards [..., A], done flags [..., A] and
        an empty info dict."""
        u = self._action_force(actions)
        p_force = u * self._accels[:, None]
        p_force = p_force + self._contact_forces(state)

        vel = state.agent_vel * (1.0 - DAMPING) + p_force * DT  # unit mass
        speed = torch.linalg.vector_norm(vel, dim=-1, keepdim=True)
        scale = torch.clamp(
            self._max_speeds[:, None] / torch.clamp(speed, min=1e-8), max=1.0
        )
        vel = vel * scale
        pos = state.agent_pos + vel * DT

        new_state = MPEState(
            agent_pos=pos,
            agent_vel=vel,
            landmark_pos=state.landmark_pos,
            step=state.step + 1,
        )
        rewards = self._rewards(new_state)
        done = (new_state.step >= self.max_steps)[..., None].expand(
            *new_state.step.shape, self.num_agents
        )
        return self._observe(new_state), new_state, rewards, done, {}

    # ------------------------------------------------------------- dynamics
    def _action_force(self, actions: torch.Tensor) -> torch.Tensor:
        if self.discrete_actions:
            return self._directions[actions.long()]
        return actions

    def _contact_forces(self, state: MPEState) -> torch.Tensor:
        """Soft-penetration contact forces among all collidable entities;
        only agents move, so only agent rows are returned."""
        ent_pos = torch.cat([state.agent_pos, state.landmark_pos], dim=-2)
        delta = ent_pos[..., :, None, :] - ent_pos[..., None, :, :]  # [..., N, N, 2]
        dist = torch.sqrt(torch.sum(delta * delta, dim=-1) + 1e-12)
        k = CONTACT_MARGIN
        x = -(dist - self._dist_min) / k
        # softplus via logaddexp(0, x): F.softplus switches to x above a
        # threshold and would not match the reference's smooth contact
        penetration = torch.logaddexp(torch.zeros_like(x), x) * k
        force_mag = CONTACT_FORCE * penetration / dist
        force = delta * force_mag[..., None]
        force = force * self._not_self[..., None]  # no self-force
        return torch.sum(force, dim=-2)[..., : self.num_agents, :]

    def _collision_matrix(self, state: MPEState) -> torch.Tensor:
        """[..., n_adv, n_good] bool: adversary i touching good agent j."""
        adv = state.agent_pos[..., : self.num_adversaries, :]
        good = state.agent_pos[..., self.num_adversaries :, :]
        delta = adv[..., :, None, :] - good[..., None, :, :]
        dist = torch.linalg.vector_norm(delta, dim=-1)
        return dist < (ADV_SIZE + GOOD_SIZE)

    def _rewards(self, state: MPEState) -> torch.Tensor:
        coll = self._collision_matrix(state).to(torch.float32)
        # every adversary gets +10 per colliding (adversary, good) pair; each
        # good agent -10 per adversary touching it
        n_pairs = torch.sum(coll, dim=(-2, -1))
        adv_rew = (COLLISION_REWARD * n_pairs)[..., None].expand(
            *n_pairs.shape, self.num_adversaries
        )
        good_rew = -COLLISION_REWARD * torch.sum(coll, dim=-2)
        # boundary penalty on good agents, per coordinate
        x = torch.abs(state.agent_pos[..., self.num_adversaries :, :])
        bound = torch.where(
            x < 0.9,
            torch.zeros_like(x),
            torch.where(
                x < 1.0, (x - 0.9) * 10.0, torch.clamp(torch.exp(2.0 * x - 2.0), max=10.0)
            ),
        )
        good_rew = good_rew - torch.sum(bound, dim=-1)
        return torch.cat([adv_rew, good_rew], dim=-1)

    # ---------------------------------------------------------- observation
    def _observe(self, state: MPEState) -> StackedObs:
        a, g, n = self.num_adversaries, self.num_good_agents, self.num_agents
        pos, vel = state.agent_pos, state.agent_vel
        lead = pos.shape[:-2]

        landmark_rel = state.landmark_pos[..., None, :, :] - pos[..., :, None, :]
        other_rel = pos[..., None, :, :] - pos[..., :, None, :]  # includes self
        other_rel = other_rel[..., self._other_rows, self._other_cols, :].reshape(
            *lead, n, n - 1, 2
        )
        good_vel = vel[..., a:, :]  # [..., G, 2]

        def build(lo, hi, include_all_good: bool):
            rows = hi - lo
            parts = [
                vel[..., lo:hi, :],
                pos[..., lo:hi, :],
                landmark_rel[..., lo:hi, :, :].reshape(*lead, rows, -1),
                other_rel[..., lo:hi, :, :].reshape(*lead, rows, -1),
            ]
            if include_all_good:
                gv = good_vel.reshape(*lead, 1, 2 * g).expand(*lead, rows, 2 * g)
            else:
                # good agent i sees the other good agents' velocities
                gv = good_vel[..., self._good_cols, :].reshape(*lead, g, (g - 1) * 2)
            parts.append(gv)
            return torch.cat(parts, dim=-1)

        return StackedObs(
            adversary=build(0, a, include_all_good=True),
            good=build(a, n, include_all_good=False),
        )


def tag_prey_rel_slice(num_obs: int, n_adv: int, n_good: int) -> slice:
    """Columns of an adversary's simple_tag observation that hold the
    relative prey positions, the subspace the tag reward reads:
    [self_vel(2), self_pos(2), landmark_rel(2L), other_adv_rel(2(n_adv-1)),
    prey_rel(2·n_good), good_vel...]."""
    off = 4 + 2 * num_obs + 2 * (n_adv - 1)
    return slice(off, off + 2 * n_good)


_REGISTRY = {"MPE_simple_tag_v3": SimpleTagEnv}
_NOT_PORTED = (
    "MPE_simple_spread_v3",
    "MPE_simple_world_comm_v3",
    "MPE_simple_adversary_v3",
)


def make(name: str, device="cuda", **kwargs):
    """Factory with the JAX package's surface; unknown keyword arguments
    are dropped, as there."""
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"env {name!r} is not ported to the PyTorch package yet (ROADMAP M14)"
        )
    if name not in _REGISTRY:
        raise ValueError(f"unknown env {name!r}; available: {sorted(_REGISTRY)}")
    cls = _REGISTRY[name]
    known = ("num_good_agents", "num_adversaries", "num_obs", "max_steps", "discrete_actions")
    return cls(device=device, **{k: v for k, v in kwargs.items() if k in known})
