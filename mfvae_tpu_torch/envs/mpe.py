"""The four MPE scenarios in PyTorch, on the run's device.

A port of ``mfvae_tpu/envs/mpe.py``: ``SimpleTagEnv``, ``SimpleSpreadEnv``,
``SimpleAdversaryEnv`` and ``SimpleWorldCommEnv`` with the same scenario
constants, integrators, observation layouts and rewards, vectorised over
entities (pairwise contact forces are one [N, N, 2] broadcast) and over any
leading batch axes of the state.  Each env has the stacked surface
(``reset_stacked``/``step_stacked``) and the JAX package's dict surface
(``reset``/``step``: obs and reward dicts keyed by agent, done flags with
``"__all__"``).  The physics is deterministic, so
``tests/test_torch_env.py`` and ``tests/test_torch_scenarios.py`` hold each
env against the JAX one by injecting one state into both.
"""

from __future__ import annotations

import inspect
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
# the MPE default sensitivity, for agents that carry no accel of their own
DEFAULT_ACCEL = 5.0
# 0 no-op, 1 -x, 2 +x, 3 -y, 4 +y
DISCRETE_DIRECTIONS = ((0.0, 0.0), (-1.0, 0.0), (1.0, 0.0), (0.0, -1.0), (0.0, 1.0))

SPREAD_AGENT_SIZE = 0.15
SPREAD_LANDMARK_SIZE = 0.05
ADVERSARY_AGENT_SIZE = 0.15
ADVERSARY_LANDMARK_SIZE = 0.08
GOOD_SIZE_WC = 0.045
FOOD_SIZE, FOREST_SIZE = 0.03, 0.3
WC_COLLISION_REWARD = 5.0
FOOD_REWARD = 2.0
BOUNDARY_EXIT_PENALTY = 10.0


class MPEState(NamedTuple):
    agent_pos: torch.Tensor  # [..., A, 2] adversaries first, then good agents
    agent_vel: torch.Tensor  # [..., A, 2]
    landmark_pos: torch.Tensor  # [..., L, 2]
    step: torch.Tensor  # [...] int32


class StackedObs(NamedTuple):
    adversary: torch.Tensor  # [..., n_adv, obs_dim_adv]
    good: torch.Tensor  # [..., n_good, obs_dim_good]


class SpreadObs(NamedTuple):
    agent: torch.Tensor  # [..., N, obs_dim]: one class of identical agents


class AdversaryState(NamedTuple):
    agent_pos: torch.Tensor  # [..., A, 2] the adversary first, then good agents
    agent_vel: torch.Tensor  # [..., A, 2]
    landmark_pos: torch.Tensor  # [..., L, 2]
    goal: torch.Tensor  # [...] int32 index of the goal landmark, drawn at reset
    step: torch.Tensor  # [...] int32


class WorldCommState(NamedTuple):
    agent_pos: torch.Tensor  # [..., A, 2] leader, adversaries, good agents
    agent_vel: torch.Tensor  # [..., A, 2]
    landmark_pos: torch.Tensor  # [..., E, 2] obstacles, food, forests
    leader_comm: torch.Tensor  # [..., C] the leader's broadcast channel
    step: torch.Tensor  # [...] int32


class WorldCommObs(NamedTuple):
    lead: torch.Tensor  # [..., 1, obs_dim_lead]
    adversary: torch.Tensor  # [..., n_adv - 1, obs_dim_adv]
    good: torch.Tensor  # [..., n_good, obs_dim_good]


def _off_diagonal(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, cols) of every off-diagonal entry of an n×n grid, row-major."""
    return torch.nonzero(~torch.eye(n, dtype=torch.bool, device=device), as_tuple=True)


def _per_class(n_adv: int, n_good: int, adv: float, good: float, device) -> torch.Tensor:
    return torch.tensor([adv] * n_adv + [good] * n_good, dtype=torch.float32, device=device)


def _soft_contact(ent_pos: torch.Tensor, dist_min, not_self: torch.Tensor) -> torch.Tensor:
    """Soft-penetration contact force on every entity of ``ent_pos``
    [..., N, 2] from all the others, summed: [..., N, 2]."""
    delta = ent_pos[..., :, None, :] - ent_pos[..., None, :, :]  # [..., N, N, 2]
    dist = torch.sqrt(torch.sum(delta * delta, dim=-1) + 1e-12)
    k = CONTACT_MARGIN
    x = -(dist - dist_min) / k
    # softplus via logaddexp(0, x): F.softplus switches to x above a
    # threshold and would not match the reference's smooth contact
    penetration = torch.logaddexp(torch.zeros_like(x), x) * k
    force_mag = CONTACT_FORCE * penetration / dist
    force = delta * force_mag[..., None]
    force = force * not_self[..., None]  # no self-force
    return torch.sum(force, dim=-2)


def _bound(x: torch.Tensor) -> torch.Tensor:
    """The MPE boundary penalty of |coordinate| ``x``, per coordinate."""
    return torch.where(
        x < 0.9,
        torch.zeros_like(x),
        torch.where(x < 1.0, (x - 0.9) * 10.0, torch.clamp(torch.exp(2.0 * x - 2.0), max=10.0)),
    )


def _speed_capped(vel: torch.Tensor, max_speeds: torch.Tensor) -> torch.Tensor:
    speed = torch.linalg.vector_norm(vel, dim=-1, keepdim=True)
    return vel * torch.clamp(max_speeds[:, None] / torch.clamp(speed, min=1e-8), max=1.0)


def _pairwise_rel(pos: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """[..., N, N-1, 2]: each agent's view of every other agent (self
    dropped), pos[j] - pos[i] in row-major order of the others."""
    n = pos.shape[-2]
    rel = pos[..., None, :, :] - pos[..., :, None, :]  # includes self
    return rel[..., rows, cols, :].reshape(*pos.shape[:-2], n, n - 1, 2)


class _MPEEnv:
    """What every scenario shares: the device, the discrete direction map
    and the dict surface over ``reset_stacked``/``step_stacked``."""

    def __init__(self, max_steps: int, discrete_actions: bool, device):
        self.max_steps = max_steps
        self.discrete_actions = discrete_actions
        self.device = torch.device(device)
        self._directions = torch.tensor(DISCRETE_DIRECTIONS, device=self.device)

    def action_space(self, agent: str):
        if self.discrete_actions:
            return Discrete(5)
        return Box(-1.0, 1.0, (2,))

    def observation_space(self, agent: str):
        return Box(-math.inf, math.inf, (self.obs_dim(agent),))

    def _action_force(self, actions: torch.Tensor) -> torch.Tensor:
        if self.discrete_actions:
            return self._directions[actions.long()]
        return actions

    def _reset_fields(self, generator, batch_shape, n_landmarks: int) -> dict:
        """The draws every scenario's reset shares, in one order: agents
        uniform in [-1, 1]², at rest; landmarks uniform in [-0.9, 0.9]²."""

        def uniform(shape, lo, hi):
            u = torch.rand(*batch_shape, *shape, generator=generator, device=self.device)
            return u * (hi - lo) + lo

        return dict(
            agent_pos=uniform((self.num_agents, 2), -1.0, 1.0),
            agent_vel=torch.zeros(*batch_shape, self.num_agents, 2, device=self.device),
            landmark_pos=uniform((n_landmarks, 2), -0.9, 0.9),
            step=torch.zeros(batch_shape, dtype=torch.int32, device=self.device),
        )

    def _done(self, step: torch.Tensor) -> torch.Tensor:
        return (step >= self.max_steps)[..., None].expand(*step.shape, self.num_agents)

    # --------------------------------------------------------- dict surface
    def _obs_dict(self, obs) -> Dict[str, torch.Tensor]:
        """Agent name -> its observation; the class tensors hold the agents
        in ``self.agents`` order, class after class."""
        names = iter(self.agents)
        return {next(names): t[..., i, :] for t in obs for i in range(t.shape[-2])}

    def reset(self, generator: Optional[torch.Generator] = None):
        obs, state = self.reset_stacked(generator)
        return self._obs_dict(obs), state

    def step(self, state, actions: Dict[str, torch.Tensor]):
        """actions: agent name -> its action ([...] int or [..., 2] float
        over the state's leading axes).  Returns (obs dict, state, reward
        dict, done dict with "__all__", info)."""
        lead = state.step.dim()
        act = torch.stack([torch.as_tensor(actions[a], device=self.device) for a in self.agents], dim=lead)
        obs, new_state, rewards, done, info = self.step_stacked(state, act)
        rew_d = {a: rewards[..., i] for i, a in enumerate(self.agents)}
        done_d = {a: done[..., i] for i, a in enumerate(self.agents)}
        done_d["__all__"] = torch.all(done, dim=-1)
        return self._obs_dict(obs), new_state, rew_d, done_d, info


class SimpleTagEnv(_MPEEnv):
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
        super().__init__(max_steps, discrete_actions, device)
        self.num_good_agents = num_good_agents
        self.num_adversaries = num_adversaries
        self.num_obs = num_obs
        a, g, n = num_adversaries, num_good_agents, self.num_agents
        self._sizes = _per_class(a, g, ADV_SIZE, GOOD_SIZE, self.device)
        self._accels = _per_class(a, g, ADV_ACCEL, GOOD_ACCEL, self.device)
        self._max_speeds = _per_class(a, g, ADV_MAX_SPEED, GOOD_MAX_SPEED, self.device)
        ent_size = torch.cat(
            [self._sizes, torch.full((num_obs,), LANDMARK_SIZE, device=self.device)]
        )
        self._dist_min = ent_size[:, None] + ent_size[None, :]
        self._not_self = 1.0 - torch.eye(n + num_obs, device=self.device)
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

    # ---------------------------------------------------------------- reset
    def reset_stacked(
        self, generator: Optional[torch.Generator] = None, batch_shape: Tuple[int, ...] = ()
    ) -> Tuple[StackedObs, MPEState]:
        state = MPEState(**self._reset_fields(generator, batch_shape, self.num_obs))
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
        vel = _speed_capped(vel, self._max_speeds)
        pos = state.agent_pos + vel * DT

        new_state = MPEState(
            agent_pos=pos,
            agent_vel=vel,
            landmark_pos=state.landmark_pos,
            step=state.step + 1,
        )
        rewards = self._rewards(new_state)
        return self._observe(new_state), new_state, rewards, self._done(new_state.step), {}

    # ------------------------------------------------------------- dynamics
    def _contact_forces(self, state: MPEState) -> torch.Tensor:
        """Contact forces among all collidable entities; only agents move,
        so only agent rows are returned."""
        ent_pos = torch.cat([state.agent_pos, state.landmark_pos], dim=-2)
        return _soft_contact(ent_pos, self._dist_min, self._not_self)[..., : self.num_agents, :]

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
        bound = _bound(torch.abs(state.agent_pos[..., self.num_adversaries :, :]))
        good_rew = good_rew - torch.sum(bound, dim=-1)
        return torch.cat([adv_rew, good_rew], dim=-1)

    # ---------------------------------------------------------- observation
    def _observe(self, state: MPEState) -> StackedObs:
        a, g, n = self.num_adversaries, self.num_good_agents, self.num_agents
        pos, vel = state.agent_pos, state.agent_vel
        lead = pos.shape[:-2]

        landmark_rel = state.landmark_pos[..., None, :, :] - pos[..., :, None, :]
        other_rel = _pairwise_rel(pos, self._other_rows, self._other_cols)
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


class SimpleSpreadEnv(_MPEEnv):
    """Cooperative simple_spread: N agents (size .15, collidable) cover N
    landmarks (.05, not collidable).  Shared reward -Σ_l min_a dist(a, l),
    and -1 per other agent in contact; accel 5.0, no speed cap; obs
    [self_vel, self_pos, landmark_rel, other_rel, comm (zeros)]."""

    def __init__(self, num_agents: int = 3, max_steps: int = 25, discrete_actions: bool = True,
                 device="cuda"):
        super().__init__(max_steps, discrete_actions, device)
        self.num_agents = num_agents
        n = num_agents
        self._not_self = 1.0 - torch.eye(n, device=self.device)
        self._eye_far = torch.eye(n, device=self.device) * 1e9
        self._other_rows, self._other_cols = _off_diagonal(n, self.device)

    @property
    def agents(self) -> Tuple[str, ...]:
        return tuple(f"agent_{i}" for i in range(self.num_agents))

    @property
    def num_landmarks(self) -> int:
        return self.num_agents

    def obs_dim(self, adversary=False) -> int:
        # every agent alike: self_vel(2) + self_pos(2) + landmark_rel(2n) +
        # other_rel(2(n-1)) + comm(2(n-1))
        n = self.num_agents
        return 4 + 2 * n + 4 * (n - 1)

    def reset_stacked(
        self, generator: Optional[torch.Generator] = None, batch_shape: Tuple[int, ...] = ()
    ) -> Tuple[SpreadObs, MPEState]:
        state = MPEState(**self._reset_fields(generator, batch_shape, self.num_landmarks))
        return self._observe(state), state

    def step_stacked(self, state: MPEState, actions: torch.Tensor):
        u = self._action_force(actions)
        # landmarks do not collide in spread: contacts among agents only
        p_force = u * DEFAULT_ACCEL + _soft_contact(state.agent_pos, 2 * SPREAD_AGENT_SIZE, self._not_self)
        vel = state.agent_vel * (1.0 - DAMPING) + p_force * DT
        pos = state.agent_pos + vel * DT
        new_state = MPEState(pos, vel, state.landmark_pos, state.step + 1)
        rewards = self._rewards(new_state)
        return self._observe(new_state), new_state, rewards, self._done(new_state.step), {}

    def _rewards(self, state: MPEState) -> torch.Tensor:
        pos = state.agent_pos
        d = torch.linalg.vector_norm(state.landmark_pos[..., :, None, :] - pos[..., None, :, :], dim=-1)
        coverage = -torch.sum(torch.amin(d, dim=-1), dim=-1)  # [...]
        dist = torch.linalg.vector_norm(pos[..., :, None, :] - pos[..., None, :, :], dim=-1) + self._eye_far
        coll = torch.sum(dist < 2 * SPREAD_AGENT_SIZE, dim=-1).to(torch.float32)
        return coverage[..., None] - coll

    def _observe(self, state: MPEState) -> SpreadObs:
        pos, vel = state.agent_pos, state.agent_vel
        landmark_rel = state.landmark_pos[..., None, :, :] - pos[..., :, None, :]
        other_rel = _pairwise_rel(pos, self._other_rows, self._other_cols)
        comm = torch.zeros(*pos.shape[:-1], 2 * (self.num_agents - 1), device=self.device)
        return SpreadObs(agent=torch.cat(
            [vel, pos, landmark_rel.flatten(-2), other_rel.flatten(-2), comm], dim=-1
        ))


class SimpleAdversaryEnv(_MPEEnv):
    """simple_adversary (physical deception): 1 adversary + N good agents
    + N landmarks, one of them the goal, drawn at reset.  No contact forces,
    accel 5.0, no speed cap.  Rewards: the adversary -dist(adversary, goal);
    every good agent -min_i dist(good_i, goal) + dist(adversary, goal).
    Obs (the adversary first): good [goal_rel, landmark_rel, other_rel];
    adversary [landmark_rel, other_rel]: it does not see the goal."""

    num_adversaries = 1

    def __init__(self, num_good_agents: int = 2, max_steps: int = 25, discrete_actions: bool = True,
                 device="cuda"):
        super().__init__(max_steps, discrete_actions, device)
        self.num_good_agents = num_good_agents
        self._other_rows, self._other_cols = _off_diagonal(self.num_agents, self.device)

    @property
    def num_agents(self) -> int:
        return self.num_good_agents + 1

    @property
    def num_landmarks(self) -> int:
        return self.num_good_agents

    @property
    def agents(self) -> Tuple[str, ...]:
        return ("adversary_0",) + tuple(f"agent_{i}" for i in range(self.num_good_agents))

    def obs_dim(self, adversary) -> int:
        if isinstance(adversary, str):
            adversary = adversary.startswith("adversary")
        base = 2 * self.num_landmarks + 2 * (self.num_agents - 1)
        return base if adversary else base + 2

    def reset_stacked(
        self, generator: Optional[torch.Generator] = None, batch_shape: Tuple[int, ...] = ()
    ) -> Tuple[StackedObs, AdversaryState]:
        fields = self._reset_fields(generator, batch_shape, self.num_landmarks)
        goal = torch.randint(0, self.num_landmarks, batch_shape, generator=generator, device=self.device,
                             dtype=torch.int32)
        state = AdversaryState(goal=goal, **fields)
        return self._observe(state), state

    def step_stacked(self, state: AdversaryState, actions: torch.Tensor):
        u = self._action_force(actions)
        # collide=False for every entity of this scenario: pure kinematics
        vel = state.agent_vel * (1.0 - DAMPING) + u * DEFAULT_ACCEL * DT
        pos = state.agent_pos + vel * DT
        new_state = state._replace(agent_pos=pos, agent_vel=vel, step=state.step + 1)
        rewards = self._rewards(new_state)
        return self._observe(new_state), new_state, rewards, self._done(new_state.step), {}

    @staticmethod
    def goal_pos(state: AdversaryState) -> torch.Tensor:
        """[..., 1, 2]: the goal landmark's position."""
        idx = state.goal.long()[..., None, None].expand(*state.goal.shape, 1, 2)
        return torch.gather(state.landmark_pos, -2, idx)

    def _rewards(self, state: AdversaryState) -> torch.Tensor:
        d = torch.linalg.vector_norm(state.agent_pos - self.goal_pos(state), dim=-1)  # [..., A]
        adv_d = d[..., :1]
        good_rew = -torch.amin(d[..., 1:], dim=-1, keepdim=True) + adv_d  # shared
        return torch.cat([-adv_d, good_rew.expand(*d.shape[:-1], self.num_good_agents)], dim=-1)

    def _observe(self, state: AdversaryState) -> StackedObs:
        pos = state.agent_pos
        landmark_rel = (state.landmark_pos[..., None, :, :] - pos[..., :, None, :]).flatten(-2)
        other_rel = _pairwise_rel(pos, self._other_rows, self._other_cols).flatten(-2)
        goal_rel = self.goal_pos(state) - pos  # [..., A, 2]
        adv = torch.cat([landmark_rel[..., :1, :], other_rel[..., :1, :]], dim=-1)
        good = torch.cat([goal_rel[..., 1:, :], landmark_rel[..., 1:, :], other_rel[..., 1:, :]], dim=-1)
        return StackedObs(adversary=adv, good=good)


class SimpleWorldCommEnv(_MPEEnv):
    """simple_world_comm: adversaries (index 0 the leader, the only agent
    with a channel: dim_c; size .075, accel 3.0, max speed 1.0), good agents
    (.045, 4.0, 1.3), collidable obstacles (.2), food (.03; +2 to a good
    agent touching it) and forests (.3) that hide their occupants from
    everyone outside the same forest except the leader.  Rewards:
    adversaries +5 per colliding (adversary, good) pair minus 0.1 × their
    own distance to the nearest prey; good agents -5 per adversary touching
    them, -2 × bound per coordinate, +2 per food touched and the published
    +0.05 × distance to the nearest food; everyone -10 while outside the
    unit box.

    Discrete actions only: Discrete(5) moves, and the leader's
    Discrete(5 · dim_c) splits as move = a % 5 and comm = a // 5."""

    def __init__(
        self,
        num_good_agents: int = 2,
        num_adversaries: int = 4,
        num_obs: int = 1,
        num_food: int = 2,
        num_forests: int = 2,
        dim_c: int = 4,
        max_steps: int = 25,
        discrete_actions: bool = True,
        device="cuda",
    ):
        super().__init__(max_steps, discrete_actions, device)
        self.num_good_agents = num_good_agents
        self.num_adversaries = num_adversaries  # the leader included
        self.num_obs = num_obs
        self.num_food = num_food
        self.num_forests = num_forests
        self.dim_c = dim_c
        a, g, n = num_adversaries, num_good_agents, self.num_agents
        self._sizes = _per_class(a, g, ADV_SIZE, GOOD_SIZE_WC, self.device)
        self._accels = _per_class(a, g, ADV_ACCEL, GOOD_ACCEL, self.device)
        self._max_speeds = _per_class(a, g, ADV_MAX_SPEED, GOOD_MAX_SPEED, self.device)
        ent_size = torch.cat([self._sizes, torch.full((num_obs,), LANDMARK_SIZE, device=self.device)])
        self._dist_min = ent_size[:, None] + ent_size[None, :]
        self._not_self = 1.0 - torch.eye(n + num_obs, device=self.device)
        self._forest_reach = self._sizes[:, None] + FOREST_SIZE
        self._leader_row = torch.zeros(n, n, dtype=torch.bool, device=self.device)
        self._leader_row[0] = True  # the leader sees everyone
        self._other_rows, self._other_cols = _off_diagonal(n, self.device)
        self._good_rows, self._good_cols = _off_diagonal(g, self.device)

    @property
    def agents(self) -> Tuple[str, ...]:
        return (
            ("leadadversary_0",)
            + tuple(f"adversary_{i}" for i in range(self.num_adversaries - 1))
            + tuple(f"agent_{i}" for i in range(self.num_good_agents))
        )

    @property
    def num_agents(self) -> int:
        return self.num_adversaries + self.num_good_agents

    @property
    def num_landmarks(self) -> int:
        return self.num_obs + self.num_food + self.num_forests

    # landmark layout inside landmark_pos: [obstacles | food | forests]
    @property
    def _food_slice(self) -> slice:
        return slice(self.num_obs, self.num_obs + self.num_food)

    @property
    def _forest_slice(self) -> slice:
        return slice(self.num_obs + self.num_food, self.num_landmarks)

    def obs_dim(self, agent: str) -> int:
        e, a, g = self.num_landmarks, self.num_agents, self.num_good_agents
        base = 4 + 2 * e + 2 * (a - 1)
        if agent.startswith("leadadversary"):
            return base + 2 * g + self.num_forests + self.dim_c
        if agent.startswith("adversary"):
            return base + 2 * g + g + self.dim_c
        return base + 2 * (g - 1) + self.num_forests

    def action_space(self, agent: str):
        if not self.discrete_actions:
            raise ValueError("simple_world_comm supports discrete actions only")
        if agent.startswith("leadadversary"):
            return Discrete(5 * self.dim_c)  # move x comm
        return Discrete(5)

    # ---------------------------------------------------------------- reset
    def reset_stacked(
        self, generator: Optional[torch.Generator] = None, batch_shape: Tuple[int, ...] = ()
    ) -> Tuple[WorldCommObs, WorldCommState]:
        comm = torch.zeros(*batch_shape, self.dim_c, device=self.device)
        state = WorldCommState(leader_comm=comm, **self._reset_fields(generator, batch_shape, self.num_landmarks))
        return self._observe(state), state

    # ----------------------------------------------------------------- step
    def step_stacked(self, state: WorldCommState, actions: torch.Tensor):
        """actions: [..., A] int; the leader's entry in [0, 5·dim_c), the
        rest in [0, 5)."""
        u = self._directions[(actions % 5).long()]
        p_force = u * self._accels[:, None] + self._contact_forces(state)
        vel = state.agent_vel * (1.0 - DAMPING) + p_force * DT
        vel = _speed_capped(vel, self._max_speeds)
        pos = state.agent_pos + vel * DT
        comm_idx = torch.clamp(actions[..., 0] // 5, 0, self.dim_c - 1)
        leader_comm = torch.nn.functional.one_hot(comm_idx.long(), self.dim_c).to(torch.float32)
        new_state = WorldCommState(pos, vel, state.landmark_pos, leader_comm, state.step + 1)
        rewards = self._rewards(new_state)
        return self._observe(new_state), new_state, rewards, self._done(new_state.step), {}

    def _contact_forces(self, state: WorldCommState) -> torch.Tensor:
        """Agents and obstacles collide; food and forests pass through."""
        ent_pos = torch.cat([state.agent_pos, state.landmark_pos[..., : self.num_obs, :]], dim=-2)
        return _soft_contact(ent_pos, self._dist_min, self._not_self)[..., : self.num_agents, :]

    def _rewards(self, state: WorldCommState) -> torch.Tensor:
        a = self.num_adversaries
        adv_pos, good_pos = state.agent_pos[..., :a, :], state.agent_pos[..., a:, :]
        d_ag = torch.linalg.vector_norm(adv_pos[..., :, None, :] - good_pos[..., None, :, :], dim=-1)
        coll = d_ag < (ADV_SIZE + GOOD_SIZE_WC)  # [..., n_adv, n_good]
        # every adversary gets the team's collision total, minus its own
        # shaping term
        n_pairs = torch.sum(coll, dim=(-2, -1))[..., None]
        adv_rew = WC_COLLISION_REWARD * n_pairs - 0.1 * torch.amin(d_ag, dim=-1)
        good_rew = -WC_COLLISION_REWARD * torch.sum(coll, dim=-2).to(torch.float32)
        good_rew = good_rew - 2.0 * torch.sum(_bound(torch.abs(good_pos)), dim=-1)
        food_pos = state.landmark_pos[..., self._food_slice, :]
        d_food = torch.linalg.vector_norm(good_pos[..., :, None, :] - food_pos[..., None, :, :], dim=-1)
        good_rew = good_rew + FOOD_REWARD * torch.sum(d_food < (GOOD_SIZE_WC + FOOD_SIZE), dim=-1)
        # the published sign: +0.05 × distance to the nearest food
        good_rew = good_rew + 0.05 * torch.amin(d_food, dim=-1)
        rewards = torch.cat([adv_rew, good_rew], dim=-1)
        outside = torch.any(torch.abs(state.agent_pos) > 1.0, dim=-1)
        return rewards - BOUNDARY_EXIT_PENALTY * outside.to(torch.float32)

    # ---------------------------------------------------------- observation
    def _forest_membership(self, state: WorldCommState) -> torch.Tensor:
        """[..., A, n_forests] bool: the agent's disc touches the forest's."""
        forest_pos = state.landmark_pos[..., self._forest_slice, :]
        d = torch.linalg.vector_norm(state.agent_pos[..., :, None, :] - forest_pos[..., None, :, :], dim=-1)
        return d < self._forest_reach

    def _observe(self, state: WorldCommState) -> WorldCommObs:
        a, g, n = self.num_adversaries, self.num_good_agents, self.num_agents
        pos, vel = state.agent_pos, state.agent_vel
        lead = pos.shape[:-2]
        entity_rel = (state.landmark_pos[..., None, :, :] - pos[..., :, None, :]).flatten(-2)

        in_f = self._forest_membership(state)
        in_any = torch.any(in_f, dim=-1)  # [..., A]
        # j is visible to observer i in the same forest, when both are
        # outside every forest, or to the leader
        same_forest = torch.any(in_f[..., :, None, :] & in_f[..., None, :, :], dim=-1)
        both_out = (~in_any)[..., :, None] & (~in_any)[..., None, :]
        visf = (same_forest | both_out | self._leader_row).to(torch.float32)

        other_rel = (pos[..., None, :, :] - pos[..., :, None, :]) * visf[..., None]
        other_rel = other_rel[..., self._other_rows, self._other_cols, :].reshape(*lead, n, 2 * (n - 1))
        good_vel_seen = vel[..., None, a:, :] * visf[..., :, a:, None]  # [..., A, G, 2]

        def pm(b):  # the published 1 / -1 encoding
            return torch.where(b, 1.0, -1.0)

        def tile(v, count):
            return v[..., None, :].expand(*lead, count, v.shape[-1])

        comm = state.leader_comm

        def rows(lo, hi):
            return [vel[..., lo:hi, :], pos[..., lo:hi, :], entity_rel[..., lo:hi, :], other_rel[..., lo:hi, :]]

        # leader: per-forest prey flag, own channel
        lead_obs = torch.cat(rows(0, 1) + [
            good_vel_seen[..., 0:1, :, :].flatten(-2),
            tile(pm(torch.any(in_f[..., a:, :], dim=-2)), 1),
            tile(comm, 1),
        ], dim=-1)
        # the other adversaries: per-prey forest flag
        adv = torch.cat(rows(1, a) + [
            good_vel_seen[..., 1:a, :, :].flatten(-2),
            tile(pm(in_any[..., a:]), a - 1),
            tile(comm, a - 1),
        ], dim=-1)
        # good agents: own forest flags, the other good agents' velocities
        gv, gp, ge, go = rows(a, n)
        gv_others = good_vel_seen[..., a:, :, :][..., self._good_rows, self._good_cols, :]
        good = torch.cat([gv, gp, ge, pm(in_f[..., a:, :]), go, gv_others.reshape(*lead, g, 2 * (g - 1))], dim=-1)
        return WorldCommObs(lead=lead_obs, adversary=adv, good=good)


def tag_prey_rel_slice(num_obs: int, n_adv: int, n_good: int) -> slice:
    """Columns of an adversary's simple_tag observation that hold the
    relative prey positions, the subspace the tag reward reads:
    [self_vel(2), self_pos(2), landmark_rel(2L), other_adv_rel(2(n_adv-1)),
    prey_rel(2·n_good), good_vel...]."""
    off = 4 + 2 * num_obs + 2 * (n_adv - 1)
    return slice(off, off + 2 * n_good)


_REGISTRY = {
    "MPE_simple_tag_v3": SimpleTagEnv,
    "MPE_simple_spread_v3": SimpleSpreadEnv,
    "MPE_simple_world_comm_v3": SimpleWorldCommEnv,
    "MPE_simple_adversary_v3": SimpleAdversaryEnv,
}

# population kwargs renamed per env (callers pass num_good_agents,
# num_adversaries and num_obs to every env)
_KWARG_MAP = {
    "MPE_simple_spread_v3": {"num_good_agents": "num_agents"},
}


def make(name: str, device="cuda", **kwargs):
    """Factory with the JAX package's surface: population kwargs are
    renamed by ``_KWARG_MAP``, and the ones the env does not take are
    dropped, as there."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown env {name!r}; available: {sorted(_REGISTRY)}")
    cls = _REGISTRY[name]
    remap = _KWARG_MAP.get(name, {})
    known = set(inspect.signature(cls).parameters) - {"device"}
    clean = {remap.get(k, k): v for k, v in kwargs.items() if remap.get(k, k) in known}
    return cls(device=device, **clean)
