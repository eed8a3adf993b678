"""simple_tag in plain PyTorch: the MPE scenario the configurations run.

Written from the published scenario (PettingZoo MPE ``simple_tag_v3``,
the multi-agent particle environment of Lowe et al. 2017): unit-mass
particles, damping 0.25, dt 0.1, soft contact forces
``100 * 1e-3 * softplus(-(dist - dist_min) / 1e-3) / dist`` between every
pair of collidable entities, discrete actions mapped to the unit
directions (0 no-op, 1 -x, 2 +x, 3 -y, 4 +y) times each agent's
acceleration, speed capped per class.  Adversaries earn +10 for every
(adversary, good agent) pair in contact, each good agent -10 for every
adversary touching it, minus the boundary penalty per coordinate.

Observations, per agent: own velocity, own position, every landmark
relative to it, every other agent relative to it, and the good agents'
velocities (all of them for an adversary, the others' for a good agent).
Agents are ordered adversaries first.  The operation order follows the
scenario's arithmetic step by step, so on one device the same inputs give
the same numbers to the last bit wherever the program computes in the
same order.

Nothing here imports the program.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

DT = 0.1
DAMPING = 0.25
CONTACT_FORCE = 1e2
CONTACT_MARGIN = 1e-3
ADV_SIZE, GOOD_SIZE, LANDMARK_SIZE = 0.075, 0.05, 0.2
ADV_ACCEL, GOOD_ACCEL = 3.0, 4.0
ADV_MAX_SPEED, GOOD_MAX_SPEED = 1.0, 1.3
COLLISION_REWARD = 10.0
DIRECTIONS = ((0.0, 0.0), (-1.0, 0.0), (1.0, 0.0), (0.0, -1.0), (0.0, 1.0))
N_ACTIONS = len(DIRECTIONS)


class State(NamedTuple):
    pos: torch.Tensor  # [..., A, 2]
    vel: torch.Tensor  # [..., A, 2]
    landmarks: torch.Tensor  # [..., L, 2]
    step: torch.Tensor  # [...] int32


class SimpleTag:
    def __init__(self, n_adv: int, n_good: int, n_obs: int, max_steps: int, device):
        self.n_adv, self.n_good, self.n_obs = n_adv, n_good, n_obs
        self.n = n_adv + n_good
        self.max_steps = max_steps
        self.device = torch.device(device)

        def per_class(adv, good):
            return torch.tensor([adv] * n_adv + [good] * n_good, dtype=torch.float32, device=self.device)

        self.accel = per_class(ADV_ACCEL, GOOD_ACCEL)
        self.max_speed = per_class(ADV_MAX_SPEED, GOOD_MAX_SPEED)
        size = torch.cat([per_class(ADV_SIZE, GOOD_SIZE),
                          torch.full((n_obs,), LANDMARK_SIZE, device=self.device)])
        self.dist_min = size[:, None] + size[None, :]
        self.not_self = 1.0 - torch.eye(self.n + n_obs, device=self.device)
        self.directions = torch.tensor(DIRECTIONS, device=self.device)

    @property
    def obs_dims(self):
        base = 4 + 2 * self.n_obs + 2 * (self.n - 1)
        return (base + 2 * self.n_good,) * self.n_adv + (base + 2 * (self.n_good - 1),) * self.n_good

    def reset(self, generator: torch.Generator, lead=()):
        """Agents uniform in [-1, 1]², at rest; landmarks uniform in
        [-0.9, 0.9]²; drawn in that order."""
        def uniform(shape, lo, hi):
            u = torch.rand(*lead, *shape, generator=generator, device=self.device)
            return u * (hi - lo) + lo

        state = State(
            pos=uniform((self.n, 2), -1.0, 1.0),
            vel=torch.zeros(*lead, self.n, 2, device=self.device),
            landmarks=uniform((self.n_obs, 2), -0.9, 0.9),
            step=torch.zeros(lead, dtype=torch.int32, device=self.device),
        )
        return self.observe(state), state

    def step(self, state: State, actions: torch.Tensor):
        """actions [..., A] int -> (obs, state, rewards [..., A], done [..., A])."""
        force = self.directions[actions.long()] * self.accel[:, None]
        ent = torch.cat([state.pos, state.landmarks], dim=-2)
        delta = ent[..., :, None, :] - ent[..., None, :, :]
        dist = torch.sqrt(torch.sum(delta * delta, dim=-1) + 1e-12)
        x = -(dist - self.dist_min) / CONTACT_MARGIN
        penetration = torch.logaddexp(torch.zeros_like(x), x) * CONTACT_MARGIN
        magnitude = CONTACT_FORCE * penetration / dist
        contact = torch.sum(delta * magnitude[..., None] * self.not_self[..., None], dim=-2)
        force = force + contact[..., : self.n, :]
        vel = state.vel * (1.0 - DAMPING) + force * DT
        speed = torch.linalg.vector_norm(vel, dim=-1, keepdim=True)
        vel = vel * torch.clamp(self.max_speed[:, None] / torch.clamp(speed, min=1e-8), max=1.0)
        new = State(pos=state.pos + vel * DT, vel=vel, landmarks=state.landmarks, step=state.step + 1)
        done = (new.step >= self.max_steps)[..., None].expand(*new.step.shape, self.n)
        return self.observe(new), new, self.rewards(new), done

    def rewards(self, state: State) -> torch.Tensor:
        adv = state.pos[..., : self.n_adv, :]
        good = state.pos[..., self.n_adv:, :]
        gap = adv[..., :, None, :] - good[..., None, :, :]
        touch = (torch.linalg.vector_norm(gap, dim=-1) < (ADV_SIZE + GOOD_SIZE)).to(torch.float32)
        pairs = torch.sum(touch, dim=(-2, -1))
        adv_rew = (COLLISION_REWARD * pairs)[..., None].expand(*pairs.shape, self.n_adv)
        coord = torch.abs(good)
        bound = torch.where(coord < 0.9, torch.zeros_like(coord),
                            torch.where(coord < 1.0, (coord - 0.9) * 10.0,
                                        torch.clamp(torch.exp(2.0 * coord - 2.0), max=10.0)))
        good_rew = -COLLISION_REWARD * torch.sum(touch, dim=-2) - torch.sum(bound, dim=-1)
        return torch.cat([adv_rew, good_rew], dim=-1)

    def observe(self, state: State):
        """(adversary obs [..., n_adv, od_adv], good obs [..., n_good, od_good])."""
        pos, vel = state.pos, state.vel
        lead, n, g = pos.shape[:-2], self.n, self.n_good
        landmark_rel = state.landmarks[..., None, :, :] - pos[..., :, None, :]
        rel = pos[..., None, :, :] - pos[..., :, None, :]  # rel[i, j] = pos[j] - pos[i]
        keep = ~torch.eye(n, dtype=torch.bool, device=self.device)
        others = rel[..., keep, :].reshape(*lead, n, n - 1, 2)
        good_vel = vel[..., self.n_adv:, :]
        keep_g = ~torch.eye(g, dtype=torch.bool, device=self.device)

        def block(lo, hi, good_part):
            rows = hi - lo
            return torch.cat([
                vel[..., lo:hi, :], pos[..., lo:hi, :],
                landmark_rel[..., lo:hi, :, :].reshape(*lead, rows, -1),
                others[..., lo:hi, :, :].reshape(*lead, rows, -1),
                good_part,
            ], dim=-1)

        all_good = good_vel.reshape(*lead, 1, 2 * g).expand(*lead, self.n_adv, 2 * g)
        other_good = good_vel[..., None, :, :].expand(*lead, g, g, 2)[..., keep_g, :].reshape(*lead, g, 2 * (g - 1))
        return block(0, self.n_adv, all_good), block(self.n_adv, n, other_good)
