"""Env wrappers: batched rollouts and episode-return logging (mirror of
``mfvae_tpu/envs/wrappers.py``).

``LogWrapper`` threads episode return/length accumulators through the
state and reports them in ``info``; ``BatchedEnv`` steps B worlds at once
over a leading batch axis and resets the finished ones with ``torch.where``.
The port's envs are batched over any leading axes already
(``envs/mpe.py``), so batching is ``reset_stacked(batch_shape=(B,))``
rather than a vmap.

Both have the stacked surface (class-tensor obs, rewards and dones [..., A])
and the JAX package's dict surface (obs, reward and done dicts keyed by
agent, ``"__all__"``), over the env's ``reset``/``step`` (``mpe.py``).  The
physics draws nothing, so only resets take a ``torch.Generator``;
``BatchedEnv.step`` also takes the reset states as an input (``reset=``),
which lets tests hand in the JAX package's own.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from mfvae_tpu_torch.data.buffer import tree_map


class LogState(NamedTuple):
    env_state: Any
    episode_return: torch.Tensor  # [..., A] running sum of per-agent rewards
    episode_length: torch.Tensor  # [...] int32
    returned_return: torch.Tensor  # [..., A] last completed episode's return
    returned_length: torch.Tensor  # [...] int32


def _inner_state(state):
    """The env's own state under any LogState wrapping."""
    while isinstance(state, LogState):
        state = state.env_state
    return state


def _stack_actions(env, state, actions) -> torch.Tensor:
    """An action dict (agent -> [...] or [..., d]) -> the stacked [..., A(, d)]."""
    if not isinstance(actions, dict):
        return actions
    lead = _inner_state(state).step.dim()
    return torch.stack([torch.as_tensor(actions[a], device=env.device) for a in env.agents], dim=lead)


def _dicts(env, obs, rewards, dones):
    rew = {a: rewards[..., i] for i, a in enumerate(env.agents)}
    done = {a: dones[..., i] for i, a in enumerate(env.agents)}
    done["__all__"] = torch.all(dones, dim=-1)
    return env._obs_dict(obs), rew, done


class LogWrapper:
    """Tracks per-agent episode returns; ``info`` carries
    ``returned_episode_returns`` [..., A], ``returned_episode_lengths`` and
    ``returned_episode`` at every step."""

    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset_stacked(self, generator: Optional[torch.Generator] = None, batch_shape=()):
        obs, env_state = self.env.reset_stacked(generator, batch_shape=tuple(batch_shape))
        dev = env_state.step.device
        zeros = torch.zeros(tuple(batch_shape) + (self.env.num_agents,), device=dev)
        length = torch.zeros(tuple(batch_shape), dtype=torch.int32, device=dev)
        return obs, LogState(env_state, zeros, length, zeros.clone(), length.clone())

    def step_stacked(self, state: LogState, actions: torch.Tensor):
        obs, env_state, rewards, dones, info = self.env.step_stacked(state.env_state, actions)
        new_return = state.episode_return + rewards
        new_length = state.episode_length + 1
        done_all = torch.all(dones, dim=-1)
        d = done_all[..., None]
        state = LogState(
            env_state=env_state,
            episode_return=torch.where(d, 0.0, new_return),
            episode_length=torch.where(done_all, 0, new_length).to(torch.int32),
            returned_return=torch.where(d, new_return, state.returned_return),
            returned_length=torch.where(done_all, new_length, state.returned_length).to(torch.int32),
        )
        info = dict(info)
        info["returned_episode_returns"] = state.returned_return
        info["returned_episode_lengths"] = state.returned_length
        info["returned_episode"] = done_all
        return obs, state, rewards, dones, info

    def reset(self, generator: Optional[torch.Generator] = None):
        obs, state = self.reset_stacked(generator)
        return self.env._obs_dict(obs), state

    def step(self, state: LogState, actions):
        obs, state, rewards, dones, info = self.step_stacked(state, _stack_actions(self.env, state, actions))
        obs_d, rew_d, done_d = _dicts(self.env, obs, rewards, dones)
        return obs_d, state, rew_d, done_d, info


class BatchedEnv:
    """B worlds stepped together over a leading [B] axis; ``step`` resets
    the finished ones in place, from ``generator`` or from the given
    ``reset`` = (obs, state) of a ``reset_stacked``."""

    def __init__(self, env, batch_size: int):
        self.env = env
        self.batch_size = batch_size

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset_stacked(self, generator: Optional[torch.Generator] = None):
        return self.env.reset_stacked(generator, batch_shape=(self.batch_size,))

    def step_stacked(self, generator: Optional[torch.Generator], states, actions: torch.Tensor, reset=None):
        """actions [B, A(, d)] -> (obs, states, rewards [B, A], dones [B, A],
        info), the done worlds already reset."""
        obs, st, rew, done, info = self.env.step_stacked(states, actions)
        obs_r, st_r = self.reset_stacked(generator) if reset is None else reset
        done_all = torch.all(done, dim=-1)

        def pick(new, old):
            return torch.where(done_all.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)

        return tree_map(pick, obs_r, obs), tree_map(pick, st_r, st), rew, done, info

    def reset(self, generator: Optional[torch.Generator] = None):
        obs, state = self.reset_stacked(generator)
        return self.env._obs_dict(obs), state

    def step(self, generator: Optional[torch.Generator], states, actions, reset=None):
        """actions: dict of [B, ...] per agent (or the stacked [B, A(, d)])."""
        actions = _stack_actions(self.env, states, actions)
        obs, st, rew, done, info = self.step_stacked(generator, states, actions, reset)
        obs_d, rew_d, done_d = _dicts(self.env, obs, rew, done)
        return obs_d, st, rew_d, done_d, info

