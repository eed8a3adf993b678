"""The flagship model and its inputs (counterpart of
``__graft_entry__._flagship`` and ``scripts/perf_matrix.py``
``flagship_batch``).

The reference population is simple_tag with 30 adversaries, 10 good
agents and 20 obstacles: 40 agents in two groups (obs 142 and 140, Σobs
5,660), 5 discrete actions each.  ``tiny=True`` keeps the population and
cuts the widths, as the JAX function does.

The inputs are numpy draws, bit-equal to the JAX package's:

- ``flagship``: ``default_rng(0)``, the obs of every group ([B, A_g,
  obs_g] standard normal), then the actions of every group (integers in
  [0, 5)), as ``_flagship`` draws them;
- ``bench_targets``: bench.py's ``next_state`` [B, Σobs] and ``rewards``
  [B, A] from the generator the caller passes (bench.py starts a second
  ``default_rng(0)`` for them, and its batch-scaling and unroll rows draw
  on from it);
- ``flagship_batch``: perf_matrix's one ``default_rng(0)`` for the obs,
  the actions, then ``next_state`` and ``rewards``.

The model's initial parameters come from a ``torch.Generator`` on the
model's device (``build_model``'s seed, 0 for the flagship); they are not
JAX's (threefry cannot be replayed), so tests load JAX's through
``models/convert.py``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from mfvae_tpu_torch.config import ModelConfig
from mfvae_tpu_torch.data.transitions import VaeBatch
from mfvae_tpu_torch.envs.mpe import SimpleTagEnv
from mfvae_tpu_torch.models.mavae import MAVAE, AgentSpec, GroupedBatch
from mfvae_tpu_torch.training.experiment import build_spec

# __graft_entry__._flagship's tiny widths
TINY = dict(
    idx_features=8,
    obs_features=8,
    action_features=8,
    encoder_hidden=(16,),
    action_encoder_hidden=(8,),
    decoder_hidden=(32, 32),
    compute_dtype="float32",
)
N_ACTIONS = 5


def flagship_spec(n_adv: int = 30, n_good: int = 10, n_obs: int = 20) -> AgentSpec:
    """simple_tag's agents and widths at this population (5 actions each)."""
    env = SimpleTagEnv(num_good_agents=n_good, num_adversaries=n_adv, num_obs=n_obs, device="cpu")
    return build_spec(env)


def tiny_config(mc: ModelConfig) -> ModelConfig:
    """``mc`` with the tiny widths (its other options kept)."""
    return dataclasses.replace(mc, **TINY)


def build_model(mc: ModelConfig, spec: AgentSpec, device, seed: int = 0) -> MAVAE:
    """The MAVAE of ``mc`` on ``device``, its parameters drawn from ``seed``."""
    dev = torch.device(device)
    return MAVAE.from_config(mc, spec, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))


def draw_grouped(rng: np.random.Generator, spec: AgentSpec, batch_size: int
                 ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """(obs, actions) per group, drawn as ``_flagship`` draws them: every
    group's float32 obs, then every group's int32 actions."""
    obs = [rng.normal(size=(batch_size, len(i), od)).astype(np.float32) for (od, _), i in spec.groups]
    act = [rng.integers(0, N_ACTIONS, size=(batch_size, len(i))).astype(np.int32) for _, i in spec.groups]
    return obs, act


def to_batch(obs, act, device) -> GroupedBatch:
    return GroupedBatch(
        obs=tuple(torch.from_numpy(o).to(device) for o in obs),
        actions=tuple(torch.from_numpy(a).to(device) for a in act),
    )


def flagship(batch_size: int = 128, n_adv: int = 30, n_good: int = 10, n_obs: int = 20,
             tiny: bool = False, device="cuda"):
    """(spec, model, inputs: GroupedBatch) on ``device``: the default
    ModelConfig, or its tiny widths."""
    spec = flagship_spec(n_adv, n_good, n_obs)
    model = build_model(tiny_config(ModelConfig()) if tiny else ModelConfig(), spec, device)
    obs, act = draw_grouped(np.random.default_rng(0), spec, batch_size)
    return spec, model, to_batch(obs, act, device)


def bench_targets(rng: np.random.Generator, spec: AgentSpec, inputs: GroupedBatch, device) -> VaeBatch:
    """``inputs`` with bench.py's float32 next_state [B, Σobs] and rewards
    [B, A], drawn from ``rng`` in that order."""
    b = inputs.obs[0].shape[0]
    next_state = rng.normal(size=(b, sum(spec.obs_dims))).astype(np.float32)
    rewards = rng.normal(size=(b, spec.n_agents)).astype(np.float32)
    return VaeBatch(inputs=inputs, next_state=torch.from_numpy(next_state).to(device),
                    rewards=torch.from_numpy(rewards).to(device))


def flagship_batch(spec: AgentSpec, batch: int, device) -> VaeBatch:
    """perf_matrix's batch: one ``default_rng(0)`` for the obs, the
    actions, the next state and the rewards."""
    rng = np.random.default_rng(0)
    obs, act = draw_grouped(rng, spec, batch)
    return bench_targets(rng, spec, to_batch(obs, act, device), device)
