"""Grouped transition format (mirror of ``mfvae_tpu/data/transitions.py``)."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from mfvae_tpu_torch.models.mavae import AgentSpec, GroupedBatch, agent_order_concat


class GroupedTransition(NamedTuple):
    """One environment transition in grouped tensor form.

    obs[g], next_obs[g]: [A_g, obs_dim_g]; actions[g]: [A_g] int32 or
    [A_g, act_dim_g] float32;
    rewards: [n_agents] in agent order; done: scalar (any agent done)."""

    obs: Tuple[torch.Tensor, ...]
    actions: Tuple[torch.Tensor, ...]
    next_obs: Tuple[torch.Tensor, ...]
    rewards: torch.Tensor
    done: torch.Tensor


class VaeBatch(NamedTuple):
    """Model-ready training batch."""

    inputs: GroupedBatch  # obs + actions per group, [B, A_g, ...]
    next_state: torch.Tensor  # [B, sum(obs_dims)] agent-order concat
    rewards: torch.Tensor  # [B, n_agents]


def vae_batch_from_grouped(spec: AgentSpec, batch: GroupedTransition) -> VaeBatch:
    """Assemble a sampled batch (leaves with a leading [B] axis) into model
    inputs."""
    return VaeBatch(
        inputs=GroupedBatch(obs=batch.obs, actions=batch.actions),
        next_state=agent_order_concat(spec, batch.next_obs),
        rewards=batch.rewards,
    )
