"""Transition formats (mirror of ``mfvae_tpu/data/transitions.py``).

1. The grouped tensor format, the training path's: per-group stacked
   tensors (``GroupedTransition``, ``group_env_step``,
   ``vae_batch_from_grouped``).
2. The reference's flat keyed format: ``create_joint_transition`` and
   ``create_dataset`` keep its ``{agent}_obs/_act/_next_obs/_rew`` keys and
   its index-prepended ``idx_state`` dicts (jax_ver/jax_buffer.py:8-56,
   jax_ver/trainer.py:9-39), for reference-style code
   (``data/compat.py``).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

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


def group_env_step(
    spec: AgentSpec,
    obs: Dict[str, torch.Tensor],
    actions: Dict[str, torch.Tensor],
    rewards: Dict[str, torch.Tensor],
    next_obs: Dict[str, torch.Tensor],
    dones: Dict[str, torch.Tensor],
) -> GroupedTransition:
    """Pack per-agent env dicts into a GroupedTransition; ``done`` is
    ``dones["__all__"]`` where given, else the max over the agents'."""
    obs_g, act_g, next_g = [], [], []
    for _, idxs in spec.groups:
        names = [spec.agents[i] for i in idxs]
        obs_g.append(torch.stack([torch.as_tensor(obs[a]) for a in names], dim=0))
        act_g.append(torch.stack([torch.as_tensor(actions[a]) for a in names], dim=0))
        next_g.append(torch.stack([torch.as_tensor(next_obs[a]) for a in names], dim=0))
    rew = torch.stack([torch.as_tensor(rewards[a]) for a in spec.agents], dim=0).to(torch.float32)
    if "__all__" in dones:
        done = torch.as_tensor(dones["__all__"]).to(torch.float32)
    else:
        done = torch.amax(torch.stack([torch.as_tensor(dones[a]).to(torch.float32)
                                       for a in spec.agents if a in dones]))
    return GroupedTransition(obs=tuple(obs_g), actions=tuple(act_g), next_obs=tuple(next_g), rewards=rew, done=done)


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


# ---------------------------------------------------------------------------
# The reference's flat keyed format
# ---------------------------------------------------------------------------


def create_joint_transition(
    obs: Dict[str, Any],
    reward: Dict[str, Any],
    action: Dict[str, Any],
    next_obs: Dict[str, Any],
    done: Dict[str, Any],
) -> Optional[Dict[str, torch.Tensor]]:
    """Per-agent dicts -> ``{agent}_obs/_act/_next_obs/_rew`` keys, each
    reshaped to (-1, 1) as the reference does, plus the joint ``done``
    (the max over the agents).  None, with a message, when an agent is
    missing from any dict (jax_buffer.py:40-42)."""
    out: Dict[str, torch.Tensor] = {}
    any_done = torch.tensor(0.0)
    for agent_id in obs:
        if not (agent_id in reward and agent_id in action and agent_id in next_obs and agent_id in done):
            print(f"agent id {agent_id} missing from reward/action/next_obs/done")
            return None
        out[f"{agent_id}_obs"] = torch.as_tensor(obs[agent_id]).reshape(-1, 1)
        out[f"{agent_id}_act"] = torch.as_tensor(action[agent_id]).reshape(-1, 1)
        out[f"{agent_id}_next_obs"] = torch.as_tensor(next_obs[agent_id]).reshape(-1, 1)
        out[f"{agent_id}_rew"] = torch.as_tensor(reward[agent_id]).reshape(-1, 1)
        d = torch.as_tensor(done[agent_id]).to(torch.float32)
        any_done = torch.maximum(any_done.to(d.device), d)
    out["done"] = any_done.reshape(-1, 1)
    return out


def create_dataset(
    transition: Dict[str, torch.Tensor], codebook: Dict[str, int]
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """The reference's dataset assembly (jax_ver/trainer.py:9-39): per
    agent ``idx_state`` with the agent's index as column 0, the squeezed
    actions, and the agent-order rewards [B, A] and next states [B, Σobs]."""
    idx_state_all, action_all = {}, {}
    rewards_list, next_states_list = [], []
    for agent_id, agent_num in codebook.items():
        obs = transition[f"{agent_id}_obs"]  # [B, D, 1]
        b = obs.shape[0]
        obs2d = obs.reshape(b, -1)
        idx_col = torch.full((b, 1), float(agent_num), dtype=obs2d.dtype, device=obs2d.device)
        idx_state_all[agent_id] = torch.cat([idx_col, obs2d], dim=1)
        action_all[agent_id] = transition[f"{agent_id}_act"].reshape(b, -1).squeeze(-1)
        rewards_list.append(transition[f"{agent_id}_rew"].reshape(b, 1))
        next_states_list.append(transition[f"{agent_id}_next_obs"].reshape(b, -1))
    return idx_state_all, action_all, torch.cat(rewards_list, dim=1), torch.cat(next_states_list, dim=1)
