"""IQL (Independent Q-Learning), the per-agent Q baseline (mirror of
``mfvae_tpu/baselines/iql.py``).

Each agent optimizes its OWN reward with an independent TD target, no
joint factorization:

    L = mean_a mean_t ( Q_a(o_a, u_a) - [r_a + gamma * max Qbar_a] )^2

Everything else is ``baselines/vdn.py``'s, through its hooks: the stored
reward is the per-agent vector [N] (VDN stores the team sum), and targets
and TD errors keep the agent axis instead of summing Q over it.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Optional

import torch

from mfvae_tpu_torch.baselines import vdn as _vdn
from mfvae_tpu_torch.baselines.vdn import Timestep, VdnConfig, td_lambda_targets


@dataclass
class IqlConfig(VdnConfig):
    """Same fields as VdnConfig (reward_scale applies per agent)."""


def make_train(config: IqlConfig, env=None, metrics_callback=None, device="cuda"):
    """IQL training; the surface of ``baselines.vdn.make_train``."""

    def reward_fn(rew, agents):
        # each agent keeps its OWN reward: the whole point of IQL
        return config.reward_scale * rew

    def example_reward(n_agents):
        return torch.zeros((n_agents,))

    def loss_fn_builder(apply, init_hidden, q_of_actions, cfg, n_agents):
        def loss_fn(params, target_params, seq: Timestep):
            """Per-agent independent TD; seq leaves [S, L, ...]."""
            obs_t, act_t, rew_t, done_t = (x.transpose(0, 1) for x in seq)  # rew_t [L, S, N]
            s = obs_t.shape[1]
            h0 = init_hidden(s)
            done_prev = torch.cat([torch.ones((1, s), dtype=torch.bool, device=done_t.device), done_t[:-1]], dim=0)
            _, q_online = apply(params, h0, obs_t, done_prev)
            with torch.no_grad():
                _, q_target = apply(target_params, h0, obs_t, done_prev)
            chosen = q_of_actions(q_online, act_t)  # [L, S, N] throughout
            target_next = q_of_actions(q_target, torch.argmax(q_online, dim=-1))
            if cfg.td_lambda_loss:
                # the recursion is agnostic to trailing dims once done is
                # broadcast to the agent axis: flatten [S, N] -> rows
                L = rew_t.shape[0]
                done_n = done_t[:, :, None].expand(L, s, n_agents).reshape(L, -1)
                targets = td_lambda_targets(
                    rew_t[:-1].reshape(L - 1, -1), done_n, target_next[1:].reshape(L - 1, -1),
                    cfg.gamma, cfg.td_lambda,
                ).reshape(L - 1, s, n_agents)
            else:
                not_done = 1.0 - done_t[:-1].to(torch.float32)
                targets = rew_t[:-1] + cfg.gamma * not_done[..., None] * target_next[1:]
            td = chosen[:-1] - targets.detach()
            return torch.mean(td * td)

        return loss_fn

    return _vdn.make_train(
        config, env, metrics_callback, reward_fn=reward_fn, example_reward=example_reward,
        loss_fn_builder=loss_fn_builder, device=device,
    )


def main(config_path: Optional[str] = None, device="cuda", **overrides):
    """The CLI: ``vdn.main`` with the IQL config and training."""
    return _vdn.main(config_path, _config_cls=IqlConfig, _make_train=make_train, _tag="iql", device=device,
                     **overrides)


if __name__ == "__main__":
    _vdn.cli(sys.argv[1:], main)
