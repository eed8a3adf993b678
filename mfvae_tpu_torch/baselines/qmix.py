"""QMIX, the monotonic value-factorization baseline (mirror of
``mfvae_tpu/baselines/qmix.py``).

QMIX replaces VDN's sum with a state-conditioned monotonic mixer,

    Q_tot(s, u) = Mix(Q_1(o_1,u_1), ..., Q_N(o_N,u_N); s),

an MLP whose weights come from hypernetworks of the global state with
|W| >= 0, so dQ_tot/dQ_a >= 0 and the argmax decentralizes.  The global
state is the concatenation of every agent's packed observation.  The
recurrent agents, the replay, epsilon-greedy, double-Q targets and target
copies are ``baselines/vdn.py``'s machinery: the online module is
``QmixParams`` (agent + mixer) under one clip and one Adam, and the target
copies both.  As in the JAX package, QMIX keeps a constant learning rate,
runs no greedy test and logs nothing during training.
"""

from __future__ import annotations

import dataclasses
import sys
from dataclasses import dataclass

import torch
from torch import nn

from mfvae_tpu_torch.baselines import vdn as _vdn
from mfvae_tpu_torch.baselines.vdn import Timestep, VdnConfig, VdnNetwork, _pad_width
from mfvae_tpu_torch.envs.mpe import make as make_env
from mfvae_tpu_torch.models.layers import Dense
from mfvae_tpu_torch.training.experiment import resolve_device


@dataclass
class QmixConfig(VdnConfig):
    mixing_dim: int = 32
    hypernet_dim: int = 64


class MixingNetwork(nn.Module):
    """Two-layer monotonic mixer with abs-constrained hyper-weights; the
    leaves keep flax's names (``hyper_w1_h``, ``hyper_w1``, ``hyper_b1``,
    ``hyper_w2_h``, ``hyper_w2``, ``hyper_b2_h``, ``hyper_b2_out``)."""

    def __init__(self, n_agents: int, state_dim: int, mixing_dim: int = 32, hypernet_dim: int = 64, device=None,
                 generator=None):
        super().__init__()
        self.n_agents, self.mixing_dim = n_agents, mixing_dim
        n, m, h = n_agents, mixing_dim, hypernet_dim
        for name, i, o in (("hyper_w1_h", state_dim, h), ("hyper_w1", h, n * m), ("hyper_b1", state_dim, m),
                           ("hyper_w2_h", state_dim, h), ("hyper_w2", h, m), ("hyper_b2_h", state_dim, h),
                           ("hyper_b2_out", h, 1)):
            self.add_module(name, Dense(i, o, device=device, generator=generator))

    def forward(self, agent_qs, state):
        """agent_qs [..., N]; state [..., S] -> q_tot [...]."""
        n, m = self.n_agents, self.mixing_dim
        w1 = torch.abs(self.hyper_w1(torch.relu(self.hyper_w1_h(state)))).reshape(*state.shape[:-1], n, m)
        b1 = self.hyper_b1(state)
        w2 = torch.abs(self.hyper_w2(torch.relu(self.hyper_w2_h(state))))[..., None]  # [..., m, 1]
        b2 = self.hyper_b2_out(torch.relu(self.hyper_b2_h(state)))
        x = torch.einsum("...n,...nm->...m", agent_qs, w1) + b1
        hid = torch.where(x > 0, x, torch.expm1(x))  # jax.nn.elu
        q_tot = torch.einsum("...m,...mo->...o", hid, w2) + b2
        return q_tot[..., 0]


class QmixParams(nn.Module):
    """The online (or target) parameters: the agents' ``VdnNetwork`` and
    the mixer.  Its forward is the agents' (the rollout acts with them)."""

    def __init__(self, agent: VdnNetwork, mixer: MixingNetwork):
        super().__init__()
        self.agent, self.mixer = agent, mixer

    def forward(self, hidden, obs, done):
        return self.agent(hidden, obs, done)


def make_train(config: QmixConfig, env=None, device="cuda"):
    """QMIX training; the surface of ``baselines.vdn.make_train`` (the
    metrics have no ``test_return``)."""
    if env is None:
        env = make_env(
            config.env_name, device=resolve_device(device),
            num_good_agents=config.num_good_agents, num_adversaries=config.num_adversaries,
            num_obs=config.num_obs, max_steps=config.max_env_steps,
        )
    n_agents = env.num_agents
    d_in = _pad_width(env) + n_agents
    n_actions = env.action_space(env.agents[0]).n

    def params_fn(generator):
        agent = VdnNetwork(n_actions, n_agents, config.hidden_dim, config.param_share, in_dim=d_in,
                           generator=generator)
        mixer = MixingNetwork(n_agents, n_agents * d_in, config.mixing_dim, config.hypernet_dim,
                              generator=generator)
        return QmixParams(agent, mixer)

    def loss_fn_builder(apply, init_hidden, q_of_actions, cfg, n):
        def loss_fn(params: QmixParams, target_params: QmixParams, seq: Timestep):
            obs_t, act_t, rew_t, done_t = (x.transpose(0, 1) for x in seq)
            s = obs_t.shape[1]
            h0 = init_hidden(s)
            done_prev = torch.cat([torch.ones((1, s), dtype=torch.bool, device=done_t.device), done_t[:-1]], dim=0)
            _, q_online = params.agent(h0, obs_t, done_prev)
            chosen = q_of_actions(q_online, act_t)
            global_state = obs_t.reshape(obs_t.shape[0], s, -1)  # [L, S, N*D]
            q_tot = params.mixer(chosen, global_state)  # [L, S]
            with torch.no_grad():
                _, q_target = target_params.agent(h0, obs_t, done_prev)
                t_chosen = q_of_actions(q_target, torch.argmax(q_online, dim=-1))
                q_tot_target = target_params.mixer(t_chosen, global_state)
            not_done = 1.0 - done_t[:-1].to(torch.float32)
            targets = rew_t[:-1] + cfg.gamma * not_done * q_tot_target[1:]
            td = q_tot[:-1] - targets.detach()
            return torch.mean(td * td)

        return loss_fn

    # the JAX package's QMIX reads neither lr_linear_decay nor the logging
    # and test fields: a constant lr, no greedy test
    cfg = dataclasses.replace(config, lr_linear_decay=False)
    return _vdn.make_train(cfg, env, None, loss_fn_builder=loss_fn_builder, params_fn=params_fn,
                           greedy_test=False)


def main(config_path=None, device="cuda", **overrides):
    cfg = QmixConfig.from_yaml(config_path) if config_path else QmixConfig()
    for k, v in overrides.items():
        setattr(cfg, k, v)
    out = make_train(cfg, device=device)(cfg.seed)
    m = out["metrics"]
    print(f"final loss={m['loss'][-1]:.4f} mean_return={m['returned_episode_returns'][-1]:.2f}")
    return out


if __name__ == "__main__":
    _vdn.cli(sys.argv[1:], main)
