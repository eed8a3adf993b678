"""Dyna-style imagination: the world model generates Q-learning data
(mirror of ``mfvae_tpu/baselines/dyna.py``).

A trained MAVAE world model (``inference.WorldModel``) imagines H-step
windows from start states drawn out of the agent's REAL replay, the agent
acting epsilon-greedily with its CURRENT network inside the imagination;
the windows feed the same TD loss as real data through
``vdn.make_train``'s ``imagine_fn`` hook, made without grad.  Every step
runs ``WorldModel._predict`` (posterior-mean dynamics, ``mean_call``),
which launches none of the ELBO kernels.

The exploration draws are inputs: ``imagine(..., noise=EpsNoise)`` with
leaves [H+1, S, N], or drawn from the generator.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mfvae_tpu_torch.baselines.vdn import Timestep, VdnConfig, make_train, pack_grouped
from mfvae_tpu_torch.models.mavae import AgentSpec, GroupedBatch
from mfvae_tpu_torch.models.qlearning import EpsNoise, draw_eps_noise, eps_greedy


def _slot_plan(spec: AgentSpec) -> Tuple[Tuple[int, int], ...]:
    """agent index -> (group, position-in-group), agent order."""
    slot = {}
    for g, ((_, _), idxs) in enumerate(spec.groups):
        for pos, i in enumerate(idxs):
            slot[i] = (g, pos)
    return tuple(slot[i] for i in range(spec.n_agents))


def make_imagine_fn(wm, config: VdnConfig, *, horizon: int = 8, imagine_eps: float = 0.1):
    """``imagine(network, real_batch, generator=None, noise=None) ->
    Timestep [S, H+1]`` for ``vdn.make_train(imagine_fn=...)``.

    The start states are the first observation of each sampled real window
    (one imagined window per real one).  The agent acts with a fresh zero
    hidden state, as at a sampled window's start in the loss; the world
    model's posterior mean supplies the next observations and rewards;
    ``done`` is False throughout (the model predicts no termination).  The
    reward is ``reward_scale`` times the team sum of the model's per-agent
    rewards, as the real rollout stores it."""
    spec = wm.model.spec
    n_agents = spec.n_agents
    if not wm.model.discrete_act:
        raise ValueError("Dyna imagination needs a discrete-action world model")
    action_dim = spec.groups[0][0][1]  # groups carry (obs_dim, act_dim)
    device = wm.device
    eye = torch.eye(n_agents, device=device)
    group_idx = [torch.tensor(idxs, device=device) for _, idxs in spec.groups]
    group_od = [od for (od, _), _ in spec.groups]

    def unpack(obs_packed):
        """[S, N, D_pad+N] -> per-group [S, A_g, od] (drop pad + one-hot)."""
        return tuple(obs_packed.index_select(1, idx)[..., :od] for od, idx in zip(group_od, group_idx))

    def group_actions(actions):
        """[S, N] -> per-group [S, A_g]."""
        return tuple(actions.index_select(1, idx) for idx in group_idx)

    def draw_noise(generator: Optional[torch.Generator], s: int) -> EpsNoise:
        return draw_eps_noise(generator, (horizon + 1, s, n_agents), action_dim, device)

    def imagine(network, real_batch: Timestep, generator: Optional[torch.Generator] = None,
                noise: Optional[EpsNoise] = None) -> Timestep:
        obs_p = real_batch.obs[:, 0]  # [S, N, D]
        s = obs_p.shape[0]
        if noise is None:
            noise = draw_noise(generator, s)
        hidden = torch.zeros((s, n_agents, config.hidden_dim), device=device)
        # the first step of a window starts fresh (the loss's right-shifted
        # done convention)
        done_first = torch.ones((1, s), dtype=torch.bool, device=device)
        done_rest = torch.zeros((1, s), dtype=torch.bool, device=device)
        no_done = torch.zeros((s,), dtype=torch.bool, device=device)
        steps = []
        for t in range(horizon + 1):
            hidden, q = network(hidden, obs_p[None], done_first if t == 0 else done_rest)
            actions = eps_greedy(q[0], imagine_eps, noise=EpsNoise(noise.uniform[t], noise.random[t]))
            next_state, rewards = wm._predict(GroupedBatch(obs=unpack(obs_p), actions=group_actions(actions)))
            steps.append(Timestep(obs=obs_p, actions=actions, rewards=config.reward_scale * rewards.sum(dim=-1),
                                  done=no_done))
            obs_p = pack_grouped(spec, wm._state_to_grouped(next_state), eye)
        # [S, H+1, ...] batch-major windows, the layout the buffer samples
        return Timestep(*(torch.stack(xs, dim=1) for xs in zip(*steps)))

    imagine.draw_noise = draw_noise
    return imagine


def make_dyna_train(config: VdnConfig, wm, *, horizon: int = 8, imagine_weight: float = 1.0,
                    imagine_eps: float = 0.1, env=None, metrics_callback=None, device="cuda"):
    """``vdn.make_train`` with the world model in the loop."""
    imagine = make_imagine_fn(wm, config, horizon=horizon, imagine_eps=imagine_eps)
    return make_train(config, env=env, metrics_callback=metrics_callback, imagine_fn=imagine,
                      imagine_weight=imagine_weight, device=device)
