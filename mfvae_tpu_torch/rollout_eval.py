"""Open-loop imagination accuracy (mirror of ``mfvae_tpu/rollout_eval.py``).

Roll the world model forward k steps open loop, fed only the logged action
sequence, and compare it with the environment's own trajectory at each
horizon:

1. ``ground_truth``: ``n_starts`` envs stepped together over a leading
   axis for ``burn_in + T`` steps under random or a scripted policy; the
   burn-in decorrelates the start states from the reset distribution;
2. ``score``: one batched ``WorldModel`` rollout from the post-burn-in
   states under the logged [T, B] plan, scored by huber per horizon k
   against the truth and against two baselines that calibrate it: a
   frozen world (the state stays s_0, the reward is zero) and the
   previous-step oracle (the true state at k − 1).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from mfvae_tpu_torch.envs.policies import make_collect_policy
from mfvae_tpu_torch.inference import WorldModel
from mfvae_tpu_torch.models.losses import huber
from mfvae_tpu_torch.models.mavae import AgentSpec
from mfvae_tpu_torch.training.trainer import make_action_sampler


def _agent_slot_map(spec: AgentSpec) -> Tuple[Tuple[int, int], ...]:
    """agent index -> (group, position in the group)."""
    slot = {}
    for g, (_, idxs) in enumerate(spec.groups):
        for pos, i in enumerate(idxs):
            slot[i] = (g, pos)
    return tuple(slot[i] for i in range(spec.n_agents))


def flatten_global_state(spec: AgentSpec, obs_groups) -> torch.Tensor:
    """Per-group obs [..., A_g, od] -> the global state [..., Σobs] in
    agent order, the layout the decoder reconstructs."""
    return torch.cat([obs_groups[g][..., pos, :] for g, pos in _agent_slot_map(spec)], dim=-1)


def ground_truth(
    env,
    spec: AgentSpec,
    generator: torch.Generator,
    T: int,
    n_starts: int = 256,
    burn_in: int = 32,
    policy: str = "random",
    collect_epsilon: float = 0.1,
    collect_mix_frac: float = 0.5,
    start=None,
):
    """``n_starts`` env trajectories of ``burn_in + T`` steps, from resets
    drawn from ``generator`` or from ``start`` = (StackedObs, MPEState)
    with a leading [n_starts] axis.  Returns (start_obs StackedObs [B, ...]
    after the burn-in, actions [T, B, A(, act)], rewards [T, B, A],
    next_obs StackedObs [T, B, ...])."""
    sample_actions, _ = make_action_sampler(env, spec)
    pol = None if policy == "random" else make_collect_policy(
        env, spec, policy, collect_epsilon, sample_actions, mix_frac=collect_mix_frac
    )
    # stateful policies (sticky, episode_mix) thread their carry; the model
    # only ever sees the logged actions
    stateful = hasattr(pol, "init_carry")
    lead = (n_starts,)
    obs, state = env.reset_stacked(generator, batch_shape=lead) if start is None else start
    pol_c = pol.init_carry(lead) if stateful else ()
    actions, rewards, next_obs = [], [], []
    start_obs = obs
    for t in range(burn_in + T):
        if t == burn_in:
            start_obs = obs
        if pol is None:
            act = sample_actions(generator, lead)
        elif stateful:
            pol_c, act = pol.step(pol_c, obs, state, generator)
        else:
            act = pol(state, generator)
        obs, state, rew, _, _ = env.step_stacked(state, act)
        if t >= burn_in:
            actions.append(act)
            rewards.append(rew)
            next_obs.append(obs)
    stack = type(obs)(*(torch.stack(xs) for xs in zip(*next_obs)))
    return start_obs, torch.stack(actions), torch.stack(rewards), stack


def score(
    wm: WorldModel,
    spec: AgentSpec,
    start_obs,
    actions: torch.Tensor,
    rewards: torch.Tensor,
    next_obs,
    horizons: Sequence[int],
) -> Dict[str, torch.Tensor]:
    """Metrics of one imagined rollout against a trajectory of
    ``ground_truth``'s layout, each a scalar f32 keyed per horizon k:
    state_huber/k and reward_huber/k (the model), state_huber_frozen/k and
    reward_huber_zero/k (frozen world), state_huber_persist/k (the true
    state at k − 1)."""
    plan_g = tuple(actions.index_select(2, torch.tensor(i, device=actions.device)) for _, i in spec.groups)
    obs0_g = tuple(start_obs)
    pred_states, pred_rewards = wm._rollout(obs0_g, plan_g)
    gt_states = flatten_global_state(spec, tuple(next_obs))  # [T, B, Σobs]
    s0 = flatten_global_state(spec, obs0_g)
    out = {}
    for k in horizons:
        i = k - 1
        out[f"state_huber/{k}"] = huber(pred_states[i], gt_states[i])
        out[f"reward_huber/{k}"] = huber(pred_rewards[i], rewards[i])
        out[f"state_huber_frozen/{k}"] = huber(s0, gt_states[i])
        out[f"reward_huber_zero/{k}"] = huber(torch.zeros_like(rewards[i]), rewards[i])
        prev = gt_states[i - 1] if i > 0 else s0
        out[f"state_huber_persist/{k}"] = huber(prev, gt_states[i])
    return out


def make_rollout_accuracy_fn(
    wm: WorldModel,
    env,
    spec: AgentSpec,
    horizons: Sequence[int] = (1, 5, 25),
    n_starts: int = 256,
    burn_in: int = 32,
    policy: str = "random",
    collect_epsilon: float = 0.1,
    collect_mix_frac: float = 0.5,
):
    """``fn(generator) -> metrics`` (tensors on the model's device): a
    fresh ground truth, then ``score``.  A world model earns its name by
    beating the frozen world at every k, and persistence wherever the
    dynamics move faster than its own error grows."""
    horizons = tuple(int(k) for k in horizons)
    T = max(horizons)

    def evaluate(generator: torch.Generator) -> Dict[str, torch.Tensor]:
        start_obs, actions, rewards, next_obs = ground_truth(
            env, spec, generator, T, n_starts, burn_in, policy, collect_epsilon, collect_mix_frac
        )
        return score(wm, spec, start_obs, actions, rewards, next_obs, horizons)

    return evaluate


def rollout_accuracy(
    wm: WorldModel,
    env,
    spec: AgentSpec,
    generator: torch.Generator,
    horizons: Sequence[int] = (1, 5, 25),
    n_starts: int = 256,
    burn_in: int = 32,
    policy: str = "random",
    collect_epsilon: float = 0.1,
    collect_mix_frac: float = 0.5,
) -> Dict[str, float]:
    """Build, run and read back as host floats, in one transfer."""
    fn = make_rollout_accuracy_fn(
        wm, env, spec, horizons, n_starts, burn_in, policy, collect_epsilon, collect_mix_frac
    )
    out = fn(generator)
    values = torch.stack(list(out.values())).cpu().tolist()
    return dict(zip(out, values))
