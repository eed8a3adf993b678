"""Config-driven behavior learning (mirror of ``mfvae_tpu/behavior.py``):
the Dreamer loop as one command.

    python -m mfvae_tpu_torch.behavior examples/behavior_policy.yaml \\
        behavior.updates=500 behavior.save_path=/tmp/policy.pt [--device cpu]

trains (or resumes, through ``train.checkpoint_dir`` + ``train.resume``)
the world-model experiment, trains the configured policy (REINFORCE,
TD(λ) actor-critic or enumerated-teacher distillation) entirely inside the
model's imagination, saves it, and optionally scores its real-env return
against the uniform-random anchor.  It runs on the CUDA card unless
``--device cpu`` is given.

The policy file: ``behavior.save_path`` holds ``torch.save`` of the policy
network's state dict (read back with ``weights_only=True``), beside a
``<save_path>.json`` sidecar with the JAX package's keys (``hidden``,
``act_dim``, ``obs_dim``, ``algo``, ``continuous``, ``plan_agents``,
``centralized``).  The JAX package writes flax msgpack under the same
names; neither package reads the other's file.  ``load_policy`` rebuilds
the network from the sidecar, ``imagination.make_policy_actor`` serves it,
and ``train.collect_policy='imagination:<save_path>'`` collects with it.

The random draws come from an explicit ``torch.Generator``;
``train_behavior`` also takes the start pool and each update's start rows.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mfvae_tpu_torch.config import BehaviorConfig, ExperimentConfig, apply_overrides, load_config
from mfvae_tpu_torch.envs.mpe import tag_prey_rel_slice
from mfvae_tpu_torch.envs.policies import make_collect_policy
from mfvae_tpu_torch.imagination import (
    GaussianPolicyMLP,
    PolicyMLP,
    make_actor_critic_trainer,
    make_distillation_trainer,
    make_imagination_trainer,
    make_obs_builder,
    make_policy_actor,
)
from mfvae_tpu_torch.inference import WorldModel
from mfvae_tpu_torch.planning import eval_joint_policy
from mfvae_tpu_torch.training.experiment import Experiment, resolve_device
from mfvae_tpu_torch.training.trainer import make_action_sampler


@dataclass
class BehaviorResult:
    policy: nn.Module  # the trained policy network, holding its weights
    aux_params: Optional[nn.Module]  # the critic for actor_critic, else None
    plan_agents: Tuple[int, ...]
    curve: list


def resolve_plan_agents(exp, bcfg: BehaviorConfig) -> Tuple[int, ...]:
    """'adversaries' -> the env's adversary-team prefix, counted from the
    env's own agent names (simple_adversary fixes its adversary count
    whatever the config says); 'all' -> every agent."""
    if bcfg.plan_agents == "all":
        return tuple(range(exp.spec.n_agents))
    n_adv = sum(1 for a in exp.env.agents if a.startswith("adversary"))
    if n_adv <= 0:
        raise ValueError(
            "behavior.plan_agents='adversaries' but env "
            f"{exp.cfg.env.name!r} has no adversary_* agents; use "
            "plan_agents='all'"
        )
    if not all(exp.env.agents[i].startswith("adversary") for i in range(n_adv)):
        raise ValueError("adversaries must be the leading agent prefix")
    return tuple(range(n_adv))


def make_behavior_scores(exp, bcfg: BehaviorConfig, plan_idx: Sequence[int]):
    """(terminal_score_fn, step_score_fn) over imagined (states [H, B,
    Σobs], rewards [H, B, A]).

    'reward': the model's predicted-reward columns of the plan agents.
    'prey_distance' (simple_tag only): minus each adversary's distance to
    its nearest prey, read from its own predicted observation row."""
    idx = list(plan_idx)
    if bcfg.score == "reward":
        def terminal(states, rewards):
            return torch.sum(rewards[..., idx], dim=0)

        def step(states, rewards):
            return rewards[..., idx]

        return terminal, step

    if "tag" not in exp.cfg.env.name:
        raise ValueError(
            "behavior.score='prey_distance' is a simple_tag objective; "
            f"got env {exp.cfg.env.name!r} — use score='reward'"
        )
    n_adv = int(exp.cfg.env.num_adversaries)
    n_good = int(exp.cfg.env.num_good_agents)
    od_adv = exp.spec.obs_dims[0]
    prey = tag_prey_rel_slice(int(exp.cfg.env.num_obs), n_adv, n_good)
    if not all(int(i) < n_adv for i in plan_idx):
        raise ValueError(
            "prey_distance scores adversaries only; plan_agents includes "
            "non-adversary indices — use score='reward' or "
            "plan_agents='adversaries'"
        )

    def _min_prey_dist(states):
        h, n = states.shape[:2]
        adv_obs = states[:, :, : n_adv * od_adv].reshape(h, n, n_adv, od_adv)
        rel = adv_obs[..., prey].reshape(h, n, n_adv, n_good, 2)
        d = torch.amin(torch.sqrt(torch.sum(rel * rel, dim=-1) + 1e-12), dim=-1)
        return d[..., idx]  # [H, B, P]

    def terminal(states, rewards):
        return -torch.sum(_min_prey_dist(states), dim=0)

    def step(states, rewards):
        return -_min_prey_dist(states)

    return terminal, step


@torch.no_grad()
def collect_start_states(exp, bcfg: BehaviorConfig, generator: Optional[torch.Generator] = None):
    """Real start observations from the experiment's own collection process
    (``train.collect_policy``; ``vdn:`` falls back to random, as in the JAX
    package) after ``start_burn_in`` steps: one batched env of
    ``start_pool`` episodes.  Returns the stacked obs, per group
    [start_pool, A_g, od]."""
    env, spec, cfg = exp.env, exp.spec, exp.cfg
    if generator is None:
        generator = torch.Generator(device=exp.device).manual_seed(4242)
    sample_actions, _ = make_action_sampler(env, spec)
    cp = cfg.train.collect_policy
    pol = None
    if cp != "random" and not cp.startswith("vdn:"):
        pol = make_collect_policy(env, spec, cp, cfg.train.collect_epsilon, sample_actions,
                                  mix_frac=cfg.train.collect_mix_frac)
    lead = (bcfg.start_pool,)
    obs, state = env.reset_stacked(generator, batch_shape=lead)
    carry = pol.init_carry(lead) if hasattr(pol, "init_carry") else None
    for _ in range(bcfg.start_burn_in):
        if pol is None:
            acts = sample_actions(generator, lead)
        elif carry is None:
            acts = pol(state, generator)  # stateless scripted policy
        else:
            carry, acts = pol.step(carry, obs, state, generator)
        obs, state, *_ = env.step_stacked(state, acts)
    return obs


def make_behavior_trainer(exp, wm, plan_idx: Sequence[int]):
    """The configured algorithm's ``(init_fn, update_fn)`` through ``wm``
    (``imagination.py``; the actor-critic's critic stays inside its
    params)."""
    bcfg: BehaviorConfig = exp.cfg.behavior
    terminal, step_score = make_behavior_scores(exp, bcfg, plan_idx)
    hidden = tuple(int(h) for h in bcfg.hidden)
    if bcfg.algo == "reinforce":
        return make_imagination_trainer(
            wm, exp.env, exp.spec, plan_idx, score_fn=terminal,
            horizon=bcfg.horizon, n_rollouts=bcfg.n_rollouts,
            learning_rate=bcfg.learning_rate, entropy_coef=bcfg.entropy_coef, hidden=hidden,
            centralized=bcfg.centralized,
        )
    if bcfg.algo == "actor_critic":
        return make_actor_critic_trainer(
            wm, exp.env, exp.spec, plan_idx, step_score_fn=step_score,
            horizon=bcfg.horizon, n_rollouts=bcfg.n_rollouts,
            learning_rate=bcfg.learning_rate, entropy_coef=bcfg.entropy_coef, value_coef=bcfg.value_coef,
            gamma=bcfg.gamma, lam=bcfg.lam, hidden=hidden,
            target_ema=bcfg.target_ema, critic_symlog=bcfg.critic_symlog,
            bootstrap_tail=bcfg.bootstrap_tail, critic_time_feature=bcfg.critic_time_feature,
            centralized=bcfg.centralized,
        )
    return make_distillation_trainer(
        wm, exp.env, exp.spec, plan_idx, score_fn=terminal,
        horizon=bcfg.horizon, visit_steps=bcfg.visit_steps,
        learning_rate=bcfg.learning_rate, hidden=hidden,
        teacher_mode="enumerated", m_rollouts=bcfg.m_rollouts,
        continuation=bcfg.continuation, temperature=bcfg.temperature,
        centralized=bcfg.centralized,
    )


def train_behavior(
    exp,
    generator: Optional[torch.Generator] = None,
    progress: Optional[Callable[[int, dict], None]] = None,
    pool=None,
    rows=None,
) -> BehaviorResult:
    """Train ``exp.cfg.behavior``'s policy inside the world model of
    ``exp``, a set-up (and trained or resumed) Experiment.  The draws come
    from ``generator`` (default seed 7): the start pool
    (``collect_start_states``) unless ``pool`` is given, the policy's
    init, then per update the start rows (``n_starts`` of the pool without
    replacement, unless ``rows[i]`` is given) and the update's noise.
    Metrics are read back every 100 updates and at the last."""
    bcfg: BehaviorConfig = exp.cfg.behavior
    if bcfg.algo == "distill" and not exp.cfg.env.discrete_actions:
        raise ValueError(
            "behavior.algo='distill' needs discrete actions (the "
            "enumerated teacher enumerates a finite action set); use "
            "'reinforce' or 'actor_critic' for continuous envs"
        )
    if generator is None:
        generator = torch.Generator(device=exp.device).manual_seed(7)
    wm = WorldModel(exp.carry.train_state.model)
    plan_idx = resolve_plan_agents(exp, bcfg)
    init_fn, update_fn = make_behavior_trainer(exp, wm, plan_idx)
    if pool is None:
        pool = collect_start_states(exp, bcfg, generator)
    params, opt = init_fn(generator)
    n = min(bcfg.n_starts, bcfg.start_pool)
    curve = []
    for i in range(bcfg.updates):
        if rows is None:
            idx = torch.randperm(pool[0].shape[0], generator=generator, device=exp.device)[:n]
        else:
            idx = rows[i]
        m = update_fn(params, opt, tuple(o[idx] for o in pool), generator)
        if i % 100 == 0 or i == bcfg.updates - 1:
            m = {k: float(v) for k, v in m.items()}
            curve.append({"update": i, **m})
            if progress is not None:
                progress(i, m)
    if bcfg.algo == "actor_critic":
        return BehaviorResult(params["pi"], params["v"], plan_idx, curve)
    return BehaviorResult(params, None, plan_idx, curve)


# --------------------------------------------------------------- save/load
def save_policy(path: str, result: BehaviorResult, bcfg: BehaviorConfig, obs_dim: int, act_dim: int) -> None:
    """The policy's state dict (``torch.save``) and the ``.json`` sidecar
    with the network's shape, so ``load_policy`` rebuilds it without the
    training config."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    torch.save(result.policy.state_dict(), p)
    meta = {
        "hidden": [int(h) for h in bcfg.hidden],
        "act_dim": int(act_dim),
        "obs_dim": int(obs_dim),
        "algo": bcfg.algo,
        "continuous": isinstance(result.policy, GaussianPolicyMLP),
        "plan_agents": [int(i) for i in result.plan_agents],
        # a centralized policy needs the joint obs built at serving time;
        # obs_dim is then the centralized input width
        "centralized": bool(bcfg.centralized),
    }
    p.with_suffix(p.suffix + ".json").write_text(json.dumps(meta))


def load_policy(path: str, device="cuda"):
    """(policy, meta) from ``save_policy``'s files, on ``device`` (the card
    unless the caller asks for the CPU): the policy module with its weights
    and the sidecar."""
    dev = resolve_device(device)
    p = Path(path)
    meta = json.loads(p.with_suffix(p.suffix + ".json").read_text())
    cls = GaussianPolicyMLP if meta.get("continuous") else PolicyMLP
    policy = cls(meta["obs_dim"], tuple(meta["hidden"]), meta["act_dim"], device=dev)
    policy.load_state_dict(torch.load(p, map_location=dev, weights_only=True))
    return policy, meta


# --------------------------------------------------------------------- cli
def eval_returns(exp, result: BehaviorResult, episodes: int, ep_len: int, centralized: bool = False) -> dict:
    """The plan agents' real-env return under the sampled policy and under
    uniform-random actions, each over the same ``episodes`` fixed-length
    episodes (``eval_joint_policy``, generator seed 1234): the mean and its
    standard error per arm."""
    sample_actions, _ = make_action_sampler(exp.env, exp.spec)
    actor = make_policy_actor(result.policy, exp.env, exp.spec, result.plan_agents,
                              greedy=False, centralized=centralized)
    idx = list(result.plan_agents)
    is_plan = torch.zeros(exp.spec.n_agents, dtype=torch.bool, device=exp.device)
    is_plan[idx] = True
    if not exp.cfg.env.discrete_actions:
        is_plan = is_plan[:, None]

    def arm_pol(obs, state, g):
        return torch.where(is_plan, actor(obs, g), sample_actions(g, (episodes,)))

    def arm_rand(obs, state, g):
        return sample_actions(g, (episodes,))

    out = {}
    for name, arm in (("policy", arm_pol), ("random", arm_rand)):
        rew = eval_joint_policy(exp.env, exp.spec, arm, n_episodes=episodes, ep_len=ep_len,
                                generator=torch.Generator(device=exp.device).manual_seed(1234))
        ret = rew[..., idx].sum(dim=(1, 2)).double().cpu().numpy()
        out[f"eval_{name}_return_mean"] = float(ret.mean())
        out[f"eval_{name}_return_sem"] = float(ret.std(ddof=1) / max(np.sqrt(len(ret)), 1))
    return out


def run(cfg_path: Optional[str], overrides, device="cuda") -> dict:
    if cfg_path is None:
        cfg = ExperimentConfig()
        apply_overrides(cfg, list(overrides))
    else:
        cfg = load_config(cfg_path, list(overrides))
    cfg.validate()
    exp = Experiment(cfg, device).setup()
    exp.run()
    bcfg = cfg.behavior

    def progress(i, m):
        print(f"behavior update {i}: " + " ".join(f"{k}={v:.4f}" for k, v in m.items()), flush=True)

    result = train_behavior(exp, progress=progress)
    out = {
        "algo": bcfg.algo,
        "updates": bcfg.updates,
        "plan_agents": len(result.plan_agents),
        "final": result.curve[-1] if result.curve else {},
    }
    if bcfg.save_path:
        _, policy_obs_dim = make_obs_builder(exp.spec, result.plan_agents, bcfg.centralized)
        save_policy(bcfg.save_path, result, bcfg, obs_dim=int(policy_obs_dim), act_dim=int(exp.spec.act_dims[0]))
        out["save_path"] = bcfg.save_path
    if bcfg.eval_episodes > 0:
        out.update(eval_returns(exp, result, bcfg.eval_episodes, bcfg.eval_ep_len, bcfg.centralized))
    print(json.dumps(out))
    return out


def main(argv=None):
    from mfvae_tpu_torch.__main__ import split_args

    cfg_path, overrides, device = split_args(sys.argv[1:] if argv is None else argv)
    run(cfg_path, overrides, device)


if __name__ == "__main__":
    main()
