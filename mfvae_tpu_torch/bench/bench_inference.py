"""Serving and planning throughput on the flagship model: the counterpart
of ``scripts/bench_inference.py``.

    python -m mfvae_tpu_torch.bench.bench_inference [--device cpu] [--out FILE]

- ``WorldModel.predict`` at B = 1, 64 and 1,024: 100 calls with one sync,
  best of 3 (``predict_b{B}_per_sec``), and at B = 1 the latency of a call
  with a sync after each (``predict_b1_latency_ms``, 20 calls);
- ``WorldModel._rollout`` over T = 25 under a random plan: 30 rollouts
  with one sync, best of 3, in trajectories/s and steps/s;
- env steps/s of four actors driving ``eval_joint_policy`` over 4 episodes
  of 32 real simple_tag steps (30/10/20), the adversaries planned and the
  good agents at random: random-shooting MPC (factorized, N 256, H 8), CEM
  (3 iterations), the imagination policy (``PolicyActor``, one forward a
  step), and CEM warm-started from the policy's logits (1 iteration); one
  warm-up run, then one timed run ending in a sync.

The planners score candidates with the JAX script's ``dist_fact`` (minus
each adversary's distance to its nearest prey, summed over the horizon,
read off the predicted obs at its offsets).  Parameters are untrained:
throughput only.  One JSON line with the JAX script's keys and ``device``.
"""

from __future__ import annotations

import time

import torch

from mfvae_tpu_torch.bench.common import best_window, cli, device_info, emit, setup, sync, synced_wall
from mfvae_tpu_torch.bench.flagship import flagship
from mfvae_tpu_torch.envs.mpe import SimpleTagEnv
from mfvae_tpu_torch.imagination import PolicyMLP, make_policy_actor
from mfvae_tpu_torch.inference import WorldModel
from mfvae_tpu_torch.planning import eval_joint_policy, make_cem_actor, make_mpc_actor
from mfvae_tpu_torch.training.trainer import make_action_sampler, stacked_to_grouped

HORIZON = 25
FULL = dict(n_predict=100, n_latency=20, n_rollout=30, reps=3, n_episodes=4, ep_len=32)


def dist_fact(states: torch.Tensor, rewards: torch.Tensor) -> torch.Tensor:
    """[M, 30]: minus each adversary's summed distance to its nearest prey
    over the horizon (states [H, M, Σobs]; the JAX script's offsets for
    simple_tag 30/10/20, adversary obs 142)."""
    adv_obs = states[:, :, : 30 * 142].reshape(states.shape[0], states.shape[1], 30, 142)
    off = 4 + 2 * 20 + 2 * 29
    rel = adv_obs[..., off : off + 20].reshape(states.shape[0], states.shape[1], 30, 10, 2)
    d = torch.amin(torch.sqrt(torch.sum(rel * rel, dim=-1) + 1e-12), dim=-1)
    return -torch.sum(d, dim=0)


def run(device="cuda", tiny: bool = False, batches=(1, 64, 1024), **counts) -> dict:
    """bench_inference.py's rows on ``device``; ``counts`` override
    ``FULL``'s (a cut run)."""
    unknown = set(counts) - set(FULL)
    if unknown:
        raise ValueError(f"unknown counts {sorted(unknown)}; expected some of {sorted(FULL)}")
    c = {**FULL, **counts}
    dev = setup(device)
    out = {"horizon": HORIZON}
    for batch in batches:
        spec, model, inputs = flagship(batch, tiny=tiny, device=dev)
        wm = WorldModel(model)

        # ---- one-step predict
        synced_wall(lambda i: wm.predict(inputs, None), 1, dev)  # warm-up
        best = best_window(lambda i: wm.predict(inputs, None), c["n_predict"], c["reps"], dev)
        out[f"predict_b{batch}_per_sec"] = batch * c["n_predict"] / best
        if batch == 1:
            # the synchronous caller's view: a sync after every call
            out["predict_b1_latency_ms"] = 1e3 * synced_wall(
                lambda i: wm.predict(inputs, None), c["n_latency"], dev) / c["n_latency"]

        # ---- the T-step rollout
        g = torch.Generator(device=dev).manual_seed(2)
        plan = tuple(
            torch.randint(0, spec.act_dims[idxs[0]], (HORIZON, batch, len(idxs)), generator=g, device=dev)
            for _, idxs in spec.groups
        )
        synced_wall(lambda i: wm._rollout(inputs.obs, plan), 1, dev)  # warm-up
        best = best_window(lambda i: wm._rollout(inputs.obs, plan), c["n_rollout"], c["reps"], dev)
        out[f"rollout{HORIZON}_b{batch}_traj_per_sec"] = batch * c["n_rollout"] / best
        out[f"rollout{HORIZON}_b{batch}_steps_per_sec"] = batch * c["n_rollout"] * HORIZON / best
        del wm, model, inputs

    # ---- the control surface: planners against the amortized policy
    spec, model, _ = flagship(1, tiny=tiny, device=dev)
    wm = WorldModel(model)
    env = SimpleTagEnv(num_good_agents=10, num_adversaries=30, num_obs=20, device=dev)
    sample_actions, _ = make_action_sampler(env, spec)
    adv_idx = tuple(range(30))
    is_adv = torch.arange(spec.n_agents, device=dev) < 30
    policy = PolicyMLP(spec.obs_dims[0], device=dev, generator=torch.Generator(device=dev).manual_seed(3))

    def proposal_fn(stacked):
        return policy(stacked_to_grouped(spec, stacked)[0][..., :30, :])  # [*L, 30, 5]

    plan_kw = dict(horizon=8, n_candidates=256, plan_agents=adv_idx, score_fn=dist_fact)
    actors = {
        "mpc_shoot_n256_h8": make_mpc_actor(wm, env, spec, factorized=True, candidate_mode="random", **plan_kw),
        "cem_i3_n256_h8": make_cem_actor(wm, env, spec, iters=3, **plan_kw),
        "imagination_policy": make_policy_actor(policy, env, spec, adv_idx),
        "cem_warm_i1_n256_h8": make_cem_actor(wm, env, spec, iters=1, proposal_fn=proposal_fn, **plan_kw),
    }

    def bench_actor(actor) -> float:
        def joint(obs, state, g):
            return torch.where(is_adv, actor(obs, g), sample_actions(g, (c["n_episodes"],)))

        def episodes(seed):
            g = torch.Generator(device=dev).manual_seed(seed)
            with torch.no_grad():
                eval_joint_policy(env, spec, joint, n_episodes=c["n_episodes"], ep_len=c["ep_len"], generator=g)
            sync(dev)

        episodes(0)  # warm-up
        t0 = time.perf_counter()
        episodes(1)
        return c["n_episodes"] * c["ep_len"] / (time.perf_counter() - t0)

    for name, actor in actors.items():
        out[f"actor_{name}_env_steps_per_sec"] = bench_actor(actor)
    out["device"] = device_info(dev)
    return out


def main(argv=None) -> None:
    a = cli("python -m mfvae_tpu_torch.bench.bench_inference", __doc__.split("\n\n")[0], argv)
    emit(run(a.device), a.out)


if __name__ == "__main__":
    main()
