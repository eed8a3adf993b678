"""Imagined rollouts served one request at a time (a closed loop, one
client): each request is ``WorldModel.rollout`` of ``batch`` start states
for ``horizon`` steps under a random action plan, timed from the moment
it is sent to its outputs ready on the device.

Set-up makes the model with the benchmark's weights, and draws
``pool`` requests from the seed on the device: start states from
simple_tag resets (the reference env) and uniform action plans.  Request
i serves pool entry i mod ``pool``.  The outputs of a sample of requests,
drawn from the seed among the first ``min_requests``, and of the last
request are kept (moved to the host once timed) for the reference.
``rollout_p95_ms`` is the 95th percentile (nearest rank) of every
request's latency in the window.

Traced: ``plain`` requests timed on the host clock (the MFU) and
``profiled`` requests under the profiler.
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import common, flops
from benchmark.reference import model as M
from benchmark.reference import train as R

PLAIN_REQUESTS, PROFILED_REQUESTS, KEPT = 10, 3, 3


def setup(run):
    from mfvae_tpu_torch.envs.mpe import make
    from mfvae_tpu_torch.inference import WorldModel
    from mfvae_tpu_torch.models.mavae import MAVAE, GroupedBatch
    from mfvae_tpu_torch.training.experiment import build_spec

    cfg, dev, t = run.cfg, run.dev, run.traffic
    env_cfg = cfg.env
    env = make(env_cfg.name, device=dev, num_good_agents=env_cfg.num_good_agents,
               num_adversaries=env_cfg.num_adversaries, num_obs=env_cfg.num_obs,
               max_steps=env_cfg.max_steps, discrete_actions=env_cfg.discrete_actions)
    model = MAVAE.from_config(cfg.model, build_spec(env), device=dev)
    model.load_state_dict(common.weights(run), strict=True)
    run.mark("model")
    wm = WorldModel(model)
    starts, plans = requests(run)
    run.mark("requests")
    batches = [GroupedBatch(obs=tuple(s), actions=()) for s in starts]
    g = common.generator(run.seed, common.ROLLOUT_STREAM + 1, "cpu")
    keep = torch.randperm(t["min_requests"], generator=g)[:KEPT].tolist()
    run.state.update(wm=wm, batches=batches, plans=plans, keep=set(keep), kept={}, served=0, latencies=[])
    for _ in range(2):
        serve(run, record=False)


def requests(run):
    """(starts, plans) of the pool: per entry the per-group start obs
    [B, A_g, od] and the per-group plan [T, B, A_g]."""
    t, dev = run.traffic, run.dev
    env = common.ref_env(run.conf, dev)
    spec = M.Spec(env.obs_dims, (common.N_ACTIONS,) * env.n)
    g = common.generator(run.seed, common.ROLLOUT_STREAM, dev)
    obs, _ = env.reset(g, (t["pool"], t["batch"]))
    plans = torch.randint(0, common.N_ACTIONS, (t["pool"], t["horizon"], t["batch"], env.n), generator=g, device=dev,
                          dtype=torch.int32)
    bounds, lo = [], 0
    for _, idx in spec.groups:
        bounds.append((lo, lo + len(idx)))
        lo += len(idx)
    starts = [[o[p] for o in obs] for p in range(t["pool"])]
    plans = [tuple(plans[p, :, :, a:b].contiguous() for a, b in bounds) for p in range(t["pool"])]
    return starts, plans


def serve(run, record: bool = True) -> float:
    """One request, timed from when it is sent to its outputs on the device."""
    st = run.state
    i = st["served"]
    p = i % len(st["batches"])
    common.sync(run.dev)
    t0 = time.perf_counter()
    states, rewards = st["wm"].rollout(st["batches"][p], st["plans"][p])
    common.sync(run.dev)
    dt = time.perf_counter() - t0
    if record:
        st["served"] += 1
        st["latencies"].append(dt)
        if i in st["keep"]:
            st["kept"][i] = (p, states.cpu(), rewards.cpu())
        st["last"] = (i, p, states, rewards)
    return dt


def keep_last(run):
    st = run.state
    i, p, states, rewards = st.pop("last")
    st["kept"][i] = (p, states.cpu(), rewards.cpu())


def serve_first(run):
    """The first ``min_requests`` requests, the last of them kept: what
    the check compares, without a timed window (``calibrate.py``)."""
    for _ in range(run.traffic["min_requests"]):
        serve(run)
    keep_last(run)


def window(run, seconds: float):
    st = run.state
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        serve(run)
    keep_last(run)
    lat = sorted(st["latencies"])
    p95 = lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
    return {"rollout_p95_ms": 1e3 * p95}, len(lat), 0


def trace(run):
    st, dev = run.state, run.dev
    t0 = time.perf_counter()
    for _ in range(PLAIN_REQUESTS):
        serve(run)
    plain_s = time.perf_counter() - t0

    def profiled():
        for _ in range(PROFILED_REQUESTS):
            with common.span("request"):
                serve(run)

    prof = common.Profiled(dev).run(profiled)
    keep_last(run)
    spec = common.ref_spec(run.conf)
    t, m = run.traffic, run.conf["model"]
    data = {
        "attempted": st["served"],
        "plain": {"wall_s": plain_s, "requests": PLAIN_REQUESTS},
        "profiled": {"wall_s": prof.wall_s, "requests": PROFILED_REQUESTS},
        "flops": {"request": flops.rollout_flops(m, spec.obs_dims, spec.act_dims, t["batch"], t["horizon"])},
        "compute_dtype": m["compute_dtype"], "prof": prof,
    }
    return data, prof


def release(run):
    for key in ("wm", "batches", "plans"):
        run.state.pop(key)


@torch.no_grad()
def reference(run, p: int, pr: M.Precision):
    """The closed loop of pool entry ``p``: (states [T, B, Σobs], rewards
    [T, B, A])."""
    conf = run.conf
    spec = common.ref_spec(conf)
    params = run.state.get("ref_params") or common.weights(run)
    run.state["ref_params"] = params
    starts, plans = run.state.get("ref_requests") or requests(run)
    run.state["ref_requests"] = (starts, plans)
    obs, states, rewards = list(starts[p]), [], []
    for step in range(run.traffic["horizon"]):
        s, r = M.mean_forward(params, conf["model"], spec, obs, [a[step] for a in plans[p]], pr)
        states.append(s)
        rewards.append(r)
        obs = M.split_state(spec, s)
    return torch.stack(states), torch.stack(rewards)


def check(run, pr=None) -> dict:
    """``state`` and ``reward``: the worst row's gap over the kept
    requests."""
    pr = pr or M.Precision()
    out = {"state": 0.0, "reward": 0.0}
    for i, (p, states, rewards) in sorted(run.state["kept"].items()):
        rs, rr = reference(run, p, pr)
        out["state"] = max(out["state"], R.row_gap(states.to(rs.device), rs))
        out["reward"] = max(out["reward"], R.row_gap(rewards.to(rr.device), rr))
    return out


def stand_in(run, pr: M.Precision, half_batch: bool = False) -> dict:
    """The readings of the reference put in the program's place, in the
    precision ``pr`` (the control), over the first ``KEPT`` pool entries."""
    if half_batch:
        raise ValueError("a rollout has no batch mean to halve")
    out = {"state": 0.0, "reward": 0.0}
    for p in range(min(KEPT, run.traffic["pool"])):
        cs, cr = reference(run, p, pr)
        rs, rr = reference(run, p, M.Precision())
        out["state"] = max(out["state"], R.row_gap(cs, rs))
        out["reward"] = max(out["reward"], R.row_gap(cr, rr))
    return out
