"""The canonical epoch: ``Experiment.run_epoch`` back to back, each epoch
ending as ``Experiment.run``'s does, with the float read of its metrics
and ``logger.losses`` for the train and the test phase.

Set-up builds the experiment from the seed, gives the model the
benchmark's weights, and runs two epochs: the first is followed by the
reference (the first collect's rows in both rings, the first gradient,
each leaf's change after three train steps, the epoch's train and test
losses), the second is warm-up.  ``epoch_ms`` is the window's wall time
over the whole epochs it completed.

Traced: five epochs timed on the host clock (the MFU), two under the
profiler, three with each phase timed between device syncs (collect,
train, test collect, eval; the pattern of
``scripts/torch_epoch_breakdown.py``) and one collect phase under
``torch.cuda.set_sync_debug_mode("warn")``, which counts its host syncs.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
import warnings

import torch

from benchmark import common, flops
from benchmark.reference import model as M
from benchmark.reference import train as R
from benchmark.common import ref_env, ref_spec, weights
from benchmark.reference.env import N_ACTIONS
from benchmark.watch import FirstSteps

PLAIN_EPOCHS, PROFILED_EPOCHS, PHASE_EPOCHS = 5, 2, 3


def _epoch(run):
    exp = run.state["exp"]
    metrics = exp.run_epoch()
    train = type(metrics.train)(*(float(x) for x in metrics.train))
    test = type(metrics.test)(*(float(x) for x in metrics.test))
    exp.logger.losses(train, run.state["epoch"], "Train")
    exp.logger.losses(test, run.state["epoch"], "Test")
    run.state["epoch"] += 1
    return train, test


def log_dir() -> str:
    """A fresh directory for the run's logs under ``TMPDIR``, or inside
    the checkout where none is set."""
    base = os.environ.get("TMPDIR") or str(common.ROOT / ".bench_cache")
    os.makedirs(base, exist_ok=True)
    return tempfile.mkdtemp(prefix="bench_logs_", dir=base)


def setup(run):
    from mfvae_tpu_torch.training.experiment import Experiment

    cfg = run.cfg
    run.state["logs"] = cfg.train.log_dir = log_dir()
    cfg.train.run_name = run.cell
    cfg.train.checkpoint_dir = ""
    exp = Experiment(cfg, device=run.dev).setup()
    run.mark("experiment")
    w = weights(run)
    ts = exp.carry.train_state
    ts.model.load_state_dict(w, strict=True)
    run.mark("weights")
    watch = FirstSteps(ts.model, ts.optimizer, w, after=3, outputs=R.output_modules(run.conf["model"]))
    run.state.update(exp=exp, epoch=0)
    train, test = _epoch(run)
    run.mark("first epoch")
    n = cfg.train.sample_num
    rings = [exp.carry.buffer_state.data, exp.carry.test_buffer_state.data]
    run.state.update(watch=watch, first=(train.loss, test.loss),
                     rows=[[t[:n].clone() for t in ring_leaves(d)] for d in rings])
    _epoch(run)


def ring_leaves(d) -> list:
    """obs, actions, next_obs per group, then rewards, of a ring."""
    return [*d.obs, *d.actions, *d.next_obs, d.rewards]


def window(run, seconds: float):
    epochs = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        _epoch(run)
        epochs += 1
    wall = time.perf_counter() - t0
    return {"epoch_ms": 1e3 * wall / epochs}, epochs, 0


def trace(run):
    from mfvae_tpu_torch.training.trainer import EpochCarry, make_phase_fns

    exp, dev = run.state["exp"], run.dev
    common.sync(dev)
    t0 = time.perf_counter()
    for _ in range(PLAIN_EPOCHS):
        _epoch(run)
    plain_s = time.perf_counter() - t0

    def profiled():
        for _ in range(PROFILED_EPOCHS):
            with common.span("epoch"):
                _epoch(run)

    prof = common.Profiled(dev).run(profiled)
    collect, train_phase, test_phase = make_phase_fns(exp.env, exp.spec, exp.buffer, exp.test_buffer,
                                                      exp.cfg, exp.streams)

    def timed(fn, *args):
        common.sync(dev)
        t = time.perf_counter()
        out = fn(*args)
        common.sync(dev)
        return out, 1e3 * (time.perf_counter() - t)

    phases = {"collect_ms": [], "train_ms": [], "eval_ms": []}
    carry = exp.carry
    for _ in range(PHASE_EPOCHS):
        (env_c, buf), t_c = timed(collect, carry.env, carry.buffer_state, exp.buffer)
        (ts, _), t_t = timed(train_phase, carry.train_state, buf)
        (env_c, tbuf), t_tc = timed(collect, env_c, carry.test_buffer_state, exp.test_buffer)
        _, t_e = timed(test_phase, ts, tbuf)
        carry = EpochCarry(ts, buf, tbuf, env_c)
        phases["collect_ms"].append(t_c + t_tc)
        phases["train_ms"].append(t_t)
        phases["eval_ms"].append(t_e)
    common.sync(dev)
    syncs = 0
    if dev.type == "cuda":
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                env_c, buf = collect(carry.env, carry.buffer_state, exp.buffer)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        carry = carry._replace(env=env_c, buffer_state=buf)
    exp.carry = carry
    spec = ref_spec(run.conf)
    data = {
        "attempted": PLAIN_EPOCHS + PROFILED_EPOCHS + PHASE_EPOCHS,
        "plain": {"wall_s": plain_s, "epochs": PLAIN_EPOCHS},
        "profiled": {"wall_s": prof.wall_s, "epochs": PROFILED_EPOCHS},
        "phases": phases, "host_syncs_collect": syncs if dev.type == "cuda" else None,
        "flops": {"epoch": flops.epoch_flops(run.conf, spec.obs_dims, spec.act_dims)},
        "compute_dtype": run.conf["model"]["compute_dtype"], "prof": prof,
    }
    return data, prof


def release(run):
    run.state["watch"].close()
    exp = run.state.pop("exp")
    exp.logger.close()
    shutil.rmtree(run.state.pop("logs"), ignore_errors=True)
    del exp


def reference(run, pr: M.Precision, half_batch: bool = False):
    """The first epoch from the seed: (train rows, test rows, follow, train
    losses, test losses)."""
    conf, dev = run.conf, run.dev
    env = ref_env(conf, dev)
    spec = M.Spec(env.obs_dims, (N_ACTIONS,) * env.n)
    gens = R.streams(run.seed, dev)
    n, cap = conf["train"]["sample_num"], conf["buffer"]["max_size"]
    carry = env.reset(gens["reset"])
    ring = R.new_ring(env, spec, cap, dev)
    carry, _ = R.collect(env, spec, carry, ring, 0, n, gens)
    params = weights(run)
    opt = R.Adam(params, conf["train"]["lr"])
    follow = R.Follow(params, 3)
    train = R.train_phase(params, opt, conf, spec, ring, n, gens, pr, follow, half_batch)
    test_ring = R.new_ring(env, spec, cap, dev)
    carry, _ = R.collect(env, spec, carry, test_ring, 0, n, gens)
    test = R.test_phase(params, conf, spec, test_ring, n, gens, pr)
    rows = [[t[:n] for t in [*r["obs"], *r["actions"], *r["next_obs"], r["rewards"]]] for r in (ring, test_ring)]
    return rows, follow, train, test


def readings(conf: dict, prog: dict, ref) -> dict:
    """``env`` the largest gap in the first collect's rows (both rings);
    ``out1`` the worst row's gap of the first forward's state output and
    reward; ``loss1`` the relative gap of the first train step's loss,
    ``loss`` the worse of the epoch's train and test loss; ``grad`` and
    ``update`` the worst leaf's gap of norms (first gradient; change after
    three steps, over the leaves the reference's first gradient moves)."""
    rows_r, follow, train, test = ref
    env_gap = max(float(torch.max(torch.abs(a.double() - b.double()))) if a.numel() else 0.0
                  for ra, rb in zip(prog["rows"], rows_r) for a, b in zip(ra, rb))
    return {"env": env_gap, **R.step_readings(conf, prog, follow),
            "loss": max(R.rel_gap(prog["losses"][0], float(train[0])), R.rel_gap(prog["losses"][1], float(test[0])))}


def check(run, pr=None, half_batch: bool = False) -> dict:
    prog = dict(R.watched(run.state["watch"]), rows=run.state["rows"], losses=run.state["first"])
    return readings(run.conf, prog, reference(run, pr or M.Precision(), half_batch))


def stand_in(run, pr: M.Precision, half_batch: bool = False) -> dict:
    """The readings of the reference put in the program's place, in the
    precision ``pr`` (the control) or with a fault, against the reference."""
    rows, follow, train, test = reference(run, pr, half_batch)
    prog = dict(R.followed(run.conf, follow), rows=rows, losses=(float(train[0]), float(test[0])))
    return readings(run.conf, prog, reference(run, M.Precision()))
