"""The train phase alone: ``make_phase_fns``' ``train_phase`` (``train_num``
steps, each a buffer sample and ``make_train_step``'s step) back to back,
from a ring filled at set-up to its capacity.

Set-up builds the experiment's carry from the seed (``Experiment.build``:
the env, the model, the rings), gives the model the benchmark's weights,
writes the benchmark's replay rows into the train ring through the ring's
own ``ItemBuffer.add_batch``, and runs two train phases through the
window's own call: the first is followed by the reference (its mean loss
over the phase, the first gradient, each leaf's change after three
steps), the second is warm-up.  ``train_samples_per_s`` is the rows the
window trained (steps × batch) over its wall time, the window ending in a
device sync.

Traced: three phases timed on the host clock (the MFU) and two under the
profiler (kernels per step, K1-K3's rooflines, the idle share).
"""

from __future__ import annotations

import time

from benchmark import common, flops
from benchmark.reference import model as M
from benchmark.reference import train as R
from benchmark.watch import FirstSteps

PLAIN_PHASES, PROFILED_PHASES = 3, 2


def _rows(run) -> dict:
    spec = common.ref_spec(run.conf)
    return common.make_rows(spec.obs_dims, common.N_ACTIONS, run.conf["buffer"]["max_size"], run.seed, run.dev)


def setup(run):
    from mfvae_tpu_torch.data.transitions import GroupedTransition
    from mfvae_tpu_torch.training.experiment import Experiment
    from mfvae_tpu_torch.training.trainer import make_phase_fns

    cfg = run.cfg
    exp = Experiment(cfg, device=run.dev).build()
    run.mark("experiment")
    w = common.weights(run)
    ts = exp.carry.train_state
    ts.model.load_state_dict(w, strict=True)
    run.mark("weights")
    rows = _rows(run)
    items = GroupedTransition(obs=tuple(rows["obs"]), actions=tuple(rows["actions"]),
                              next_obs=tuple(rows["next_obs"]), rewards=rows["rewards"], done=rows["done"])
    buf = exp.buffer.add_batch(exp.carry.buffer_state, items)
    del rows, items
    run.mark("ring")
    _, train_phase, _ = make_phase_fns(exp.env, exp.spec, exp.buffer, exp.test_buffer, cfg, exp.streams)
    watch = FirstSteps(ts.model, ts.optimizer, w, after=3, outputs=R.output_modules(run.conf["model"]))
    ts, out = train_phase(ts, buf)
    first = float(out.loss)
    run.mark("first phase")
    ts, _ = train_phase(ts, buf)
    run.state.update(exp=exp, ts=ts, buf=buf, train_phase=train_phase, watch=watch, first=first)


def _phase(run):
    st = run.state
    st["ts"], _ = st["train_phase"](st["ts"], st["buf"])


def window(run, seconds: float):
    phases = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        _phase(run)
        phases += 1
    common.sync(run.dev)
    wall = time.perf_counter() - t0
    steps = phases * run.cfg.train.train_num
    return {"train_samples_per_s": steps * run.cfg.buffer.batch_size / wall}, steps, 0


def trace(run):
    dev = run.dev
    common.sync(dev)
    t0 = time.perf_counter()
    for _ in range(PLAIN_PHASES):
        _phase(run)
    common.sync(dev)
    plain_s = time.perf_counter() - t0

    def profiled():
        for _ in range(PROFILED_PHASES):
            with common.span("train_phase"):
                _phase(run)

    prof = common.Profiled(dev).run(profiled)
    spec = common.ref_spec(run.conf)
    m, b, n = run.conf["model"], run.cfg.buffer.batch_size, run.cfg.train.train_num
    data = {
        "attempted": (PLAIN_PHASES + PROFILED_PHASES) * n,
        "plain": {"wall_s": plain_s, "steps": PLAIN_PHASES * n},
        "profiled": {"wall_s": prof.wall_s, "steps": PROFILED_PHASES * n},
        "flops": {"train_step": flops.train_step_flops(m, spec.obs_dims, spec.act_dims, b)},
        "compute_dtype": m["compute_dtype"], "prof": prof,
        "shapes": {"batch": b, "agents": spec.n, "latent": m["obs_features"], "sum_obs": spec.sum_obs},
    }
    return data, prof


def release(run):
    run.state["watch"].close()
    for key in ("exp", "ts", "buf", "train_phase"):
        run.state.pop(key)


def reference(run, pr: M.Precision, half_batch: bool = False):
    """The first train phase from the seed: (follow, mean losses)."""
    conf = run.conf
    spec = common.ref_spec(conf)
    rows = _rows(run)
    params = common.weights(run)
    opt = R.Adam(params, conf["train"]["lr"])
    follow = R.Follow(params, 3)
    out = R.train_phase(params, opt, conf, spec, rows, conf["buffer"]["max_size"], R.streams(run.seed, run.dev),
                        pr, follow, half_batch)
    return follow, out


def readings(conf: dict, prog: dict, ref) -> dict:
    """``R.step_readings`` of the first steps, and ``loss`` the relative
    gap of the first phase's mean loss."""
    follow, out = ref
    return {**R.step_readings(conf, prog, follow), "loss": R.rel_gap(prog["loss"], float(out[0]))}


def check(run, pr=None, half_batch: bool = False) -> dict:
    prog = dict(R.watched(run.state["watch"]), loss=run.state["first"])
    return readings(run.conf, prog, reference(run, pr or M.Precision(), half_batch))


def stand_in(run, pr: M.Precision, half_batch: bool = False) -> dict:
    """The readings of the reference put in the program's place, in the
    precision ``pr`` (the control) or with a fault, against the reference."""
    follow, out = reference(run, pr, half_batch)
    prog = dict(R.followed(run.conf, follow), loss=float(out[0]))
    return readings(run.conf, prog, reference(run, M.Precision()))
