"""The unroll train phase alone: ``make_phase_fns``' ``train_phase``
(``train_num`` steps, each ``ItemBuffer.sample_window`` of B windows of W
transitions and ``make_unroll_train_step``'s step: W forwards with the
prediction fed back, the masked pooled ELBO, one backward through them
all, the global-norm clip, Adam) back to back, from a ring filled at
set-up to its capacity with an episode end every ``episode_steps`` rows.

Set-up builds the experiment's carry from the seed, gives the model the
benchmark's weights, writes the replay rows into the train ring through
``ItemBuffer.add_batch`` and runs two train phases through the window's
own call: the first is followed by the reference
(``benchmark/reference/unroll.py``: the first forward's outputs, the W-th
forward's state output, the first clipped gradient, each leaf's change
after three steps), the second is warm-up.  ``train_samples_per_s``
counts transitions: steps × B × W over the window's wall, the window
ending in a device sync.

Besides ``benchmark.watch.FirstSteps`` the driver holds its own hooks on
step 1: the W-th call of the state output module (the compounding
feedback) and the two calls of ``huber_rows_wsum`` (kernel K3w), each
value beside the float64 weighted sum of the very inputs and weights it
was given.

Traced: three phases timed on the host clock (the MFU) and one under the
profiler (kernels per step, K3w's roofline, the idle share, the host time
of a window step and of a step's draw).  The data has the one-step
``train_phase`` driver's keys, so its readers (``mfu_pct.train``,
``kernels_per_step.train``, ``idle_pct.train``, ``sample_ms.train``) read
this cell too; ``flops["train_step"]`` is the whole unroll step's (W
forwards and their backward, ``benchmark/flops_unroll.py``).
"""

from __future__ import annotations

import time

from benchmark import common, flops_unroll
from benchmark.reference import model as M
from benchmark.reference import train as R
from benchmark.reference import unroll as U
from benchmark.watch import FirstSteps

PLAIN_PHASES, PROFILED_PHASES = 3, 1
FOLLOWED_STEPS = 3  # the reference's steps: the update check reads the change after step 3


def _rows(run) -> dict:
    """``common.make_rows`` with ``done`` on every ``episode_steps``-th row."""
    spec = common.ref_spec(run.conf)
    rows = common.make_rows(spec.obs_dims, common.N_ACTIONS, run.conf["buffer"]["max_size"], run.seed, run.dev)
    every = int(run.traffic["episode_steps"])
    rows["done"][every - 1::every] = 1.0
    return rows


class WindowStepWatch:
    """Step 1's W-th call of the state output module (its output, on the
    host) and its two calls of ``training.unroll.huber_rows_wsum`` (each
    value and the float64 weighted sum of its own inputs); then the hooks
    remove themselves."""

    def __init__(self, model, module: str, window: int):
        from mfvae_tpu_torch.training import unroll

        self.last_output = None
        self.k3w: list = []  # (value, float64 value) of step 1's two calls
        self._unroll = unroll
        self._real = real = unroll.huber_rows_wsum
        calls = [0]

        def keep(mod, args, output):
            calls[0] += 1
            if calls[0] == window:
                self.last_output = output.detach().float().cpu()
                self._handle.remove()

        def wsum(x, y, w, delta=1.0):
            out = real(x, y, w, delta)
            self.k3w.append((float(out.detach()), U.huber_rows_wsum64(x.detach(), y.detach(), w, delta)))
            if len(self.k3w) == 2:
                unroll.huber_rows_wsum = real
            return out

        self._handle = dict(model.named_modules())[module].register_forward_hook(keep)
        unroll.huber_rows_wsum = wsum

    def close(self) -> None:
        self._handle.remove()
        self._unroll.huber_rows_wsum = self._real


def setup(run):
    from mfvae_tpu_torch.data.transitions import GroupedTransition
    from mfvae_tpu_torch.training.experiment import Experiment
    from mfvae_tpu_torch.training.trainer import make_phase_fns

    cfg = run.cfg
    exp = Experiment(cfg, device=run.dev).build()
    run.mark("experiment")
    _, train_phase, _ = make_phase_fns(exp.env, exp.spec, exp.buffer, exp.test_buffer, cfg, exp.streams)
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
    outputs = R.output_modules(run.conf["model"])
    watch = FirstSteps(ts.model, ts.optimizer, w, after=FOLLOWED_STEPS, outputs=outputs)
    steps = WindowStepWatch(ts.model, outputs[0], cfg.train.unroll_steps)
    ts, _ = train_phase(ts, buf)
    run.mark("first phase")
    ts, _ = train_phase(ts, buf)
    run.state.update(exp=exp, ts=ts, buf=buf, train_phase=train_phase, watch=watch, steps=steps)


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
    transitions = steps * run.cfg.buffer.batch_size * run.cfg.train.unroll_steps
    return {"train_samples_per_s": transitions / wall}, steps, 0


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
    m, b, n, w = run.conf["model"], run.cfg.buffer.batch_size, run.cfg.train.train_num, run.cfg.train.unroll_steps
    data = {
        "attempted": (PLAIN_PHASES + PROFILED_PHASES) * n,
        "plain": {"wall_s": plain_s, "steps": PLAIN_PHASES * n},
        "profiled": {"wall_s": prof.wall_s, "steps": PROFILED_PHASES * n},
        "flops": {"train_step": flops_unroll.unroll_step_flops(m, spec.obs_dims, spec.act_dims, b, w)},
        "compute_dtype": m["compute_dtype"], "prof": prof,
        "shapes": {"batch": b, "window": w, "agents": spec.n, "sum_obs": spec.sum_obs},
    }
    return data, prof


def release(run):
    run.state["watch"].close()
    run.state["steps"].close()
    for key in ("exp", "ts", "buf", "train_phase"):
        run.state.pop(key)


def reference(run, pr: M.Precision, half_batch: bool = False):
    """The first steps of the run from the seed: (``R.Follow``, step 1's
    ``U.StepRecord``)."""
    return U.follow_steps(common.weights(run), run.conf, common.ref_spec(run.conf), _rows(run),
                          R.streams(run.seed, run.dev), pr, FOLLOWED_STEPS, half_batch)


def readings(conf: dict, prog: dict, ref) -> dict:
    """``out1`` the worst row's gap of the first forward's state output and
    reward; ``outW`` the worst row's gap of step 1's W-th forward's state
    output; ``grad`` and ``update`` the worst leaf's gap of norms (the
    first clipped gradient; the change after three steps, over the leaves
    the reference's first gradient moves); ``k3w`` the worst gap of step
    1's two pooled huber sums against the float64 weighted sum of their
    own inputs (none read: 1)."""
    follow, record = ref
    grad_r = follow.grad_norms()
    k3w = prog["k3w"]
    return {
        "out1": R.outputs_gap(prog["out"], R.output_modules(conf["model"]), follow.first_out),
        "outW": 1.0 if prog["out_w"] is None else R.row_gap(prog["out_w"], record.last),
        "grad": R.worst_leaf_gap(prog["grad"], grad_r),
        "update": R.worst_leaf_gap(prog["change"], follow.change_norms(), keep=R.moved_leaves(grad_r)),
        "k3w": max(R.rel_gap(v, v64) for v, v64 in k3w) if len(k3w) == 2 else 1.0,
    }


def check(run, pr=None, half_batch: bool = False) -> dict:
    st = run.state
    prog = dict(R.watched(st["watch"]), out_w=st["steps"].last_output, k3w=st["steps"].k3w)
    return readings(run.conf, prog, reference(run, pr or M.Precision(), half_batch))


def stand_in(run, pr: M.Precision, half_batch: bool = False) -> dict:
    """The readings of the reference put in the program's place, in the
    precision ``pr`` (the control) or with a fault, against the reference."""
    follow, record = reference(run, pr, half_batch)
    prog = dict(R.followed(run.conf, follow), out_w=record.last.cpu(), k3w=list(zip(record.k3w, record.k3w64)))
    return readings(run.conf, prog, reference(run, M.Precision()))
