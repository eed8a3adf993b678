"""Behavior learned in imagination: the distill stage of
``examples/behavior_policy.yaml`` (``behavior.make_behavior_trainer``'s
``update_fn``: the visitation rollout of V steps from S starts, the
enumerated teacher's S·(1+V)·M·K closed-loop rollouts of H steps through
``WorldModel._predict``, the policy's fit and one Adam step) back to
back, as ``behavior.train_behavior`` runs it: each update draws
``randperm(pool)[:S]`` start rows from the pool on the device, then calls
``update_fn`` with the same generator.  Unlike ``train_behavior`` the
loop reads no metrics back.

Set-up builds the experiment from the configuration, gives the world
model the benchmark's weights, wraps it in ``WorldModel``, collects the
start pool (``behavior.collect_start_states``: the configuration's sticky
collection over ``start_pool`` episodes after ``start_burn_in`` steps)
and runs ``init_fn``, all from one generator seeded from the run's seed;
then it loads the benchmark's own draw of the policy's weights
(``policy_weights``) over the program's, and runs three updates through
the window's own call.  The reference (``benchmark/reference/distill.py``)
follows those three from the same pool, the same first weights of the
policy and the generator's state after ``init_fn``; the second and third
are the warm-up, and no hook is left in the measured window.  The pool
is the one input the program prepares: states of the port's own env
under its collection policy, handed to both sides as they are (the env
is held to the JAX package's by the CPU tests).  ``train_samples_per_s``
counts labelled states: updates × S·(1+V) over the window's wall, the
window ending in a device sync.

Hooks on the first three updates (``DistillWatch``) keep the plan
agents' visit actions, the teacher's labelled states, Q and targets, and
the first fit's logits; set-up keeps the policy's first gradient (left on
its leaves by the first update) and its change after the third.  The
reference takes the program's visit actions, and compares the logits
behind them (``logits1``).

Traced: updates timed on the host clock (the MFU) and updates under the
profiler (kernels an update, the idle share, the host time of an
imagined world-model step and of the policy's fit).  The data has the
one-step ``train_phase`` driver's keys, a step being an update, so its
readers (``mfu_pct.train``, ``kernels_per_step.train``,
``idle_pct.train``) read this cell too; ``flops["train_step"]`` is an
update's (``benchmark/flops_distill.py``).
"""

from __future__ import annotations

import time

import torch

from benchmark import common, flops_distill
from benchmark.reference import distill as D
from benchmark.reference import model as M
from benchmark.reference import train as R

PLAIN_UPDATES, PROFILED_UPDATES = 8, 2
FOLLOWED_UPDATES = 3  # the reference's updates: the update check reads the change after update 3
BEHAVIOR_STREAM = 104  # the pool's collection, init_fn and every update's draws
POLICY_STREAM = 105  # the policy's first weights


class DistillWatch:
    """The program's updates from outside, while the watch is entered
    (``with DistillWatch(policy) as watch``): each visitation rollout's
    plan-agent actions [V, S, P] (read from the joint actions it hands the
    world model), each enumerated-teacher call's labelled states (per
    group [S', A_g, od]), Q and targets [S', P, K] (the teacher run with
    ``return_q``), and the logits of the policy's first call with autograd
    on, the first fit [S', P, K].  Leaving it restores both classes' calls
    and removes the policy's hook, also when an update raises."""

    def __init__(self, policy: torch.nn.Module):
        self.policy = policy
        self.choices: list = []
        self.labelled: list = []
        self.q: list = []
        self.targets: list = []
        self.logits1 = None

    def __enter__(self) -> "DistillWatch":
        from mfvae_tpu_torch import imagination

        self._cls = imagination.ImaginationRollout, imagination.EnumeratedTeacher
        self._real = real_visit, real_teach = tuple(c.__call__ for c in self._cls)

        def visit(rollout, *args, **kwargs):
            group, taken = rollout.group_actions, []

            def keep(full):
                taken.append(full[:, :rollout.p].clone())
                return group(full)

            rollout.group_actions = keep
            try:
                return real_visit(rollout, *args, **kwargs)
            finally:
                rollout.group_actions = group
                self.choices.append(torch.stack(taken))

        def teach(teacher, obs_g, *args, **kwargs):
            asked = teacher.return_q
            teacher.return_q = True
            try:
                targets, q = real_teach(teacher, obs_g, *args, **kwargs)
            finally:
                teacher.return_q = asked
            self.labelled.append(tuple(o.clone() for o in obs_g))
            self.q.append(q.clone())
            self.targets.append(targets.clone())
            return (targets, q) if asked else targets

        def fit(module, args, output):
            if torch.is_grad_enabled():
                self.logits1 = output.detach().clone()
                self._handle.remove()

        self._handle = self.policy.register_forward_hook(fit)
        self._cls[0].__call__, self._cls[1].__call__ = visit, teach
        return self

    def __exit__(self, *exc) -> None:
        self._cls[0].__call__, self._cls[1].__call__ = self._real
        self._handle.remove()


def policy_weights(run, policy: torch.nn.Module) -> dict:
    """The policy's first weights, drawn by the benchmark in
    ``common.make_weights``'s scheme (kernels by 1/sqrt(fan in), LayerNorm
    scales 1 + 0.1·N, biases 0.05·N) from a seed of their own, so that
    neither side starts from the program's initialiser."""
    shapes = {k: tuple(v.shape) for k, v in policy.state_dict().items()}
    return common.make_weights(shapes, common.generator(run.seed, POLICY_STREAM, "cpu").initial_seed(), run.dev)


def _program(run):
    """The program's set-up from the seed -> (experiment, update_fn,
    policy, its Adam, the generator, the reference's inputs: the pool,
    the policy's first weights and the generator's state after
    ``init_fn``)."""
    from mfvae_tpu_torch import behavior
    from mfvae_tpu_torch.inference import WorldModel
    from mfvae_tpu_torch.training.experiment import Experiment

    cfg = run.cfg
    exp = Experiment(cfg, device=run.dev).build()
    run.mark("experiment")
    exp.carry.train_state.model.load_state_dict(common.weights(run), strict=True)
    run.mark("weights")
    wm = WorldModel(exp.carry.train_state.model)
    init_fn, update_fn = behavior.make_behavior_trainer(exp, wm, behavior.resolve_plan_agents(exp, cfg.behavior))
    gen = common.generator(run.seed, BEHAVIOR_STREAM, run.dev)
    pool = behavior.collect_start_states(exp, cfg.behavior, gen)
    run.mark("pool")
    policy, opt = init_fn(gen)
    first = policy_weights(run, policy)
    policy.load_state_dict(first, strict=True)
    return exp, update_fn, policy, opt, gen, {"pool": pool, "policy": first, "gen_state": gen.get_state()}


def setup(run):
    exp, update_fn, policy, opt, gen, inputs = _program(run)
    run.state.update(exp=exp, update_fn=update_fn, policy=policy, opt=opt, pool=inputs["pool"], gen=gen,
                     inputs=inputs, shape=D.shape(run.conf, common.ref_spec(run.conf)))
    with DistillWatch(policy) as watch:
        for i in range(FOLLOWED_UPDATES):
            _update(run)
            if i == 0:  # the update's gradient stays on the leaves until the next update
                run.state["grad1"] = {k: p.grad.detach().clone() for k, p in policy.named_parameters()}
    run.state["watch"] = watch
    run.state["change"] = R.leaf_norms({k: p.detach() - inputs["policy"][k] for k, p in policy.named_parameters()})


def _update(run):
    st = run.state
    idx = torch.randperm(st["pool"][0].shape[0], generator=st["gen"], device=run.dev)[:st["shape"].starts]
    st["update_fn"](st["policy"], st["opt"], tuple(o[idx] for o in st["pool"]), st["gen"])


def _labelled(run) -> int:
    sh = run.state["shape"]
    return sh.starts * (1 + sh.visit_steps)


def window(run, seconds: float):
    updates = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        _update(run)
        updates += 1
    common.sync(run.dev)
    wall = time.perf_counter() - t0
    return {"train_samples_per_s": updates * _labelled(run) / wall}, updates, 0


def trace(run):
    dev = run.dev
    common.sync(dev)
    t0 = time.perf_counter()
    for _ in range(PLAIN_UPDATES):
        _update(run)
    common.sync(dev)
    plain_s = time.perf_counter() - t0

    def profiled():
        for _ in range(PROFILED_UPDATES):
            with common.span("update"):
                _update(run)

    prof = common.Profiled(dev).run(profiled)
    sh = run.state["shape"]
    data = {
        "attempted": PLAIN_UPDATES + PROFILED_UPDATES,
        "plain": {"wall_s": plain_s, "steps": PLAIN_UPDATES},
        "profiled": {"wall_s": prof.wall_s, "steps": PROFILED_UPDATES},
        "flops": {"train_step": flops_distill.update_flops(run.conf, common.ref_spec(run.conf))},
        "compute_dtype": run.conf["model"]["compute_dtype"], "prof": prof,
        "shapes": {"visit_steps": sh.visit_steps, "horizon": sh.horizon},
    }
    return data, prof


def release(run):
    for key in ("exp", "update_fn", "policy", "opt", "gen"):
        run.state.pop(key)


def reference(run, pr: M.Precision, choices=None, half_batch: bool = False) -> D.Record:
    """The first updates of the run from its inputs, in ``pr``."""
    inputs = run.state["inputs"]
    gen = torch.Generator(device=run.dev)
    gen.set_state(inputs["gen_state"])
    return D.follow_updates(common.weights(run), run.conf, common.ref_spec(run.conf), inputs["pool"],
                            inputs["policy"], gen, pr, FOLLOWED_UPDATES, choices=choices, half_batch=half_batch)


def _gap(prog, ref: torch.Tensor) -> float:
    return 1.0 if prog is None else R.row_gap(prog, ref)


def leaf_gap(prog, ref) -> float:
    """max over leaves of ‖prog - ref‖ / max(‖ref‖, the median leaf's
    ‖ref‖): the gap of the vectors, which sees a gradient of the right size
    pointing elsewhere; a leaf the program did not give reads 1."""
    norms = R.leaf_norms(ref)
    floor = R.median(norms.values())
    return max(float(torch.linalg.vector_norm(prog[k].to(v.device).double() - v.double())) / max(norms[k], floor, 1e-30)
               if k in prog else 1.0 for k, v in ref.items())


def readings(prog: dict, ref: D.Record) -> dict:
    """``q`` the worst (state, plan agent) row's gap of update 1's teacher
    Q over the arms; ``logits1`` the worst row's gap of the first fit's
    logits (the policy on update 1's labelled states); ``grad`` the worst
    policy leaf's gap of the first gradient (``leaf_gap``: the vectors,
    where a gap of norms could not tell half the states left out of the
    loss from rounding); ``update`` the worst leaf's gap of norms of the
    change after three updates, over the leaves the reference's first
    gradient moves.  A number the program did not give reads 1."""
    return {
        "q": _gap(prog["q"], ref.q[0]),
        "logits1": _gap(prog["logits1"], ref.logits1),
        "grad": leaf_gap(prog["grad"], ref.follow.first_grad),
        "update": R.worst_leaf_gap(prog["change"], ref.follow.change_norms(),
                                   keep=R.moved_leaves(ref.follow.grad_norms())),
    }


def check(run) -> dict:
    st = run.state
    watch = st["watch"]
    prog = {"q": watch.q[0] if watch.q else None, "logits1": watch.logits1, "grad": st["grad1"],
            "change": st["change"]}
    choices = watch.choices if len(watch.choices) == FOLLOWED_UPDATES else None
    return readings(prog, reference(run, M.Precision(), choices))


def stand_in(run, pr: M.Precision, half_batch: bool = False) -> dict:
    """The readings of the reference put in the program's place, in the
    precision ``pr`` (the control) or with a fault, against the reference
    on the same choices.  The inputs come from the program's set-up
    (the pool, and the policy's first weights as the benchmark draws
    them), which runs no update."""
    exp, update_fn, policy, opt, gen, run.state["inputs"] = _program(run)
    del exp, update_fn, policy, opt, gen
    stand = reference(run, pr, half_batch=half_batch)
    prog = {"q": stand.q[0], "logits1": stand.logits1, "grad": stand.follow.first_grad,
            "change": stand.follow.change_norms()}
    return readings(prog, reference(run, M.Precision(), stand.choices))
