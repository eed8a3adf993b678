"""The port's planning teachers and distillation trainer
(``mfvae_tpu_torch/imagination.py``) against ``mfvae_tpu/imagination.py``,
on the tiny simple_tag world model of ``tests/test_torch_imagination.py``.

Every draw is JAX's, replayed from the key the JAX function splits:
- the enumerated teacher's shared first and continuation actions
  (k_first, k_cont = split(key));
- the CEM teacher's per-iteration Gumbel noise and uniform actions
  (k_plan, k_other = split(fold_in(key, i))), and the soft teacher's one
  uniform draw;
- a distillation update's visitation rollout and teacher keys
  (k_visit, k_teach = split(key)).

Tolerances: the teachers' targets and Q rtol 1e-5 (atol 1e-6, for means
of scores near 0), their argmax labels equal; params after one Adam step
rtol 1e-5 (atol 1e-7); the update's metrics rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfvae_tpu import imagination as jimag
from mfvae_tpu_torch import imagination as timag
from mfvae_tpu_torch.imagination import CEMTeacherNoise, DistillNoise, EnumeratedNoise
from tests.test_torch_experiment import one_torch_thread  # noqa: F401
from tests.test_torch_imagination import (
    PLAN,
    P,
    _metrics_close,
    assert_state_close,
    bridge,
    jax_rollout_noise,
    starts,
)
from tests.test_torch_planning import Setup, t

H, M, NC = 3, 3, 8  # teacher horizon, enumerated rollouts, CEM candidates
K = 5


def jax_enumerated_noise(s, key, n_states):
    k_first, k_cont = jax.random.split(key)
    return EnumeratedNoise(t(s.jsample(k_first, (n_states * M,))), t(s.jsample(k_cont, (H - 1, n_states * M))))


def jax_cem_noise(s, key, n_states, iters, soft):
    if soft:
        return CEMTeacherNoise([], [t(s.jsample(key, (H, n_states * NC)))])
    gumbel, others = [], []
    for i in range(iters):
        k_plan, k_other = jax.random.split(jax.random.fold_in(key, i))
        gumbel.append(t(jax.random.gumbel(k_plan, (n_states, H, NC, P, K))))
        others.append(t(s.jsample(k_other, (H, n_states * NC))))
    return CEMTeacherNoise(gumbel, others)


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("continuation", ["hold", "random"])
def test_enumerated_teacher_matches_jax(continuation):
    s = Setup()
    kw = dict(horizon=H, m_rollouts=M, temperature=0.5, continuation=continuation, return_q=True)
    jteach = jimag.make_enumerated_teacher(s.jwm, s.jenv, s.jspec, PLAN, **kw)
    tteach = timag.make_enumerated_teacher(s.twm, s.tenv, s.tspec, PLAN, **kw)
    jobs, tobs = starts(s, 4, 1)
    key = jax.random.PRNGKey(2)
    jtargets, jq = jteach(jobs, key)
    ttargets, tq = tteach(tobs, noise=jax_enumerated_noise(s, key, 4))
    assert tuple(ttargets.shape) == tuple(tq.shape) == (4, P, K)
    close(tq, jq)
    close(ttargets, jtargets)
    np.testing.assert_array_equal(torch.argmax(ttargets, -1).numpy(), np.asarray(jnp.argmax(jtargets, -1)))


def test_enumerated_teacher_arms_differ_in_the_first_action_only():
    """Candidate m·K + a: arm a's first action for every plan agent is a,
    and under 'random' the arms of one m share every other action."""
    s = Setup()
    seen = []
    predict = s.twm._predict
    s.twm._predict = lambda batch: (seen.append(batch.actions[0]), predict(batch))[1]
    teach = timag.make_enumerated_teacher(s.twm, s.tenv, s.tspec, PLAN, horizon=H, m_rollouts=M,
                                          continuation="random")
    _, tobs = starts(s, 2, 3)
    teach(tobs, torch.Generator().manual_seed(4))
    first, later = seen[0].reshape(2, M, K, -1), seen[1].reshape(2, M, K, -1)
    arm = torch.arange(K, dtype=first.dtype)
    assert torch.equal(first[..., :P], arm[None, None, :, None].expand(2, M, K, P))
    assert torch.equal(later, later[:, :, :1].expand_as(later))


@pytest.mark.parametrize("iters", [1, 2])
def test_cem_teacher_argmax_labels_match_jax(iters):
    s = Setup()
    kw = dict(horizon=H, n_candidates=NC, iters=iters, elite_frac=0.25)
    jteach = jimag.make_cem_teacher(s.jwm, s.jenv, s.jspec, PLAN, **kw)
    tteach = timag.make_cem_teacher(s.twm, s.tenv, s.tspec, PLAN, **kw)
    jobs, tobs = starts(s, 4, 5)
    for seed in range(2):
        key = jax.random.PRNGKey(6 + seed)
        got = tteach(tobs, noise=jax_cem_noise(s, key, 4, iters, soft=False))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax.jit(jteach)(jobs, key)))


def test_cem_teacher_soft_targets_match_jax():
    s = Setup()
    kw = dict(horizon=H, n_candidates=NC, soft_temperature=0.5)
    jteach = jimag.make_cem_teacher(s.jwm, s.jenv, s.jspec, PLAN, **kw)
    tteach = timag.make_cem_teacher(s.twm, s.tenv, s.tspec, PLAN, **kw)
    jobs, tobs = starts(s, 4, 8)
    key = jax.random.PRNGKey(9)
    got = tteach(tobs, noise=jax_cem_noise(s, key, 4, 1, soft=True))
    assert tuple(got.shape) == (4, P, K)
    close(got, jteach(jobs, key))
    torch.testing.assert_close(got.sum(-1), torch.ones(4, P))


def test_teachers_refuse_continuous_actions():
    s = Setup(discrete=False)
    for make in (timag.make_cem_teacher, timag.make_enumerated_teacher):
        with pytest.raises(ValueError, match="discrete"):
            make(s.twm, s.tenv, s.tspec, PLAN)


DISTILL_CASES = {
    "enumerated": dict(teacher_mode="enumerated", m_rollouts=M),
    "enumerated centralized": dict(teacher_mode="enumerated", m_rollouts=M, centralized=True),
    "cem argmax": dict(teacher_mode="cem", n_candidates=NC, cem_iters=2, elite_frac=0.25),
    "cem soft": dict(teacher_mode="cem", n_candidates=NC, target_mode="soft"),
}


@pytest.mark.parametrize("case", sorted(DISTILL_CASES))
def test_distillation_update_matches_jax(case):
    s = Setup()
    kw = dict(horizon=H, visit_steps=2, hidden=(16,), learning_rate=1e-3, **DISTILL_CASES[case])
    _, jinit, jupdate = jimag.make_distillation_trainer(s.jwm, s.jenv, s.jspec, PLAN, **kw)
    tinit, tupdate = timag.make_distillation_trainer(s.twm, s.tenv, s.tspec, PLAN, **kw)
    n_starts = 3
    jobs, tobs = starts(s, n_starts, 10)
    jparams, jopt = jinit(jax.random.PRNGKey(11), jobs[0][0, 0])
    tparams, topt = tinit(torch.Generator().manual_seed(11))
    tparams.load_state_dict(bridge(jparams))
    key = jax.random.PRNGKey(12)
    jp, _, jm = jupdate(jparams, jopt, jobs, key)
    k_visit, k_teach = jax.random.split(key)
    n_all = n_starts * (1 + kw["visit_steps"])
    if kw["teacher_mode"] == "enumerated":
        teacher = jax_enumerated_noise(s, k_teach, n_all)
    else:
        teacher = jax_cem_noise(s, k_teach, n_all, kw.get("cem_iters", 2), soft="target_mode" in kw)
    noise = DistillNoise(jax_rollout_noise(s, k_visit, kw["visit_steps"], n_starts, True), teacher)
    tm = tupdate(tparams, topt, tobs, noise=noise)
    assert_state_close(tparams, jp)
    _metrics_close(tm, jm)


def test_distillation_with_its_own_draws_trains():
    s = Setup()
    init_fn, update_fn = timag.make_distillation_trainer(
        s.twm, s.tenv, s.tspec, PLAN, horizon=H, visit_steps=1, hidden=(16,), teacher_mode="enumerated",
        m_rollouts=2)
    g = torch.Generator().manual_seed(13)
    params, opt = init_fn(g)
    _, tobs = starts(s, 4, 14)
    for _ in range(3):
        m = update_fn(params, opt, tobs, g)
        assert all(np.isfinite(float(v)) for v in m.values()), m
    assert all(p.grad is None for p in s.twm.model.parameters())


# ---------------------------------------------------------- spans, counters
V, S = 2, 3  # visit steps and starts of the traced updates
TRACED = {
    "enumerated": dict(teacher_mode="enumerated", m_rollouts=M),
    "cem": dict(teacher_mode="cem", n_candidates=NC, cem_iters=2, elite_frac=0.25),
}


def _one_update(case):
    s = Setup()
    init_fn, update_fn = timag.make_distillation_trainer(s.twm, s.tenv, s.tspec, PLAN, horizon=H, visit_steps=V,
                                                         hidden=(16,), **TRACED[case])
    g = torch.Generator().manual_seed(13)
    params, opt = init_fn(g)
    _, tobs = starts(s, S, 14)
    return lambda: update_fn(params, opt, tobs, g)


@pytest.mark.parametrize("case", sorted(TRACED))
def test_a_distill_update_counts_its_steps_rows_and_teacher_calls(case):
    """``imagine.steps``: V visit steps and H a teacher round (2 CEM
    rounds); ``imagine.rows``: S a visit step and the teacher's S·(1+V)
    states times its candidates (M·K, or N) a teacher step;
    ``teacher.calls``: one."""
    from mfvae_tpu_torch.utils import profiling

    update = _one_update(case)
    before = profiling.counters()
    update()
    after = profiling.counters()
    got = {k: after.get(k, 0) - before.get(k, 0) for k in ("imagine.steps", "imagine.rows", "teacher.calls")}
    rounds, candidates = (1, M * K) if case == "enumerated" else (2, NC)
    assert got == {"imagine.steps": V + rounds * H, "imagine.rows": S * V + rounds * H * S * (1 + V) * candidates,
                   "teacher.calls": 1}


def test_a_distill_update_holds_its_spans_under_the_profiler():
    """One ``mfvae.behavior.update`` around one each of ``distill.visit``,
    ``distill.teacher`` and ``distill.fit``, in that order; V
    ``imagine.step`` spans in the visit and H in the teacher."""
    from torch.profiler import ProfilerActivity, profile

    update = _one_update("enumerated")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        update()
    spans = sorted((e.time_range.start, e.time_range.end, e.name[len("mfvae."):]) for e in prof.events()
                   if e.name.startswith("mfvae."))
    named = lambda n: [(lo, hi) for lo, hi, name in spans if name == n]  # noqa: E731
    (outer,) = named("behavior.update")
    (visit,), (teach,), (fit,) = named("distill.visit"), named("distill.teacher"), named("distill.fit")
    assert outer[0] <= visit[0] <= visit[1] <= teach[0] <= teach[1] <= fit[0] <= fit[1] <= outer[1]
    steps = named("imagine.step")
    assert sum(visit[0] <= lo and hi <= visit[1] for lo, hi in steps) == V
    assert sum(teach[0] <= lo and hi <= teach[1] for lo, hi in steps) == H
    assert len(steps) == V + H

