"""The port's distillation update (``behavior.make_behavior_trainer`` over
``examples/behavior_policy.yaml``'s switches, ``imagination.py``) against
the plain float32 reference of the benchmark
(``benchmark/reference/distill.py``), which imports nothing of the port.

A small simple_tag (3 adversaries, 1 prey, 2 obstacles) under the
``tag_behavior`` configuration's model switches (det features, residual
state, state skip, decoder LayerNorm, unfused decoders) at narrow widths,
a float32 model on seeded random weights (``benchmark.common.weights``),
S = 2 starts, V = 2 visit steps, M = 3 rollouts, H = 3 steps.  The
program runs three updates from the driver's set-up (its own pool and
generator, the policy's first weights drawn by the benchmark), as the
benchmark's driver does; the reference follows them
from the same pool, policy and generator state, drawing the same numbers
in the same order, with its own visit choices.  They agree on the visit
actions (equal), the labelled states, Q, the targets, the first fit's
logits, every update's gradient and the policy after three Adam steps.

Tolerances (float32 on both sides; the reference's LayerNorm takes the
mean of squared deviations where the port takes E[x²] - mean², and the
reference sums in its own order): states and logits atol 1e-5 on values
of order 1; Q atol 1e-4, a sum of H distances of order 1 each, averaged
over M; targets atol 1e-5, a softmax of standardized Q; gradients rtol
1e-4 (atol 1e-7); the policy after three updates atol 1e-6, three Adam
steps of lr 3e-4 whose direction is the gradient's sign where it is
large.
"""

import pytest
import torch

from benchmark import common, harness
from benchmark.reference import distill as D
from benchmark.reference import model as M
from tests.test_torch_experiment import one_torch_thread  # noqa: F401

CELL = "tag_behavior.distill_s32"
SMALL = ["env.num_adversaries=3", "env.num_good_agents=1", "env.num_obs=2",
         "model.idx_features=8", "model.obs_features=8", "model.action_features=8",
         "model.encoder_hidden=[16,16]", "model.decoder_hidden=[32,16,32]", "model.det_features=8",
         "model.compute_dtype=float32", "buffer.max_size=64", "buffer.min_size=8", "train.sample_num=32",
         "behavior.start_pool=16", "behavior.start_burn_in=3", "behavior.n_starts=2", "behavior.visit_steps=2",
         "behavior.m_rollouts=3", "behavior.horizon=3", "behavior.hidden=[16,16]"]
UPDATES = 3
CPU = torch.device("cpu")


def _follow(continuation):
    """(the program's record, the reference's) over the first updates."""
    run = harness.Run(CELL, 1_000_000_007, CPU, SMALL + [f"behavior.continuation={continuation}"])
    driver = common.load_module("drivers", "distill")
    exp, update_fn, policy, opt, gen, inputs = driver._program(run)
    pool, grads = inputs["pool"], []
    with driver.DistillWatch(policy) as watch:
        for _ in range(UPDATES):
            idx = torch.randperm(pool[0].shape[0], generator=gen)[: run.cfg.behavior.n_starts]
            update_fn(policy, opt, tuple(o[idx] for o in pool), gen)
            grads.append({k: p.grad.clone() for k, p in policy.named_parameters()})
    after = {k: v.detach().clone() for k, v in policy.state_dict().items()}
    prog = {"choices": watch.choices, "labelled": watch.labelled, "q": watch.q, "targets": watch.targets,
            "logits1": watch.logits1, "grads": grads, "after": after}
    ref_gen = torch.Generator()
    ref_gen.set_state(inputs["gen_state"])
    rec = D.follow_updates(common.weights(run), run.conf, common.ref_spec(run.conf), inputs["pool"], inputs["policy"],
                           ref_gen, M.Precision(), UPDATES)
    return prog, rec


@pytest.fixture(scope="module", params=["hold", "random"])
def followed(request, one_torch_thread):  # noqa: F811
    return _follow(request.param)


def _close(got, want, atol, rtol=0.0):
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


def test_the_visit_takes_the_same_actions(followed):
    prog, rec = followed
    assert len(prog["choices"]) == UPDATES
    for got, want in zip(prog["choices"], rec.choices):
        assert torch.equal(got.long(), want.long())


def test_the_labelled_states_agree(followed):
    prog, rec = followed
    for got, want in zip(prog["labelled"], rec.labelled):
        for g, w in zip(got, want):
            _close(g, w, 1e-5)


def test_q_agrees(followed):
    prog, rec = followed
    for got, want in zip(prog["q"], rec.q):
        _close(got, want, 1e-4)


def test_the_targets_agree(followed):
    prog, rec = followed
    for got, want in zip(prog["targets"], rec.targets):
        _close(got, want, 1e-5)


def test_the_first_fits_logits_agree(followed):
    prog, rec = followed
    _close(prog["logits1"], rec.logits1, 1e-5)


def test_every_updates_gradient_agrees(followed):
    prog, rec = followed
    for got, want in zip(prog["grads"], rec.grads):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], 1e-7, 1e-4)


def test_the_policy_after_three_updates_agrees(followed):
    prog, rec = followed
    for k, want in rec.follow.params_after.items():
        _close(prog["after"][k], want, 1e-6)
