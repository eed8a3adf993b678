"""The distill cell (``tag_behavior.distill_s32``) on the CPU at a size a
test run holds: a sound run of the ``distill`` driver is correct against
``benchmark/reference/distill.py`` under the cell's own limits, and at
float32 it agrees with the reference far inside them; with the timed path
broken underneath it, once for each fault an update can have (a teacher
that drops one arm: its last arm rolls out the plan of the one before; the
cross-entropy over half the labelled states; the wrong temperature), it
is not correct; the fp8 control fails ``q`` and the reference's
half-batch fault moves the gradient alone.  Besides: the frozen FLOPs of
``benchmark/flops_distill.py`` equal ``torch.utils.flop_counter``'s count
of one small update, a traced run gives the one-step cell's host-side
readers and the two new readers what they read, and each new reader reads
nothing on a trace with a wrong count of its spans."""

import time

import pytest
import torch

from benchmark import common, flops_distill, harness
from benchmark.reference import model as M

CELL = "tag_behavior.distill_s32"
# nine agents at narrow widths; S = 4 starts of a 64-row pool, V = 2, M = 3, H = 3
SMALL = ["env.num_adversaries=6", "env.num_good_agents=3", "env.num_obs=3",
         "model.idx_features=16", "model.obs_features=16", "model.action_features=16",
         "model.encoder_hidden=[32,32]", "model.decoder_hidden=[64,32,64]", "model.det_features=16",
         "buffer.max_size=256", "buffer.min_size=8",
         "behavior.start_pool=64", "behavior.start_burn_in=4", "behavior.n_starts=4", "behavior.visit_steps=2",
         "behavior.m_rollouts=3", "behavior.horizon=3", "behavior.hidden=[32,32]"]
SEED = 3_000_000_019
CPU = torch.device("cpu")


def small_run(overrides=(), trace=False):
    return harness.run_cell(CELL, SEED, 0.5, trace, time.perf_counter(), dev=CPU, overrides=SMALL + list(overrides))


def test_a_sound_run_is_correct():
    out = small_run()
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"q", "logits1", "grad", "update"}
    assert out["metrics"]["train_samples_per_s"]["value"] > 0


def test_at_float32_the_program_follows_the_reference():
    out = small_run(["model.compute_dtype=float32"])
    assert all(c["value"] < 1e-4 for c in out["checks"].values()), out["checks"]


def _teacher_drops_an_arm(monkeypatch):
    from mfvae_tpu_torch import imagination

    real = imagination._imagine

    def dropped(wm, group_actions, obs_g, full_plan):
        plan = full_plan.clone()
        adversaries = plan[..., :6]
        adversaries[adversaries == 4] = 3
        return real(wm, group_actions, obs_g, plan)

    monkeypatch.setattr(imagination, "_imagine", dropped)


def _half_the_states_in_the_loss(monkeypatch):
    from mfvae_tpu_torch import imagination

    class HalfMean:
        """``torch`` as the imagination module sees it, but a mean over
        every element of a tensor that carries a gradient (the
        cross-entropy's) takes the first half of its rows only."""

        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def mean(x, *args, **kwargs):
            if not args and not kwargs and x.requires_grad:
                x = x[: x.shape[0] // 2]
            return torch.mean(x, *args, **kwargs)

    monkeypatch.setattr(imagination, "torch", HalfMean())


def _wrong_temperature(monkeypatch):
    from mfvae_tpu_torch import behavior

    real = behavior.make_distillation_trainer
    monkeypatch.setattr(behavior, "make_distillation_trainer", lambda *a, **k: real(*a, **{**k, "temperature": 1.0}))


FAULTS = [_teacher_drops_an_arm, _half_the_states_in_the_loss, _wrong_temperature]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[1:] for f in FAULTS])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = small_run()
    assert not out["correct"], out["checks"]


def test_the_watch_restores_the_program_when_an_update_raises():
    from mfvae_tpu_torch import imagination

    calls = imagination.ImaginationRollout.__call__, imagination.EnumeratedTeacher.__call__
    policy = torch.nn.Linear(2, 2)
    driver = common.load_module("drivers", "distill")
    with pytest.raises(RuntimeError, match="an update failed"):
        with driver.DistillWatch(policy):
            assert imagination.ImaginationRollout.__call__ is not calls[0]
            raise RuntimeError("an update failed")
    assert (imagination.ImaginationRollout.__call__, imagination.EnumeratedTeacher.__call__) == calls
    assert not policy._forward_hooks


def test_the_policy_starts_from_the_benchmarks_draw():
    run = harness.Run(CELL, SEED, CPU, SMALL)
    driver = common.load_module("drivers", run.work["driver"])
    _, _, policy, _, _, inputs = driver._program(run)
    drawn = driver.policy_weights(run, policy)
    assert set(drawn) == set(policy.state_dict())
    for k, v in policy.state_dict().items():
        assert torch.equal(v, drawn[k]) and torch.equal(inputs["policy"][k], drawn[k]), k


def _stand_in(pr, half_batch=False):
    run = harness.Run(CELL, SEED, CPU, SMALL)
    driver = common.load_module("drivers", run.work["driver"])
    return driver.stand_in(run, pr, half_batch=half_batch), run.work["limits"]


def test_the_fp8_control_fails_q():
    readings, limits = _stand_in(M.Precision(fp8=True))
    assert readings["q"] > limits["q"], readings


def test_the_reference_fault_moves_the_gradient_alone():
    readings, limits = _stand_in(M.Precision(), half_batch=True)
    assert readings["q"] == readings["logits1"] == 0.0, readings
    assert readings["grad"] > limits["grad"], readings


def test_update_flops_equal_the_flop_counters_count():
    from torch.utils.flop_counter import FlopCounterMode

    run = harness.Run(CELL, SEED, CPU, SMALL)
    driver = common.load_module("drivers", run.work["driver"])
    _, update_fn, policy, opt, gen, inputs = driver._program(run)
    starts = tuple(o[: run.cfg.behavior.n_starts] for o in inputs["pool"])
    with FlopCounterMode(display=False) as counter:
        update_fn(policy, opt, starts, gen)
    assert counter.get_total_flops() == flops_distill.update_flops(run.conf, common.ref_spec(run.conf))


def test_update_flops_at_the_cells_shapes():
    conf = common.config_dict("tag_behavior")
    assert flops_distill.update_flops(conf, common.ref_spec(conf)) == 10_695_604_875_264


def _data(host=(), updates=2):
    prof = common.Profiled(CPU)
    prof.host = sorted(host)
    return {"prof": prof, "profiled": {"steps": updates, "wall_s": 1.0}, "plain": {"steps": 4, "wall_s": 2.0},
            "flops": {"train_step": 1.0e12}, "compute_dtype": "bfloat16",
            "shapes": {"visit_steps": 2, "horizon": 3}}


READERS = ["imagine_step_host_ms.distill", "distill_fit_host_ms.distill"]
TRAIN_READERS = ["mfu_pct.train", "kernels_per_step.train", "idle_pct.train"]


def _read(metric, data):
    return common.load_module("metrics", metric).read(data)


def test_the_readers_on_a_hand_made_trace():
    steps = [(100.0 * i, 100.0 * i + 20.0 + i, "mfvae.imagine.step") for i in range(10)]  # (V + H) × 2 updates
    fits = [(2000.0, 2500.0, "mfvae.distill.fit"), (3000.0, 3700.0, "mfvae.distill.fit")]
    others = [(0.0, 5000.0, "mfvae.behavior.update"), (10.0, 15.0, "aten::mm")]
    data = _data(steps + fits + others)
    assert _read("imagine_step_host_ms.distill", data) == pytest.approx((20 * 10 + 45) * 1e-3 / 10)
    assert _read("distill_fit_host_ms.distill", data) == pytest.approx((500 + 700) * 1e-3 / 2)


@pytest.mark.parametrize("metric,host", [
    ("imagine_step_host_ms.distill", [(10.0 * i, 10.0 * i + 5.0, "mfvae.imagine.step") for i in range(9)]),
    ("imagine_step_host_ms.distill", []),
    ("distill_fit_host_ms.distill", [(0.0, 5.0, "mfvae.distill.fit")]),
    ("distill_fit_host_ms.distill", [(0.0, 5.0, "mfvae.train.forward")]),
], ids=["step_missing", "no_step", "fit_missing", "no_fit"])
def test_a_reader_reads_nothing_on_a_wrong_count(metric, host):
    assert _read(metric, _data(host)) is None


def test_a_traced_run_reads_the_host_side_metrics():
    """On the CPU the trace has no device operations, so the device readers
    read nothing; those of the host clock and of host spans read a value."""
    bench = common.load_json(common.ROOT / "BENCHMARK.json")
    listed = {m["name"] for m in bench["per_layer"] if CELL in m.get("workloads", [CELL])}
    assert listed == set(READERS) | set(TRAIN_READERS)
    out = small_run(trace=True)
    assert set(out["metrics"]) == {"mfu_pct.train"} | set(READERS), out["metrics"]
    assert all(m["value"] > 0 for m in out["metrics"].values()), out["metrics"]
    assert out["correct"], out["checks"]
