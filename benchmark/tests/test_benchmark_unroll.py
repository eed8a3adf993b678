"""The unroll cell (``tag_unroll.train_w8``) on the CPU at a size a test run
holds: a sound run of the ``unroll_phase`` driver is correct against
``benchmark/reference/unroll.py`` under the cell's own limits, and at
float32 it agrees with the reference far inside them; with the timed path
broken underneath it, once for each fault an unroll step can have
(teacher forcing: the stored next observation fed back in place of the
prediction; K3w ignoring its weights; the clip left out; half of the
windows left out of the batch; half of the windows left out of the loss
alone, which only the gradient and the update can see), it is not
correct; the fp8 control fails a number.  Besides: the reference's window
draw is the program's, the frozen FLOPs of ``benchmark/flops_unroll.py``
equal the program's ``step_flops``, a traced run gives the one-step
cell's readers what they read, and each new reader reads nothing on a
trace without its spans or kernels."""

import time

import pytest
import torch

from benchmark import common, flops_unroll, harness
from benchmark.reference import model as M
from benchmark.reference import unroll as U

CELL = "tag_unroll.train_w8"
# nine agents at narrow widths; W = 8 over 32-row blocks of a 256-row ring
SMALL = ["env.num_adversaries=6", "env.num_good_agents=3", "env.num_obs=3",
         "model.idx_features=16", "model.obs_features=16", "model.action_features=16",
         "model.encoder_hidden=[32,32]", "model.decoder_hidden=[64,32,64]", "model.det_features=16",
         "buffer.max_size=256", "buffer.min_size=8", "train.sample_num=32", "train.train_num=4", "train.test_num=2",
         "train.batch_size=32", "buffer.batch_size=32"]
SEED = 3_000_000_019
CPU = torch.device("cpu")


def small_run(overrides=(), trace=False):
    return harness.run_cell(CELL, SEED, 0.5, trace, time.perf_counter(), dev=CPU, overrides=SMALL + list(overrides))


def test_a_sound_run_is_correct():
    out = small_run()
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"out1", "outW", "grad", "update", "k3w"}
    assert out["metrics"]["train_samples_per_s"]["value"] > 0


def test_at_float32_the_program_follows_the_reference():
    out = small_run(["model.compute_dtype=float32"])
    assert all(c["value"] < 1e-4 for c in out["checks"].values()), out["checks"]


def _wrap_step(monkeypatch, wrap):
    from mfvae_tpu_torch.training import unroll

    real = unroll.make_unroll_train_step
    monkeypatch.setattr(unroll, "make_unroll_train_step", lambda *a, **k: wrap(real(*a, **k)))


def _teacher_forcing(monkeypatch):
    from mfvae_tpu_torch.training import unroll

    seen = {}

    def wrap(step):
        def forced(state, wbatch, *args, **kwargs):
            seen.update(wbatch=wbatch, t=0)
            return step(state, wbatch, *args, **kwargs)
        return forced

    def stored(spec, fb):
        seen["t"] += 1
        return tuple(o[:, seen["t"] - 1] for o in seen["wbatch"].next_obs)

    _wrap_step(monkeypatch, wrap)
    monkeypatch.setattr(unroll, "state_to_grouped", stored)


def _k3w_ignores_weights(monkeypatch):
    from mfvae_tpu_torch.ops import fused_elbo

    real = fused_elbo._huber_rows_wsum_plain
    monkeypatch.setattr(fused_elbo, "_huber_rows_wsum_plain",
                        lambda x, y, w, delta=1.0: real(x, y, torch.ones_like(w), delta))


def _no_clip(monkeypatch):
    from mfvae_tpu_torch.training import trainer

    monkeypatch.setattr(trainer, "_clip_by_global_norm", lambda *a, **k: None)


def _half_windows(monkeypatch):
    from mfvae_tpu_torch.data.transitions import GroupedTransition

    def wrap(step):
        def half(state, wbatch, generator=None, eps=None, eps_shared=None):
            h = wbatch.done.shape[0] // 2
            cut = GroupedTransition(*(tuple(x[:h] for x in f) if isinstance(f, tuple) else f[:h] for f in wbatch))
            return step(state, cut, generator, None if eps is None else eps[:, :h],
                        None if eps_shared is None else eps_shared[:, :h])
        return half

    _wrap_step(monkeypatch, wrap)


def _half_windows_in_the_loss(monkeypatch):
    from mfvae_tpu_torch.training import unroll

    class FirstMaskHalved:
        """``torch`` as the unroll module sees it, but the slot mask starts
        at 0 for the second half of the windows: their forwards run, their
        slots weigh nothing in the pools and their denominators."""

        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def ones_like(x, **kwargs):
            out = torch.ones_like(x, **kwargs)
            out[x.shape[0] // 2:] = 0.0
            return out

    monkeypatch.setattr(unroll, "torch", FirstMaskHalved())


FAULTS = [_teacher_forcing, _k3w_ignores_weights, _no_clip, _half_windows, _half_windows_in_the_loss]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[1:] for f in FAULTS])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = small_run()
    assert not out["correct"], out["checks"]


def test_half_the_windows_left_out_of_the_loss_is_seen_by_the_gradient_alone(monkeypatch):
    _half_windows_in_the_loss(monkeypatch)
    checks = small_run()["checks"]
    failed = {k for k, c in checks.items() if not c["value"] <= c["limit"]}
    assert failed == {"grad"}, checks  # Adam's step scales the change alike: update does not see it


def test_the_reference_fault_leaves_the_outputs_alone():
    run = harness.Run(CELL, SEED, CPU, SMALL)
    driver = common.load_module("drivers", run.work["driver"])
    readings = driver.stand_in(run, M.Precision(), half_batch=True)
    limits = run.work["limits"]
    assert readings["out1"] == readings["outW"] == 0.0 and readings["k3w"] <= limits["k3w"], readings
    assert readings["grad"] > limits["grad"], readings


def test_the_fp8_control_fails_a_number():
    run = harness.Run(CELL, SEED, CPU, SMALL)
    driver = common.load_module("drivers", run.work["driver"])
    readings = driver.stand_in(run, M.Precision(fp8=True))
    assert not harness.verdict(readings, run.work["limits"]), readings


def test_the_window_draw_is_the_programs():
    from mfvae_tpu_torch.data.buffer import ItemBuffer

    cap, block, w, n = 256, 32, 8, 64
    buf = ItemBuffer(max_length=cap, min_length=1, sample_batch_size=n)
    st = buf.add_batch(buf.init(torch.zeros((), dtype=torch.int64)), torch.arange(cap))
    got = buf.sample_window(st, torch.Generator().manual_seed(5), w, block=block).experience
    starts = U.draw_starts(cap, block, w, n, torch.Generator().manual_seed(5))
    assert torch.equal(got, (starts[:, None] + torch.arange(w)) % cap)


def test_slot_masks_end_after_the_first_done():
    done = torch.tensor([[0.0, 1.0, 0.0, 1.0], [1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]])
    assert U.slot_masks(done).tolist() == [[1, 1, 0, 0], [1, 0, 0, 0], [1, 1, 1, 1]]


def test_unroll_step_flops_equal_the_programs_count():
    from mfvae_tpu_torch.bench.common import step_flops
    from mfvae_tpu_torch.config import load_config
    from mfvae_tpu_torch.envs.mpe import make
    from mfvae_tpu_torch.models.mavae import MAVAE
    from mfvae_tpu_torch.training.experiment import build_spec

    cfg = load_config(str(common.HERE / "configs" / "tag_unroll.json"))
    model = MAVAE.from_config(cfg.model, build_spec(make(cfg.env.name, device="cpu")), device="meta")
    conf = common.config_dict("tag_unroll")
    spec = common.ref_spec(conf)
    got = flops_unroll.unroll_step_flops(conf["model"], spec.obs_dims, spec.act_dims, 4096, 8)
    assert got == step_flops(model, 4096, 8) == 8 * 1068624248832


def test_k3w_bytes_at_the_cells_shapes():
    rows = 8 * 4096
    assert flops_unroll.k3w_bytes(rows, 5660) == 2 * rows * 5660 * 4 + 4 * rows + 4
    assert flops_unroll.k3w_bytes(rows, 5660) / 3.35e12 * 1e6 == pytest.approx(442.9, abs=0.1)


def _data(host=(), kernels=()):
    prof = common.Profiled(CPU)
    prof.host = sorted(host)
    prof.device_ops = sorted(kernels, key=lambda k: k[1])
    return {"prof": prof, "profiled": {"steps": 2, "wall_s": 1.0}, "plain": {"steps": 4, "wall_s": 2.0},
            "flops": {"train_step": 6.7e12}, "compute_dtype": "float32",
            "shapes": {"batch": 4, "window": 3, "agents": 2, "sum_obs": 10}}


READERS = ["k3w_roofline_pct.unroll", "unroll_step_host_ms.unroll"]
TRAIN_READERS = ["mfu_pct.train", "kernels_per_step.train", "idle_pct.train", "sample_ms.train"]


@pytest.mark.parametrize("metric", READERS)
def test_a_reader_reads_nothing_without_its_spans_or_kernels(metric):
    others = _data(host=[(0.0, 10.0, "mfvae.train.forward")])
    assert common.load_module("metrics", metric).read(others) is None


def test_the_readers_on_a_hand_made_trace():
    read = lambda m, d: common.load_module("metrics", m).read(d)  # noqa: E731
    steps = [(100.0 * i, 100.0 * i + 40.0, "mfvae.train.unroll.step") for i in range(6)]
    assert read("unroll_step_host_ms.unroll", _data(host=steps)) == pytest.approx(0.04)
    assert read("unroll_step_host_ms.unroll", _data(host=steps[:5])) is None  # a window step's span missing
    k3w = [("huber_rows_wsum_kernel<float, 4>", 10.0 * i, 10.0 * i + 2.0, True) for i in range(4)]
    least = 2 * (flops_unroll.k3w_bytes(12, 10) + flops_unroll.k3w_bytes(12, 2)) / 3.35e12
    assert read("k3w_roofline_pct.unroll", _data(kernels=k3w)) == pytest.approx(100.0 * least / 8e-6)
    assert read("k3w_roofline_pct.unroll", _data(kernels=k3w[:3])) is None  # not two a step
    k3 = [("huber_mean_kernel<float, 4>", 0.0, 1.0, True)] * 4
    assert read("k3w_roofline_pct.unroll", _data(kernels=k3)) is None  # K3 is not K3w
    assert read("kernels_per_step.train", _data(kernels=k3w)) == 2.0
    assert read("mfu_pct.train", _data()) == pytest.approx(100.0 * 6.7e12 * 4 / 2.0 / 67e12)


def test_a_traced_run_reads_the_host_side_metrics():
    """On the CPU the trace has no device operations, so the device readers
    read nothing; those of the host clock and of host spans read a value."""
    bench = common.load_json(common.ROOT / "BENCHMARK.json")
    listed = {m["name"] for m in bench["per_layer"] if CELL in m.get("workloads", [CELL])}
    assert listed == set(READERS) | set(TRAIN_READERS)
    out = small_run(trace=True)
    assert set(out["metrics"]) == {"mfu_pct.train", "sample_ms.train", "unroll_step_host_ms.unroll"}, out["metrics"]
    assert all(m["value"] > 0 for m in out["metrics"].values()), out["metrics"]
    assert out["correct"], out["checks"]
