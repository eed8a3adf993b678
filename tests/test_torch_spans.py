"""The port's spans and counters (``utils/profiling.py``) on the CPU: off
without a profiler, and, under ``torch.profiler``, one span a phase, a
train step's part or a rollout step where the program says so.  The
spans around K1-K3w's launches are in ``tests/test_torch_cuda.py``; here
the kernels' plain versions stand in for them, each under its span and
counter, to show what an unroll step on the kernel route launches: W
window steps, each with K1 and K2, and two K3w on the pooled terms."""

from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mfvae_tpu_torch.config import load_config
from mfvae_tpu_torch.inference import WorldModel
from mfvae_tpu_torch.models.mavae import GroupedBatch
from mfvae_tpu_torch.ops import fused_elbo as ops
from mfvae_tpu_torch.training.experiment import Experiment
from mfvae_tpu_torch.training.trainer import make_phase_fns
from mfvae_tpu_torch.utils import profiling

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
TRAIN_SPANS = ("train.sample", "train.eps", "train.forward", "train.loss", "train.backward", "train.update")


def _spans(prof, prefix="mfvae."):
    """(start µs, end µs, name) of the program's spans, by start."""
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events() if e.name.startswith(prefix))


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_without_a_profiler_a_span_records_nothing(monkeypatch):
    def refuse(*_):
        raise AssertionError("a span made a record with no profiler running")

    monkeypatch.setattr(profiling, "record_function", refuse)
    off = profiling.span("a")
    assert off is profiling.span("b")
    with off:
        with profiling.span("k3"):
            torch.ones(3).sum()


def test_under_a_profiler_spans_nest():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            for _ in range(5):
                with profiling.span("k3"):
                    torch.ones(3).sum()
    spans = _spans(prof)
    assert [s[2] for s in spans] == ["mfvae.outer"] + ["mfvae.k3"] * 5
    assert all(_inside(s, spans[0]) for s in spans[1:])
    assert all(a[1] <= b[0] for a, b in zip(spans[1:], spans[2:]))  # one after another
    assert profiling.span("after") is profiling._OFF


def test_counters_round_trip():
    profiling.reset_counters()
    profiling.count("k3.launches")
    profiling.count("k3.launches", 2)
    profiling.count("k1.launches")
    got = profiling.counters()
    assert got == {"k3.launches": 3, "k1.launches": 1}
    got["k3.launches"] = 0  # a copy
    assert profiling.counters()["k3.launches"] == 3
    profiling.reset_counters()
    assert profiling.counters() == {}


def _tag_wm_small(tmp_path, *overrides):
    """``examples/world_model.yaml`` with the kernel route, at a few agents
    and narrow layers."""
    return load_config(str(EXAMPLES / "world_model.yaml"), [
        "model.use_pallas=true", "model.compute_dtype=float32", "model.det_features=16",
        "model.idx_features=8", "model.obs_features=8", "model.action_features=8",
        "env.num_good_agents=1", "env.num_adversaries=2", "env.num_obs=1", "env.max_steps=16",
        "buffer.max_size=64", "buffer.min_size=8", "buffer.batch_size=8", "train.batch_size=8",
        "train.sample_num=16", "train.train_num=3", "train.test_num=2",
        f"train.log_dir={tmp_path}/results", f"train.checkpoint_dir={tmp_path}/ckpt", *overrides,
    ])


@pytest.mark.parametrize("overrides", [(), ("model.use_pallas=false", "train.unroll_steps=2")],
                         ids=["one_step_kernels", "unroll_w2"])
def test_train_phase_spans_each_step(tmp_path, overrides):
    cfg = _tag_wm_small(tmp_path, *overrides)
    exp = Experiment(cfg, device="cpu").build()
    collect, train_phase, test_phase = make_phase_fns(exp.env, exp.spec, exp.buffer, exp.test_buffer, cfg,
                                                      exp.streams)
    _, buf = collect(exp.carry.env, exp.carry.buffer_state, exp.buffer)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_phase(exp.carry.train_state, buf)
    spans = _spans(prof)
    phases = [s for s in spans if s[2] == "mfvae.train_phase"]
    assert len(phases) == 1
    steps = cfg.train.train_num
    for name in TRAIN_SPANS:
        mine = [s for s in spans if s[2] == f"mfvae.{name}"]
        assert len(mine) == steps, name
        assert all(_inside(s, phases[0]) for s in mine), name
    backward = [s for s in spans if s[2] == "mfvae.train.backward"]
    update = [s for s in spans if s[2] == "mfvae.train.update"]
    for b, u in zip(backward, update):
        assert b[1] <= u[0]  # the update starts after the backward ends
    order = [s[2][len("mfvae."):] for s in spans if s[2][len("mfvae."):] in TRAIN_SPANS]
    assert order == list(TRAIN_SPANS) * steps


def _plain_versions_as_launches(monkeypatch):
    """Each kernel's plain version under its span and launch counter, as
    its launch on the card is."""
    for name, key in (("_fwd_rows_plain", "k1"), ("_bwd_rows_plain", "k2"), ("_huber_mean_plain", "k3"),
                      ("_huber_rows_wsum_plain", "k3w")):
        def launch(*args, _real=getattr(ops, name), _key=key, **kwargs):
            with profiling.span(_key):
                profiling.count(f"{_key}.launches")
                return _real(*args, **kwargs)

        monkeypatch.setattr(ops, name, launch)


def test_an_unroll_step_on_the_kernel_route_spans_each_window_step(tmp_path, monkeypatch):
    w = 3
    cfg = _tag_wm_small(tmp_path, f"train.unroll_steps={w}", "train.train_num=1")
    exp = Experiment(cfg, device="cpu").build()
    collect, train_phase, _ = make_phase_fns(exp.env, exp.spec, exp.buffer, exp.test_buffer, cfg, exp.streams)
    _, buf = collect(exp.carry.env, exp.carry.buffer_state, exp.buffer)
    _plain_versions_as_launches(monkeypatch)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_phase(exp.carry.train_state, buf)
    assert profiling.counters() == {"k1.launches": w, "k2.launches": w, "k3w.launches": 2}
    spans = _spans(prof)
    named = lambda n: [s for s in spans if s[2] == f"mfvae.{n}"]  # noqa: E731
    (forward,), (loss,) = named("train.forward"), named("train.loss")
    steps = named("train.unroll.step")
    assert len(steps) == w and all(_inside(s, forward) for s in steps)
    assert all(a[1] <= b[0] for a, b in zip(steps, steps[1:]))  # one after another
    assert [sum(_inside(k, s) for k in named("k1")) for s in steps] == [1] * w  # K1 in each step's fused_call
    assert len(named("k2")) == w and not named("k3")
    k3w = named("k3w")
    assert len(k3w) == 2 and all(_inside(s, loss) for s in k3w)


def test_collect_and_test_phase_are_spans(tmp_path):
    cfg = _tag_wm_small(tmp_path)
    exp = Experiment(cfg, device="cpu").build()
    collect, _, test_phase = make_phase_fns(exp.env, exp.spec, exp.buffer, exp.test_buffer, cfg, exp.streams)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, buf = collect(exp.carry.env, exp.carry.test_buffer_state, exp.test_buffer)
        test_phase(exp.carry.train_state, buf)
    names = [s[2] for s in _spans(prof)]
    assert names == ["mfvae.collect", "mfvae.test_phase"]


def test_a_rollout_request_holds_its_steps(tmp_path):
    cfg = _tag_wm_small(tmp_path)
    exp = Experiment(cfg, device="cpu").build()
    wm = WorldModel(exp.carry.train_state.model)
    horizon, b = 4, 3
    g = torch.Generator().manual_seed(0)
    obs = tuple(torch.randn(b, len(idx), exp.spec.obs_dims[idx[0]], generator=g) for _, idx in exp.spec.groups)
    plan = tuple(torch.randint(0, 5, (horizon, b, len(idx)), generator=g) for _, idx in exp.spec.groups)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        states, _ = wm.rollout(GroupedBatch(obs=obs, actions=()), plan)
    assert states.shape[0] == horizon
    spans = _spans(prof)
    request = [s for s in spans if s[2] == "mfvae.rollout"]
    assert len(request) == 1
    for name in ("mfvae.rollout.step", "mfvae.rollout.refeed"):
        mine = [s for s in spans if s[2] == name]
        assert len(mine) == horizon and all(_inside(s, request[0]) for s in mine)
