"""The comparison that decides ``correct``, on the CPU at a size a test
run holds: each cell's run, the look for a card skipped, comes out correct
under the cell's own limits; with the timed path broken underneath it
comes out not correct, once for each fault the cell can have (a step that
returns its state unchanged; half of the batch left out, the mean taken
over the rest; an answer altered where it is produced; one card, so no
exchange between cards; on the kernel route, a loss reduction K3 whose
value leaves out half of the rows while its gradient stays whole); and
the control, the reference in fp8 put in the program's place, fails one
of the cell's numbers."""

import time

import pytest
import torch

from benchmark import common, harness
from benchmark.reference import model as M

# nine agents; the training cells also at narrow widths, the rollout cell
# at the model's own widths (at narrow widths fp8 moves a five-step
# rollout too little to tell it from bf16)
ENV = ["env.num_adversaries=6", "env.num_good_agents=3", "env.num_obs=3"]
NARROW = ["model.idx_features=16", "model.obs_features=16", "model.action_features=16",
          "model.encoder_hidden=[32,32]", "model.decoder_hidden=[64,32,64]",
          "buffer.max_size=256", "buffer.min_size=8", "train.sample_num=32", "train.train_num=4", "train.test_num=2",
          "train.batch_size=32", "buffer.batch_size=32"]
SIZES = {
    "tag_ref.epoch": ENV + NARROW,
    "tag_ref.train_b128": ENV + NARROW,
    "tag_wm.train_b4096": ENV + NARROW + ["model.det_features=16"],
    "tag_wm.rollout_b256": ENV,
}
ROLLOUT = {"batch": 8, "horizon": 25, "pool": 2, "min_requests": 4}
SEED = 3_000_000_019
CPU = torch.device("cpu")


def small_run(cell, monkeypatch):
    if cell == "tag_wm.rollout_b256":
        real = common.workload

        def workload(name):
            w = real(name)
            if name == cell:
                w["traffic"] = dict(w["traffic"], **ROLLOUT)
            return w

        monkeypatch.setattr(common, "workload", workload)
    return harness.run_cell(cell, SEED, 0.5, False, time.perf_counter(), dev=CPU, overrides=SIZES[cell])


@pytest.mark.parametrize("cell", list(SIZES))
def test_a_sound_run_is_correct(cell, monkeypatch):
    out = small_run(cell, monkeypatch)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


def _no_update(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from mfvae_tpu_torch.data.transitions import VaeBatch
    from mfvae_tpu_torch.models.mavae import GroupedBatch
    from mfvae_tpu_torch.training import trainer

    real = trainer.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def half(state, batch, generator=None, eps=None, eps_shared=None):
            h = batch.next_state.shape[0] // 2
            cut = VaeBatch(GroupedBatch(tuple(o[:h] for o in batch.inputs.obs), tuple(a[:h] for a in batch.inputs.actions)),
                           batch.next_state[:h], batch.rewards[:h])
            return step(state, cut, generator, None if eps is None else eps[:h], eps_shared)

        return half

    monkeypatch.setattr(trainer, "make_train_step", make)


def _reward_altered(monkeypatch):
    from mfvae_tpu_torch.envs.mpe import SimpleTagEnv

    real = SimpleTagEnv.step_stacked

    def step(self, state, actions):
        obs, new, rewards, done, info = real(self, state, actions)
        return obs, new, rewards + (torch.arange(rewards.shape[-1]) == 0).to(rewards.dtype), done, info

    monkeypatch.setattr(SimpleTagEnv, "step_stacked", step)


def _state_unchanged(monkeypatch):
    from mfvae_tpu_torch.models.mavae import MAVAE, agent_order_concat

    def mean_call(self, batch, agent_ids=None):
        s = agent_order_concat(self.spec, batch.obs).to(torch.float32)
        return s, torch.zeros(s.shape[0], self.spec.n_agents)

    monkeypatch.setattr(MAVAE, "mean_call", mean_call)


def _answer_altered(monkeypatch):
    from mfvae_tpu_torch.models.mavae import MAVAE

    real = MAVAE.mean_call

    def mean_call(self, batch, agent_ids=None):
        s, r = real(self, batch, agent_ids)
        return torch.cat([torch.zeros_like(s[:1]), s[1:]]), r

    monkeypatch.setattr(MAVAE, "mean_call", mean_call)


def _k3_half_rows(monkeypatch):
    from mfvae_tpu_torch.ops import fused_elbo

    real = fused_elbo._huber_mean_plain
    monkeypatch.setattr(fused_elbo, "_huber_mean_plain",
                        lambda x, y, delta=1.0: real(x[: x.shape[0] // 2], y[: y.shape[0] // 2], delta))


FAULTS = [
    ("tag_ref.epoch", _no_update), ("tag_ref.epoch", _half_batch), ("tag_ref.epoch", _reward_altered),
    ("tag_ref.train_b128", _no_update), ("tag_ref.train_b128", _half_batch),
    ("tag_wm.train_b4096", _no_update), ("tag_wm.train_b4096", _half_batch), ("tag_wm.train_b4096", _k3_half_rows),
    ("tag_wm.rollout_b256", _state_unchanged), ("tag_wm.rollout_b256", _answer_altered),
]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = small_run(cell, monkeypatch)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", list(SIZES))
def test_the_fp8_control_fails_a_number(cell, monkeypatch):
    run = harness.Run(cell, SEED, CPU, SIZES[cell])
    if "rollout" in cell:
        run.traffic = dict(run.traffic, **ROLLOUT)
    driver = common.load_module("drivers", run.work["driver"])
    readings = driver.stand_in(run, M.Precision(fp8=True))
    assert not harness.verdict(readings, run.work["limits"]), readings


def test_the_verdict_wants_every_number_finite_and_under_its_limit():
    limits = {"a": 1.0, "b": 2.0}
    assert harness.verdict({"a": 1.0, "b": 0.5}, limits)
    assert not harness.verdict({"a": 1.5, "b": 0.5}, limits)
    assert not harness.verdict({"a": float("nan"), "b": 0.5}, limits)
    assert not harness.verdict({"b": 0.5}, limits)
