"""The batched epoch (``train.n_envs`` > 1) of the port, on the CPU.

- ``n_envs`` 2 and 4 at the JAX package's ``tiny_cfg``
  (tests/test_training.py) train to finite losses with buffer shards of
  [E, max(max_size // E, batch_size // E), ...], as the JAX package's
  own batched run does.
- Unroll on the batched path trains, and a per-shard capacity not
  divisible by ``sample_num`` is refused with "divisible", as
  tests/test_unroll.py asks of the JAX package.
- Under sticky collection with ``n_envs`` 2, two epochs and a resume for
  two more equal four epochs straight, the policy carry and the [E]
  buffer shards restored bit for bit.
- The batched collect reads nothing back from the device: every tensor's
  ``__bool__`` and ``item`` raise while it runs (the single-env collect
  reads the done flag once a step).
- The sharded buffer: shard-major global batches of batch_size / E items
  from every shard, and joined eval batches that are each stratified.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from mfvae_tpu_torch.config import ExperimentConfig
from mfvae_tpu_torch.data.buffer import ItemBuffer
from mfvae_tpu_torch.data.transitions import GroupedTransition
from mfvae_tpu_torch.models.mavae import zero_actions_grouped
from mfvae_tpu_torch.training.experiment import Experiment
from mfvae_tpu_torch.training.trainer import make_phase_fns
from tests.test_torch_experiment import _carry_tensors, one_torch_thread  # noqa: F401
from tests.test_training import tiny_cfg as j_tiny_cfg


def tiny_cfg(tmp_path, **train_kw) -> ExperimentConfig:
    """The JAX ``tiny_cfg`` as the port's config."""
    cfg = ExperimentConfig()
    for section, values in dataclasses.asdict(j_tiny_cfg(tmp_path, **train_kw)).items():
        for k, v in values.items():
            setattr(getattr(cfg, section), k, v)
    return cfg


def example_item(env, spec, n_envs):
    obs, state = env.reset_stacked(torch.Generator().manual_seed(0), batch_shape=(n_envs,))
    return GroupedTransition(
        obs=tuple(obs), actions=zero_actions_grouped(spec, n_envs), next_obs=tuple(obs),
        rewards=torch.zeros(n_envs, spec.n_agents), done=torch.zeros(n_envs),
    )


@pytest.mark.parametrize("policy", ["random", "pursuit", "episode_mix", "sticky"])
@pytest.mark.parametrize("n_envs", [2, 4])
def test_batched_runs(tmp_path, n_envs, policy):
    cfg = tiny_cfg(tmp_path, n_envs=n_envs, collect_policy=policy)
    exp = Experiment(cfg, device="cpu").setup()
    result = exp.run()
    assert math.isfinite(result["loss_train"]) and math.isfinite(result["loss_test"]), result
    cap = max(64 // n_envs, 8 // n_envs)
    st = exp.carry.buffer_state
    assert tuple(st.data.rewards.shape) == (n_envs, cap, 3)
    assert tuple(st.data.obs[0].shape) == (n_envs, cap, 2, exp.spec.obs_dims[0])
    assert st.size == min(3 * 8, cap)
    assert exp.carry.env.state.agent_pos.shape == (n_envs, 3, 2)
    want = {"random": [], "pursuit": [], "episode_mix": [(n_envs,), (n_envs,)],
            "sticky": [(n_envs, 3), (n_envs,)]}[policy]
    assert [tuple(x.shape) for x in exp.carry.env.policy] == want


def test_batched_unroll_trains(tmp_path):
    cfg = tiny_cfg(tmp_path, epoch_num=2, unroll_steps=4, n_envs=2)
    cfg.buffer.max_size = 64  # per-shard 32, divisible by sample_num 8
    result = Experiment(cfg, device="cpu").setup().run()
    assert math.isfinite(result["loss_train"]) and math.isfinite(result["loss_test"])


def test_batched_unroll_refuses_a_bad_shard_capacity(tmp_path):
    cfg = tiny_cfg(tmp_path, epoch_num=2, unroll_steps=4, n_envs=2, sample_num=12)
    cfg.buffer.max_size = 64  # per-shard 32, not divisible by 12
    with pytest.raises(ValueError, match="divisible"):
        Experiment(cfg, device="cpu").setup()


def test_batch_size_must_split_over_the_envs(tmp_path):
    cfg = tiny_cfg(tmp_path, n_envs=3)
    with pytest.raises(ValueError, match="divisible"):
        Experiment(cfg, device="cpu")


def test_sticky_batched_resume_continues_exactly(tmp_path):
    """Two epochs, then resume for two more == four epochs straight."""
    def cfg(path, epochs, resume=False):
        c = tiny_cfg(path, epoch_num=epochs, n_envs=2, collect_policy="sticky", collect_mix_frac=0.9)
        c.train.resume = resume
        return c

    full = Experiment(cfg(tmp_path / "a", 4), device="cpu").setup()
    want = full.run()
    Experiment(cfg(tmp_path / "b", 2), device="cpu").setup().run()
    resumed = Experiment(cfg(tmp_path / "b", 4, resume=True), device="cpu").setup()
    assert resumed.start_epoch == 2
    got = resumed.run()
    assert got["loss_train"] == want["loss_train"] and got["loss_test"] == want["loss_test"]
    a, b = _carry_tensors(full), _carry_tensors(resumed)
    a += list(full.carry.env.policy)
    b += list(resumed.carry.env.policy)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _collect_without_reads(cfg, monkeypatch):
    exp = Experiment(cfg, device="cpu").setup()
    collect, _, _ = make_phase_fns(exp.env, exp.spec, exp.buffer, exp.test_buffer, cfg, exp.streams)

    def refuse(*_):
        raise RuntimeError("a host read of a tensor")

    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "__bool__", refuse)
        m.setattr(torch.Tensor, "item", refuse)
        collect(exp.carry.env, exp.carry.buffer_state, exp.buffer)


@pytest.mark.parametrize("policy", ["random", "pursuit", "episode_mix", "sticky"])
def test_batched_collect_reads_nothing_back(tmp_path, monkeypatch, policy):
    cfg = tiny_cfg(tmp_path, n_envs=2, collect_policy=policy, sample_num=20)  # max_steps 16: resets inside
    _collect_without_reads(cfg, monkeypatch)
    with pytest.raises(RuntimeError, match="host read"):
        _collect_without_reads(tiny_cfg(tmp_path, collect_policy=policy), monkeypatch)


def test_sharded_sample_is_stratified_and_shard_major():
    buf = ItemBuffer(max_length=4, sample_batch_size=3, shards=2)
    item = (torch.zeros(2),)
    st = buf.init(item)
    for i in range(4):
        st = buf.add(st, (torch.tensor([i, 10 + i], dtype=torch.float32),))
    g = torch.Generator().manual_seed(0)
    x = buf.sample(st, g).experience[0]
    assert x.shape == (6,)
    assert bool((x[:3] < 10).all()) and bool((x[3:] >= 10).all())
    x = buf.sample(st, g, batch_size=12).experience[0].reshape(4, 2, 3)  # 4 joined batches
    assert bool((x[:, 0] < 10).all()) and bool((x[:, 1] >= 10).all())
    assert set(np.unique(x.numpy())) <= {0, 1, 2, 3, 10, 11, 12, 13}


def test_batched_experiment_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Experiment(tiny_cfg(tmp_path, n_envs=2))
