"""Training the MAVAE on simple_spread, simple_adversary and simple_world_comm
in the port, against the JAX package.

- One train step on world_comm (three agent groups: the leader's
  Discrete(20) beside Discrete(5)) and on adversary, by both routes, from
  the JAX ``init`` bridged by ``params_from_jax``, on one batch and one
  eps: losses and every updated parameter within rtol 1e-4 / atol 1e-5,
  the tolerance of tests/test_torch_trainer.py.
- Tiny whole runs of the three scenarios by both routes with the group
  counts of tests/test_training.py (spread one group; adversary two, the
  good agents' obs 2 wider; world_comm three), and pursuit and episode_mix
  on simple_adversary over 2 envs in lockstep: finite losses.
- Two epochs, then a resume for two more, equal four epochs straight on
  world_comm, on adversary (batched pursuit) and on spread: the resume
  rebuilds each scenario's own obs and state types.
- The batched auto-reset picks every field of the state per env:
  adversary's ``goal`` and world_comm's ``leader_comm``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfvae_tpu.config import LossConfig as JLossConfig
from mfvae_tpu.config import ModelConfig as JModelConfig
from mfvae_tpu.config import TrainConfig as JTrainConfig
from mfvae_tpu.data.transitions import VaeBatch as JVaeBatch
from mfvae_tpu.envs.mpe import make as j_make
from mfvae_tpu.models.mavae import GroupedBatch as JBatch
from mfvae_tpu.models.mavae import MAVAE as JMAVAE
from mfvae_tpu.training.experiment import build_spec as j_build_spec
from mfvae_tpu.training.trainer import create_train_state as j_create_train_state
from mfvae_tpu.training.trainer import make_train_step as j_make_train_step
from mfvae_tpu_torch.config import LossConfig, ModelConfig, TrainConfig
from mfvae_tpu_torch.data.buffer import ItemBuffer
from mfvae_tpu_torch.data.transitions import VaeBatch
from mfvae_tpu_torch.envs.mpe import make
from mfvae_tpu_torch.models.convert import params_from_jax
from mfvae_tpu_torch.models.mavae import MAVAE, GroupedBatch
from mfvae_tpu_torch.rng import make_streams
from mfvae_tpu_torch.training.experiment import Experiment, build_spec
from mfvae_tpu_torch.training.trainer import EnvCarry, create_train_state, make_phase_fns, make_train_step
from tests.test_torch_batched import example_item, tiny_cfg
from tests.test_torch_experiment import _carry_tensors, one_torch_thread  # noqa: F401
from tests.test_torch_trainer import ATOL, RTOL, SMALL

B, F = 8, 8
POPS = {
    "MPE_simple_spread_v3": dict(num_good_agents=3),
    "MPE_simple_adversary_v3": dict(num_good_agents=2),
    "MPE_simple_world_comm_v3": dict(num_adversaries=4, num_good_agents=2, num_obs=1),
}


def _batch(spec, seed):
    rng = np.random.default_rng(seed)
    obs = [rng.normal(size=(B, len(i), od)).astype(np.float32) for (od, _), i in spec.groups]
    act = [rng.integers(0, ad, size=(B, len(i))).astype(np.int32) for (_, ad), i in spec.groups]
    nxt = rng.normal(size=(B, sum(spec.obs_dims))).astype(np.float32)
    rew = rng.normal(size=(B, spec.n_agents)).astype(np.float32)
    jb = JVaeBatch(JBatch(tuple(map(jnp.asarray, obs)), tuple(map(jnp.asarray, act))), jnp.asarray(nxt), jnp.asarray(rew))
    tb = VaeBatch(GroupedBatch(tuple(map(torch.from_numpy, obs)), tuple(map(torch.from_numpy, act))),
                  torch.from_numpy(nxt), torch.from_numpy(rew))
    return jb, tb


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", ["MPE_simple_adversary_v3", "MPE_simple_world_comm_v3"])
def test_one_step_matches_jax(name, use_pallas):
    jspec = j_build_spec(j_make(name, **POPS[name]))
    tspec = build_spec(make(name, device="cpu", **POPS[name]))
    assert (tspec.agents, tspec.obs_dims, tspec.act_dims) == (jspec.agents, jspec.obs_dims, jspec.act_dims)
    if name == "MPE_simple_world_comm_v3":
        assert [k for k, _ in tspec.groups] == [(34, 20), (34, 5), (28, 5)]
    jmodel = JMAVAE.from_config(JModelConfig(**SMALL), jspec)
    jb, tb = _batch(jspec, 0)
    variables = jmodel.init(jax.random.PRNGKey(0), jb.inputs, None, jax.random.PRNGKey(1))
    jstate = j_create_train_state(jmodel, variables, JTrainConfig())
    key = jax.random.PRNGKey(5)
    eps = np.array(jax.random.normal(key, (B, jspec.n_agents, F)))
    s1, o1 = jax.jit(j_make_train_step(JLossConfig(), use_pallas=use_pallas))(jstate, jb, key)

    tmodel = MAVAE.from_config(ModelConfig(**SMALL), tspec, device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.device_get(variables)))
    state = create_train_state(tmodel, TrainConfig())
    state, o2 = make_train_step(LossConfig(), use_pallas=use_pallas)(state, tb, eps=torch.from_numpy(eps))
    for field in ("loss", "s_loss", "r_loss", "kl_loss"):
        np.testing.assert_allclose(float(getattr(o2, field)), float(getattr(o1, field)), rtol=RTOL, atol=ATOL,
                                   err_msg=field)
    want = params_from_jax(jax.device_get(s1.params))
    got = state.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=RTOL, atol=ATOL, err_msg=k)


def scenario_cfg(tmp_path, name, **train_kw):
    cfg = tiny_cfg(tmp_path, **train_kw)
    cfg.env.name = name
    for k, v in POPS[name].items():
        setattr(cfg.env, k, v)
    return cfg


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name,groups", [
    ("MPE_simple_spread_v3", 1), ("MPE_simple_adversary_v3", 2), ("MPE_simple_world_comm_v3", 3),
])
def test_tiny_runs(tmp_path, name, groups, use_pallas):
    cfg = scenario_cfg(tmp_path, name, epoch_num=2)
    cfg.model.use_pallas = use_pallas
    exp = Experiment(cfg, device="cpu").setup()
    assert len(exp.spec.groups) == groups
    if name == "MPE_simple_adversary_v3":
        assert exp.spec.obs_dims[0] + 2 == exp.spec.obs_dims[1]
    result = exp.run()
    assert math.isfinite(result["loss_train"]) and math.isfinite(result["loss_test"]), result


@pytest.mark.parametrize("policy", ["pursuit", "episode_mix"])
def test_batched_collection_on_adversary(tmp_path, policy):
    cfg = scenario_cfg(tmp_path, "MPE_simple_adversary_v3", epoch_num=2, n_envs=2, collect_policy=policy)
    exp = Experiment(cfg, device="cpu").setup()
    result = exp.run()
    assert math.isfinite(result["loss_train"]) and math.isfinite(result["loss_test"]), result
    assert tuple(exp.carry.env.state.goal.shape) == (2,)


@pytest.mark.parametrize("name,train_kw", [
    ("MPE_simple_world_comm_v3", {}),
    ("MPE_simple_adversary_v3", dict(n_envs=2, collect_policy="pursuit")),
    ("MPE_simple_spread_v3", {}),
])
def test_resume_continues_exactly(tmp_path, name, train_kw):
    """Two epochs, then resume for two more == four epochs straight."""
    def cfg(path, epochs, resume=False):
        c = scenario_cfg(path, name, epoch_num=epochs, **train_kw)
        c.train.resume = resume
        return c

    full = Experiment(cfg(tmp_path / "a", 4), device="cpu").setup()
    want = full.run()
    Experiment(cfg(tmp_path / "b", 2), device="cpu").setup().run()
    resumed = Experiment(cfg(tmp_path / "b", 4, resume=True), device="cpu").setup()
    assert resumed.start_epoch == 2
    assert type(resumed.carry.env.state) is type(full.carry.env.state)
    assert type(resumed.carry.env.obs) is type(full.carry.env.obs)
    got = resumed.run()
    assert got["loss_train"] == want["loss_train"] and got["loss_test"] == want["loss_test"]
    a, b = _carry_tensors(full), _carry_tensors(resumed)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["MPE_simple_adversary_v3", "MPE_simple_world_comm_v3"])
def test_batched_auto_reset_picks_every_state_field_per_env(name):
    cfg = scenario_cfg(None, name, n_envs=2, sample_num=1)
    cfg.buffer.batch_size = 4
    env = make(name, device="cpu", max_steps=5, **POPS[name])
    spec = build_spec(env)
    buf = ItemBuffer(max_length=8, sample_batch_size=2, shards=2)
    streams = make_streams(0, device="cpu")
    collect, _, _ = make_phase_fns(env, spec, buf, buf, cfg, streams)
    obs, state = env.reset_stacked(torch.Generator().manual_seed(1), batch_shape=(2,))
    state = state._replace(step=torch.tensor([4, 0], dtype=torch.int32))  # env 0 ends on this step
    if name == "MPE_simple_world_comm_v3":
        state = state._replace(leader_comm=torch.eye(4)[[1, 2]])
    # the reset the collect draws, replayed from a copy of its generator
    replay = torch.Generator().manual_seed(0)
    replay.set_state(streams["reset"].get_state())
    act_replay = torch.Generator()
    act_replay.set_state(streams["act"].get_state())
    env_c, _ = collect(EnvCarry(obs, state), buf.init(example_item(env, spec, 2)), buf)
    _, reset = env.reset_stacked(replay, batch_shape=(2,))
    assert env_c.state.step.tolist() == [0, 1]
    torch.testing.assert_close(env_c.state.agent_pos[0], reset.agent_pos[0], rtol=0, atol=0)
    if name == "MPE_simple_adversary_v3":
        # env 0 takes the reset's goal, env 1 keeps its own
        assert env_c.state.goal.tolist() == [int(reset.goal[0]), int(state.goal[1])]
    else:
        act = torch.minimum((torch.rand(2, spec.n_agents, generator=act_replay) * torch.tensor(
            spec.act_dims, dtype=torch.float32)).to(torch.int32), torch.tensor(spec.act_dims) - 1)
        want = torch.stack([torch.zeros(4), torch.eye(4)[int(act[1, 0]) // 5]])
        torch.testing.assert_close(env_c.state.leader_comm, want, rtol=0, atol=0)
