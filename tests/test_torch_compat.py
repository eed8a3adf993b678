"""The reference-surface buffer and transition formats of the port
(``mfvae_tpu_torch/data/compat.py``, ``data/transitions.py``) against
``mfvae_tpu/data/compat.py`` and ``mfvae_tpu/data/transitions.py``.

One step of each package's simple_tag env from the same injected state
gives the per-agent dicts; the port's ``create_joint_transition``,
``group_env_step`` and ``create_dataset`` must give the JAX package's
arrays exactly, and ``TransitionBuffer`` keeps the reference's surface:
messages before ``init_buffer``, ``can_sample`` at ``min_length``, a
flashbax-like ``.experience`` that ``create_dataset`` reads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfvae_tpu.data import compat as jcompat
from mfvae_tpu.data import transitions as jtr
from mfvae_tpu.envs.mpe import MPEState
from mfvae_tpu.envs.mpe import SimpleTagEnv as JSimpleTagEnv
from mfvae_tpu.models.mavae import AgentSpec as JAgentSpec
from mfvae_tpu_torch.data import compat
from mfvae_tpu_torch.data import transitions as tr
from mfvae_tpu_torch.envs.mpe import SimpleTagEnv
from mfvae_tpu_torch.envs.mpe import MPEState as TMPEState
from mfvae_tpu_torch.models.mavae import AgentSpec
from tests.test_torch_experiment import one_torch_thread  # noqa: F401

POP = dict(num_good_agents=1, num_adversaries=2, num_obs=1, max_steps=50)


def rollout_bits():
    """One step of both envs from the same state and actions -> the JAX
    and the port's (obs, rew, actions, next_obs, done) dicts."""
    jenv, env = JSimpleTagEnv(**POP), SimpleTagEnv(device="cpu", **POP)
    rng = np.random.default_rng(0)
    pos = rng.uniform(-1, 1, (3, 2)).astype(np.float32)
    vel = rng.uniform(-0.5, 0.5, (3, 2)).astype(np.float32)
    lmk = rng.uniform(-0.9, 0.9, (1, 2)).astype(np.float32)
    jstate = MPEState(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(lmk), jnp.int32(0))
    tstate = TMPEState(torch.from_numpy(pos), torch.from_numpy(vel), torch.from_numpy(lmk),
                       torch.tensor(0, dtype=torch.int32))
    jobs = jenv._obs_dict(jenv._observe(jstate))
    acts = {a: int(i % 5) for i, a in enumerate(jenv.agents)}
    jnobs, _, jrew, jdone, _ = jenv.step(jax.random.PRNGKey(1), jstate, {a: jnp.int32(v) for a, v in acts.items()})
    tnobs, _, trew, tdone, _ = env.step(tstate, {a: torch.tensor(v, dtype=torch.int32) for a, v in acts.items()})
    tobs = {a: torch.from_numpy(np.array(v)) for a, v in jobs.items()}
    j = (jobs, jrew, {a: jnp.int32(v) for a, v in acts.items()}, jnobs, jdone)
    t = (tobs, trew, {a: torch.tensor(v, dtype=torch.int32) for a, v in acts.items()}, tnobs, tdone)
    return jenv, env, j, t


def test_joint_transition_matches_jax():
    _, _, j, t = rollout_bits()
    want = jtr.create_joint_transition(*j)
    got = tr.create_joint_transition(*t)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert tr.create_joint_transition(t[0], {}, t[2], t[3], t[4]) is None


def test_group_env_step_matches_jax():
    jenv, env, j, t = rollout_bits()
    dims = {a: env.obs_dim(a) for a in env.agents}
    acts = {a: 5 for a in env.agents}
    jspec, spec = JAgentSpec.from_dicts(jenv.agents, dims, acts), AgentSpec.from_dicts(env.agents, dims, acts)
    jobs, jrew, jact, jnobs, jdone = j
    obs, rew, act, nobs, done = t
    want = jtr.group_env_step(jspec, jobs, jact, jrew, jnobs, jdone)
    got = tr.group_env_step(spec, obs, act, rew, nobs, done)
    for name in ("obs", "actions", "next_obs"):
        for x, y in zip(getattr(got, name), getattr(want, name)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=name)
    np.testing.assert_array_equal(got.rewards.numpy(), np.asarray(want.rewards))
    assert float(got.done) == float(want.done)


def test_transition_buffer_surface_and_dataset(capsys):
    jenv, env, _, (obs, rew, act, nobs, done) = rollout_bits()
    buf = compat.TransitionBuffer(max_length=32, min_length=4, batch_size=8)
    assert buf.sample(torch.Generator().manual_seed(0)) is None
    assert buf.can_sample() is None
    buf.add_trans(obs, rew, act, nobs, done)
    assert "not init" in capsys.readouterr().out
    buf.init_buffer(obs, rew, act, nobs, done)
    assert buf.can_sample() is False
    assert buf.sample() is None and "can not sample now" in capsys.readouterr().out
    for _ in range(6):
        buf.add_trans(obs, rew, act, nobs, done)
    assert buf.can_sample() is True
    batch = buf.sample(torch.Generator().manual_seed(2))
    assert batch.experience["adversary_1_obs"].shape[0] == 8
    codebook = {a: i for i, a in enumerate(env.agents)}
    idx_state, acts, rewards, next_states = tr.create_dataset(batch.experience, codebook)
    assert rewards.shape == (8, 3) and next_states.shape == (8, sum(env.obs_dim(a) for a in env.agents))
    # the same rows through JAX's create_dataset give the same arrays
    rows = {k: jnp.asarray(v.numpy()) for k, v in batch.experience.items()}
    j_idx, j_acts, j_rew, j_next = jtr.create_dataset(rows, codebook)
    for a in env.agents:
        np.testing.assert_array_equal(idx_state[a].numpy(), np.asarray(j_idx[a]))
        np.testing.assert_array_equal(acts[a].numpy(), np.asarray(j_acts[a]))
    np.testing.assert_array_equal(rewards.numpy(), np.asarray(j_rew))
    np.testing.assert_array_equal(next_states.numpy(), np.asarray(j_next))


def test_buffer_rows_match_jax_buffer():
    """Both buffers hold the same rows after the same adds."""
    _, _, j, t = rollout_bits()
    jbuf = jcompat.TransitionBuffer(max_length=8, min_length=2, batch_size=4)
    buf = compat.TransitionBuffer(max_length=8, min_length=2, batch_size=4)
    jbuf.init_buffer(*j)
    buf.init_buffer(*t)
    for _ in range(10):  # past the capacity: the ring wraps
        jbuf.add_trans(*j)
        buf.add_trans(*t)
    want = jbuf.buffer_state.data
    for k, v in buf.buffer_state.data.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]), err_msg=k)
    assert (buf.buffer_state.cursor, buf.buffer_state.size) == (int(jbuf.buffer_state.cursor),
                                                                int(jbuf.buffer_state.size))


def test_dummy_and_print(capsys):
    _, _, _, t = rollout_bits()
    dummy = compat.generate_dummy_transition(tr.create_joint_transition(*t))
    assert all(float(v.abs().sum()) == 0.0 for v in dummy.values())
    compat.print_transition_shape(dummy)
    out = capsys.readouterr().out
    assert "adversary_0_obs" in out and "shape" in out


@pytest.mark.parametrize("add_batch", [False, True])
def test_add_batch_mode(add_batch):
    """``init_buffer`` lays out the JAX package's schema in both modes."""
    _, _, j, t = rollout_bits()
    jbuf = jcompat.TransitionBuffer(max_length=64, min_length=2, batch_size=4, add_batch=add_batch)
    buf = compat.TransitionBuffer(max_length=64, min_length=2, batch_size=4, add_batch=add_batch)
    jbuf.init_buffer(*j)
    buf.init_buffer(*t)
    assert {k: tuple(v.shape) for k, v in buf.buffer_state.data.items()} == {
        k: tuple(v.shape) for k, v in jbuf.buffer_state.data.items()}
