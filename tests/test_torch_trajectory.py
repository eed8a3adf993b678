"""The port's env wrappers (``mfvae_tpu_torch/envs/wrappers.py``) and
``TrajectoryBuffer`` (``mfvae_tpu_torch/data/buffer.py``) against the JAX
package's.

- ``LogWrapper`` under ``BatchedEnv`` over B = 3 simple_tag worlds with
  ``max_steps`` 4, 7 steps, so every world ends an episode and auto-resets:
  the same start states and numpy actions go into both packages, and the
  port takes JAX's own reset states (``reset=``; the port cannot replay
  threefry).  Obs, rewards, dones, the states and every ``returned_*``
  field must be exactly equal.
- ``TrajectoryBuffer``: ``add``, ``can_sample``, cursor and size equal
  through a wrap of the ring; windows at JAX's own (rows, starts),
  replayed from its key, exactly equal; and no window crosses the write
  seam once the ring is full.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mfvae_tpu.data.buffer import TrajectoryBuffer as JTrajectoryBuffer
from mfvae_tpu.envs.mpe import make as j_make
from mfvae_tpu.envs.wrappers import BatchedEnv as JBatchedEnv
from mfvae_tpu.envs.wrappers import LogWrapper as JLogWrapper
from mfvae_tpu_torch.data.buffer import TrajectoryBuffer
from mfvae_tpu_torch.envs.mpe import MPEState, make
from mfvae_tpu_torch.envs.wrappers import BatchedEnv, LogState, LogWrapper
from tests.test_torch_experiment import one_torch_thread  # noqa: F401

POP = dict(num_good_agents=1, num_adversaries=2, num_obs=1, max_steps=4)
ATOL = 0.0  # exact: at this size both packages compute the same bits


def t(x):
    return torch.from_numpy(np.array(x))


def port_log_state(js) -> LogState:
    """A JAX LogState (batched) as the port's."""
    return LogState(MPEState(*(t(x) for x in js.env_state)), *(t(x) for x in js[1:]))


def assert_states_close(got: LogState, want):
    for g, w in zip(got.env_state, want.env_state):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.episode_return.numpy(), np.asarray(want.episode_return), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.returned_return.numpy(), np.asarray(want.returned_return), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got.episode_length.numpy(), np.asarray(want.episode_length))
    np.testing.assert_array_equal(got.returned_length.numpy(), np.asarray(want.returned_length))


def test_batched_log_wrapper_matches_jax_over_an_ending_episode():
    b = 3
    jenv, tenv = j_make("MPE_simple_tag_v3", **POP), make("MPE_simple_tag_v3", device="cpu", **POP)
    jwrap, twrap = JLogWrapper(jenv), LogWrapper(tenv)
    jbatch, tbatch = JBatchedEnv(jwrap, b), BatchedEnv(twrap, b)
    jobs, jstates = jbatch.reset(jax.random.PRNGKey(0))
    tstates = port_log_state(jstates)
    tobs = tenv._obs_dict(tenv._observe(tstates.env_state))
    for a in tenv.agents:
        np.testing.assert_array_equal(tobs[a].numpy(), np.asarray(jobs[a]))
    rng = np.random.default_rng(0)
    ended = 0
    for step in range(7):
        acts = rng.integers(0, 5, size=(b, tenv.num_agents)).astype(np.int32)
        key = jax.random.PRNGKey(100 + step)
        jobs, jstates_new, jrew, jdone, jinfo = jbatch.step(key, jstates, {a: jnp.asarray(acts[:, i])
                                                                           for i, a in enumerate(jenv.agents)})
        # the reset states JAX drew inside its step, for the done worlds
        obs_r, st_r = jax.vmap(jwrap.reset)(jax.random.split(jax.random.fold_in(key, 1), b))
        st_r = port_log_state(st_r)
        reset = (tenv._observe(st_r.env_state), st_r)
        tobs, tstates, trew, tdone, tinfo = tbatch.step(None, tstates, {a: t(acts[:, i])
                                                                         for i, a in enumerate(tenv.agents)}, reset)
        for a in tenv.agents:
            np.testing.assert_allclose(tobs[a].numpy(), np.asarray(jobs[a]), atol=ATOL, rtol=0, err_msg=a)
            np.testing.assert_allclose(trew[a].numpy(), np.asarray(jrew[a]), atol=ATOL, rtol=0, err_msg=a)
        for a in (*tenv.agents, "__all__"):
            np.testing.assert_array_equal(tdone[a].numpy(), np.asarray(jdone[a]), err_msg=a)
        np.testing.assert_allclose(tinfo["returned_episode_returns"].numpy(),
                                   np.asarray(jinfo["returned_episode_returns"]), atol=ATOL, rtol=0)
        for k in ("returned_episode_lengths", "returned_episode"):
            np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(jinfo[k]), err_msg=k)
        assert_states_close(tstates, jstates_new)
        jstates = jstates_new
        ended += int(np.asarray(jdone["__all__"]).sum())
    assert ended == 3  # every world's first episode ended at step 4 and reset


def test_batched_env_draws_its_resets_and_keeps_the_live_worlds():
    env = LogWrapper(make("MPE_simple_tag_v3", device="cpu", **POP))
    batch = BatchedEnv(env, 2)
    obs, st = batch.reset_stacked(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    acts = torch.zeros((2, env.num_agents), dtype=torch.int32)
    for _ in range(3):
        obs, st, _, done, info = batch.step_stacked(g, st, acts)
        assert not bool(done.any())
    live = st
    obs, st, _, done, info = batch.step_stacked(g, st, acts)  # step 4 ends both episodes
    assert bool(done.all()) and torch.equal(info["returned_episode_lengths"], torch.tensor([4, 4], dtype=torch.int32))
    assert torch.equal(st.env_state.step, torch.zeros(2, dtype=torch.int32))
    assert not torch.equal(st.env_state.agent_pos, live.env_state.agent_pos)
    assert torch.equal(st.episode_return, torch.zeros_like(st.episode_return))


# ------------------------------------------------------------------- buffer
def example_step(n=3, d=4):
    return dict(obs=np.zeros((n, d), np.float32), actions=np.zeros((n,), np.int32), rewards=np.float32(0.0),
                done=np.bool_(False))


def as_port(tree):
    from mfvae_tpu_torch.baselines.vdn import Timestep

    return Timestep(*(t(tree[k]) for k in ("obs", "actions", "rewards", "done")))


def chunk(rng, rows, steps, n=3, d=4):
    return dict(obs=rng.normal(size=(rows, steps, n, d)).astype(np.float32),
                actions=rng.integers(0, 5, size=(rows, steps, n)).astype(np.int64),  # cast to int32 on add
                rewards=rng.normal(size=(rows, steps)).astype(np.float32),
                done=rng.random(size=(rows, steps)) < 0.2)


def test_trajectory_buffer_matches_jax_through_a_wrap():
    kw = dict(add_batch_size=2, time_capacity=20, min_length_time=8, sample_batch_size=5, sample_sequence_length=4)
    jbuf, tbuf = JTrajectoryBuffer(**kw), TrajectoryBuffer(**kw)
    jst = jbuf.init({k: jnp.asarray(v) for k, v in example_step().items()})
    tst = tbuf.init(as_port(example_step()))
    rng = np.random.default_rng(0)
    for i in range(6):  # 6 x 7 steps: the ring of 20 wraps twice
        c = chunk(rng, 2, 7)
        jst = jbuf.add(jst, {k: jnp.asarray(v) for k, v in c.items()})
        tst = tbuf.add(tst, as_port(c))
        assert (tst.cursor, tst.size) == (int(jst.cursor), int(jst.size))
        assert tbuf.can_sample(tst) == bool(jbuf.can_sample(jst))
        for k, leaf in zip(("obs", "actions", "rewards", "done"), tst.data):
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(jst.data[k]), err_msg=k)
        assert tst.data.actions.dtype == torch.int32
        if not tbuf.can_sample(tst):
            continue
        key = jax.random.PRNGKey(i)
        want = jbuf.sample(jst, key).experience
        k_row, k_start = jax.random.split(key)
        L, cap = kw["sample_sequence_length"], kw["time_capacity"]
        full = tst.size >= cap
        n_starts = cap - L + 1 if full else max(tst.size - L + 1, 1)
        rows = jax.random.randint(k_row, (5,), 0, 2)
        starts = ((tst.cursor if full else 0) + jax.random.randint(k_start, (5,), 0, n_starts)) % cap
        got = tbuf.sample(tst, indices=(t(rows).long(), t(starts).long())).experience
        for k, leaf in zip(("obs", "actions", "rewards", "done"), got):
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(want[k]), err_msg=k)
            assert leaf.shape[:2] == (5, L)


def test_no_window_crosses_the_seam_once_full():
    buf = TrajectoryBuffer(add_batch_size=2, time_capacity=12, min_length_time=4, sample_batch_size=64,
                           sample_sequence_length=5)
    st = buf.init((torch.zeros(()),))
    written = 0
    g = torch.Generator().manual_seed(0)
    for steps in (7, 7, 5, 9):  # every cell holds the global time it was written at
        times = torch.arange(written, written + steps, dtype=torch.float32)
        st = buf.add(st, (times.expand(2, steps),))
        written += steps
        assert st.size == min(written, 12)
        for _ in range(5):
            (w,) = buf.sample(st, g).experience
            assert torch.all(w[:, 1:] - w[:, :-1] == 1), (written, w)
            assert torch.all(w >= written - st.size)
