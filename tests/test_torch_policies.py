"""The collection policies of the port against ``mfvae_tpu/envs/policies.py``.

- ``_toward_discrete`` exact, ties |dx| = |dy| and on-target deltas
  included (``jnp.argmax`` takes the first maximum, so x wins a tie);
  ``_toward_continuous`` within atol 1e-6.
- ``_tag_deltas`` on injected ``MPEState``s within atol 1e-6 (both
  packages round the norms in their own order).
- Pursuit at ``collect_epsilon`` 0 exact against JAX, discrete and
  continuous, with and without a leading [E] axis.
- The draws: each policy takes the sampler's draw first, so pursuit at
  epsilon 1, sticky at hold 0 and episode_mix at mix_frac 0 give the
  sampler's draw from the same generator state; sticky at hold 1 repeats
  the previous action after the fresh step; episode_mix at mix_frac 1 is
  pursuit exactly.
- The policy carry is reset per env where its episode ends, by
  ``reset_carry`` and inside the batched collect.
- The contact share (max reward > 0.5; 32 envs of 6 adversaries and 2
  prey, 100 steps) under pursuit is over twice random's in both packages
  (about 2.5-3x in JAX over seeds), and the port's pursuit share lies
  inside the JAX package's band over 8 seeds, widened by half its width.

States and deltas come from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfvae_tpu.envs import policies as jpol
from mfvae_tpu.envs.mpe import MPEState as JState
from mfvae_tpu.envs.mpe import SimpleTagEnv as JEnv
from mfvae_tpu.training.experiment import build_spec as j_build_spec
from mfvae_tpu.training.trainer import make_action_sampler as j_make_action_sampler
from mfvae_tpu_torch.config import ExperimentConfig
from mfvae_tpu_torch.data.buffer import ItemBuffer
from mfvae_tpu_torch.envs import policies as tpol
from mfvae_tpu_torch.envs.mpe import MPEState as TState
from mfvae_tpu_torch.envs.mpe import SimpleTagEnv as TEnv
from mfvae_tpu_torch.rng import make_streams
from mfvae_tpu_torch.training.experiment import build_spec
from mfvae_tpu_torch.training.trainer import EnvCarry, make_action_sampler, make_phase_fns
from tests.test_torch_experiment import one_torch_thread  # noqa: F401

POP = dict(num_good_agents=2, num_adversaries=3, num_obs=2)


def _deltas():
    rng = np.random.default_rng(0)
    ties = [[1, 1], [-1, 1], [1, -1], [-1, -1], [0.5, -0.5], [0, 0], [1e-8, 0], [0, 1e-7],
            [0, 2], [0, -2], [3, 0], [-3, 0], [2e-6, -2e-6]]
    return np.concatenate([np.asarray(ties, np.float32), rng.normal(size=(40, 2)).astype(np.float32)])


def test_toward_discrete_and_continuous_match_jax():
    d = _deltas()
    want = np.asarray(jpol._toward_discrete(jnp.asarray(d)))
    got = tpol._toward_discrete(torch.from_numpy(d))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert list(got[:5].numpy()) == [2, 1, 2, 1, 2]  # ties go to x
    # a leading axis changes nothing
    np.testing.assert_array_equal(tpol._toward_discrete(torch.from_numpy(d.reshape(53, 1, 2))).numpy()[:, 0], want)
    np.testing.assert_allclose(tpol._toward_continuous(torch.from_numpy(d)).numpy(),
                               np.asarray(jpol._toward_continuous(jnp.asarray(d))), atol=1e-6, rtol=0)


def _states(n_env, seed, pop=POP, span=1.2):
    rng = np.random.default_rng(seed)
    a, l = pop["num_good_agents"] + pop["num_adversaries"], pop["num_obs"]
    pos = rng.uniform(-span, span, (n_env, a, 2)).astype(np.float32)
    vel = rng.uniform(-0.5, 0.5, (n_env, a, 2)).astype(np.float32)
    lm = rng.uniform(-0.9, 0.9, (n_env, l, 2)).astype(np.float32)
    jstates = [JState(jnp.asarray(pos[e]), jnp.asarray(vel[e]), jnp.asarray(lm[e]), jnp.int32(0)) for e in range(n_env)]
    tstate = TState(torch.from_numpy(pos), torch.from_numpy(vel), torch.from_numpy(lm), torch.zeros(n_env, dtype=torch.int32))
    return jstates, tstate


def _one(tstate, e):
    return type(tstate)(*(x[e] for x in tstate))


def test_tag_deltas_match_jax():
    jenv, tenv = JEnv(**POP), TEnv(device="cpu", **POP)
    jstates, tstate = _states(6, 1)
    got = tpol._tag_deltas(tenv, tstate)
    for e, js in enumerate(jstates):
        want = np.asarray(jpol._tag_deltas(jenv, js))
        np.testing.assert_allclose(got[e].numpy(), want, atol=1e-6, rtol=0)
        np.testing.assert_allclose(tpol._tag_deltas(tenv, _one(tstate, e)).numpy(), want, atol=1e-6, rtol=0)


def _pair(discrete, epsilon, name="pursuit", mix_frac=0.5, pop=POP):
    jenv = JEnv(discrete_actions=discrete, **pop)
    tenv = TEnv(discrete_actions=discrete, device="cpu", **pop)
    jspec, tspec = j_build_spec(jenv), build_spec(tenv)
    jsample, _ = j_make_action_sampler(jenv, jspec)
    tsample, _ = make_action_sampler(tenv, tspec)
    jp = jpol.make_collect_policy(jenv, jspec, name, epsilon, jsample, mix_frac=mix_frac)
    tp = tpol.make_collect_policy(tenv, tspec, name, epsilon, tsample, mix_frac=mix_frac)
    return jenv, tenv, jp, tp, tsample


@pytest.mark.parametrize("discrete", [True, False])
def test_pursuit_at_epsilon_0_matches_jax(discrete):
    _, _, jp, tp, _ = _pair(discrete, 0.0)
    jstates, tstate = _states(5, 2)
    batched = tp(tstate, torch.Generator().manual_seed(0))
    for e, js in enumerate(jstates):
        want = np.asarray(jp(js, jax.random.PRNGKey(e)))
        single = tp(_one(tstate, e), torch.Generator().manual_seed(e))
        if discrete:
            np.testing.assert_array_equal(single.numpy(), want)
            np.testing.assert_array_equal(batched[e].numpy(), want)
        else:
            np.testing.assert_allclose(single.numpy(), want, atol=1e-6, rtol=0)
            np.testing.assert_allclose(batched[e].numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("discrete", [True, False])
def test_pursuit_at_epsilon_1_is_the_samplers_draw(discrete):
    _, _, _, tp, tsample = _pair(discrete, 1.0)
    _, tstate = _states(4, 3)
    got = tp(tstate, torch.Generator().manual_seed(7))
    torch.testing.assert_close(got, tsample(torch.Generator().manual_seed(7), (4,)), rtol=0, atol=0)


def test_sticky_hold_and_fresh():
    _, tenv, _, hold, tsample = _pair(True, 0.1, "sticky", mix_frac=1.0)
    _, _, _, never, _ = _pair(True, 0.1, "sticky", mix_frac=0.0)
    _, tstate = _states(3, 4)
    obs = tenv._observe(tstate)
    carry = hold.init_carry((3,))
    assert carry[0].shape == (3, 5) and bool(carry[1].all())
    # fresh: a full resample, the sampler's draw
    carry, a0 = hold.step(carry, obs, tstate, torch.Generator().manual_seed(0))
    torch.testing.assert_close(a0, tsample(torch.Generator().manual_seed(0), (3,)), rtol=0, atol=0)
    assert not bool(carry[1].any())
    # hold 1 after the fresh step: the previous action, every step
    for seed in (1, 2):
        carry, a = hold.step(carry, obs, tstate, torch.Generator().manual_seed(seed))
        torch.testing.assert_close(a, a0, rtol=0, atol=0)
    # hold 0: the sampler's draw, fresh or not
    c = (a0, torch.zeros(3, dtype=torch.bool))
    _, a = never.step(c, obs, tstate, torch.Generator().manual_seed(5))
    torch.testing.assert_close(a, tsample(torch.Generator().manual_seed(5), (3,)), rtol=0, atol=0)


def test_sticky_continuous_keeps_whole_actions():
    _, tenv, _, hold, _ = _pair(False, 0.1, "sticky", mix_frac=1.0)
    _, tstate = _states(2, 5)
    carry = hold.init_carry((2,))
    assert carry[0].shape == (2, 5, 2) and carry[0].dtype == torch.float32
    carry, a0 = hold.step(carry, None, tstate, torch.Generator().manual_seed(0))
    _, a1 = hold.step(carry, None, tstate, torch.Generator().manual_seed(1))
    torch.testing.assert_close(a1, a0, rtol=0, atol=0)


def test_episode_mix_extremes():
    _, _, _, pursuit, tsample = _pair(True, 0.0)
    _, tenv, _, always, _ = _pair(True, 0.0, "episode_mix", mix_frac=1.0)
    _, _, _, never, _ = _pair(True, 0.0, "episode_mix", mix_frac=0.0)
    _, tstate = _states(4, 6)
    obs = tenv._observe(tstate)
    carry, a = always.step(always.init_carry((4,)), obs, tstate, torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, pursuit(tstate, torch.Generator().manual_seed(9)), rtol=0, atol=0)
    assert bool(carry[1].all()) and not bool(carry[0].any())
    # the episode's draw holds until the carry is reset
    _, a = always.step((carry[0], carry[1]), obs, tstate, torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, pursuit(tstate, None), rtol=0, atol=0)
    _, a = never.step(never.init_carry((4,)), obs, tstate, torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, tsample(torch.Generator().manual_seed(2), (4,)), rtol=0, atol=0)


def test_reset_carry_per_env():
    _, _, _, sticky, _ = _pair(True, 0.1, "sticky", mix_frac=0.9)
    carry = (torch.full((3, 5), 4, dtype=torch.int32), torch.zeros(3, dtype=torch.bool))
    prev, fresh = tpol.reset_carry(sticky, carry, torch.tensor([True, False, True]))
    assert fresh.tolist() == [True, False, True]
    assert prev.tolist() == [[0] * 5, [4] * 5, [0] * 5]


def test_batched_collect_resets_the_carry_of_the_env_that_ended():
    cfg = ExperimentConfig()
    cfg.env.num_good_agents, cfg.env.num_adversaries, cfg.env.num_obs = 2, 3, 2
    cfg.env.max_steps = 5
    cfg.train.n_envs, cfg.train.sample_num = 2, 1
    cfg.train.collect_policy, cfg.train.collect_mix_frac = "sticky", 0.9
    cfg.buffer.batch_size = 4
    env = TEnv(max_steps=5, device="cpu", **POP)
    spec = build_spec(env)
    buf = ItemBuffer(max_length=8, sample_batch_size=2, shards=2)
    collect, _, _ = make_phase_fns(env, spec, buf, buf, cfg, make_streams(0, device="cpu"))
    obs, state = env.reset_stacked(torch.Generator().manual_seed(0), batch_shape=(2,))
    state = state._replace(step=torch.tensor([4, 0], dtype=torch.int32))  # env 0 ends on this step
    held = (torch.full((2, 5), 3, dtype=torch.int32), torch.zeros(2, dtype=torch.bool))
    from tests.test_torch_batched import example_item

    env_c, st = collect(EnvCarry(obs, state, held), buf.init(example_item(env, spec, 2)), buf)
    assert env_c.policy[1].tolist() == [True, False]
    assert env_c.policy[0][0].tolist() == [0] * 5
    assert env_c.state.step.tolist() == [0, 1]
    assert st.data.done[:, 0].tolist() == [1.0, 0.0]


# ------------------------------------------------------------ contact share
E, STEPS, SEEDS = 32, 100, 8
CONTACT_POP = dict(num_good_agents=2, num_adversaries=6, num_obs=2)


def _jax_share(policy_name, seed):
    jenv, _, jp, _, _ = _pair(True, 0.1, policy_name, pop=CONTACT_POP)
    jspec = j_build_spec(jenv)
    jsample, _ = j_make_action_sampler(jenv, jspec)

    @jax.jit
    def run(key):
        k_reset, k_run = jax.random.split(key)
        _, state = jax.vmap(jenv.reset_stacked)(jax.random.split(k_reset, E))

        def body(st, k):
            keys = jax.random.split(k, E)
            act = jax.vmap(jp)(st, keys) if jp is not None else jax.vmap(jsample)(keys)
            _, st, rew, _, _ = jax.vmap(lambda s, a: jenv.step_stacked(None, s, a))(st, act)
            return st, jnp.max(rew, axis=-1) > 0.5

        _, contact = jax.lax.scan(body, state, jax.random.split(k_run, STEPS))
        return jnp.mean(contact.astype(jnp.float32))

    return float(run(jax.random.PRNGKey(seed)))


def _port_share(policy_name, seed):
    _, tenv, _, tp, tsample = _pair(True, 0.1, policy_name, pop=CONTACT_POP)
    g = torch.Generator().manual_seed(seed)
    _, state = tenv.reset_stacked(g, batch_shape=(E,))
    hits = []
    for _ in range(STEPS):
        act = tp(state, g) if tp is not None else tsample(g, (E,))
        _, state, rew, _, _ = tenv.step_stacked(state, act)
        hits.append(rew.amax(-1) > 0.5)
    return float(torch.stack(hits).float().mean())


def test_pursuit_contact_share_in_the_jax_band():
    jax_pursuit = [_jax_share("pursuit", s) for s in range(SEEDS)]
    jax_random = _jax_share("random", 0)
    port_pursuit, port_random = _port_share("pursuit", 0), _port_share("random", 0)
    assert min(jax_pursuit) > 2 * jax_random, (jax_pursuit, jax_random)
    assert port_pursuit > 2 * port_random, (port_pursuit, port_random)
    lo, hi = min(jax_pursuit), max(jax_pursuit)
    w = 0.5 * (hi - lo)
    assert lo - w <= port_pursuit <= hi + w, (port_pursuit, jax_pursuit)


# ------------------------------------------------------- simple_adversary
ADV_POP = dict(num_good_agents=3)


def _adversary_states(seed):
    """[6] injected simple_adversary states: random ones, then exact ties:
    two good agents equidistant from the adversary, |dx| = |dy| in the
    chase and in the goal-seek, and a good agent on the goal."""
    from mfvae_tpu.envs.mpe import AdversaryState as JAdvState
    from mfvae_tpu_torch.envs.mpe import AdversaryState as TAdvState

    rng = np.random.default_rng(seed)
    n = 6
    pos = rng.uniform(-1, 1, (n, 4, 2)).astype(np.float32)
    lm = rng.uniform(-0.9, 0.9, (n, 3, 2)).astype(np.float32)
    goal = (np.arange(n) % 3).astype(np.int32)
    pos[3] = [[0, 0], [0.3, 0.4], [0.4, -0.3], [0.9, 0.9]]  # goods 0 and 1 at distance 0.5
    pos[4] = [[0.125, 0.125], [0.625, 0.625], [-0.75, 0.75], [0.875, -0.875]]  # chase along the diagonal
    lm[4, goal[4]] = pos[4, 2] + [0.25, -0.25]  # seek along the other
    pos[5, 3] = lm[5, goal[5]]  # on the goal: the no-op
    vel = np.zeros_like(pos)
    jstates = [JAdvState(jnp.asarray(pos[e]), jnp.asarray(vel[e]), jnp.asarray(lm[e]), jnp.int32(goal[e]), jnp.int32(0))
               for e in range(n)]
    tstate = TAdvState(torch.from_numpy(pos), torch.from_numpy(vel), torch.from_numpy(lm), torch.from_numpy(goal),
                       torch.zeros(n, dtype=torch.int32))
    return jstates, tstate


def _adversary_pair(epsilon, name="pursuit", mix_frac=0.5):
    from mfvae_tpu.envs.mpe import SimpleAdversaryEnv as JAdvEnv
    from mfvae_tpu_torch.envs.mpe import SimpleAdversaryEnv as TAdvEnv

    jenv, tenv = JAdvEnv(**ADV_POP), TAdvEnv(device="cpu", **ADV_POP)
    jspec, tspec = j_build_spec(jenv), build_spec(tenv)
    jsample, _ = j_make_action_sampler(jenv, jspec)
    tsample, _ = make_action_sampler(tenv, tspec)
    jp = jpol.make_collect_policy(jenv, jspec, name, epsilon, jsample, mix_frac=mix_frac)
    tp = tpol.make_collect_policy(tenv, tspec, name, epsilon, tsample, mix_frac=mix_frac)
    return jenv, tenv, jp, tp


def test_adversary_deltas_and_pursuit_match_jax_exactly():
    jenv, tenv, jp, tp = _adversary_pair(0.0)
    jstates, tstate = _adversary_states(20)
    deltas = tpol._adversary_deltas(tenv, tstate)
    acts = tp(tstate, torch.Generator().manual_seed(0))
    for e, js in enumerate(jstates):
        np.testing.assert_array_equal(deltas[e].numpy(), np.asarray(jpol._adversary_deltas(jenv, js)))
        want = np.asarray(jp(js, jax.random.PRNGKey(e)))
        np.testing.assert_array_equal(acts[e].numpy(), want)
        np.testing.assert_array_equal(tp(_one(tstate, e), torch.Generator().manual_seed(e)).numpy(), want)
    # the ties: the first of two nearest prey; x wins |dx| = |dy|; on the goal, the no-op
    assert deltas[3, 0].tolist() == pytest.approx([0.3, 0.4])
    assert deltas[4, 0].tolist() == [0.5, 0.5] and deltas[4, 2].tolist() == [0.25, -0.25]
    assert acts[4, 0] == 2 and acts[4, 2] == 2 and acts[5, 3] == 0


def test_episode_mix_on_adversary_batched():
    _, tenv, _, pursuit = _adversary_pair(0.0)
    _, _, _, always = _adversary_pair(0.0, "episode_mix", mix_frac=1.0)
    _, tstate = _adversary_states(21)
    obs = tenv._observe(tstate)
    carry, a = always.step(always.init_carry((6,)), obs, tstate, torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, pursuit(tstate, None), rtol=0, atol=0)
    assert [tuple(x.shape) for x in carry] == [(6,), (6,)] and bool(carry[1].all())


@pytest.mark.parametrize("name", ["pursuit", "episode_mix"])
@pytest.mark.parametrize("env_name", ["MPE_simple_spread_v3", "MPE_simple_world_comm_v3"])
def test_pursuit_refused_where_jax_refuses(name, env_name):
    from mfvae_tpu.envs.mpe import make as j_make
    from mfvae_tpu_torch.envs.mpe import make as t_make

    jenv, tenv = j_make(env_name), t_make(env_name, device="cpu")
    jspec, tspec = j_build_spec(jenv), build_spec(tenv)
    with pytest.raises(ValueError, match="not defined for") as want:
        jpol.make_collect_policy(jenv, jspec, name, 0.1, j_make_action_sampler(jenv, jspec)[0])
    with pytest.raises(ValueError, match="not defined for") as got:
        tpol.make_collect_policy(tenv, tspec, name, 0.1, make_action_sampler(tenv, tspec)[0])
    assert str(got.value) == str(want.value)
