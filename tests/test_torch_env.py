"""The PyTorch SimpleTagEnv against the JAX one under state injection.

The physics is deterministic, so both envs start from one injected
``MPEState`` (made with numpy) and take the same actions; observations,
rewards and done flags are compared at every step.  Tolerance: atol 1e-5
(float32 on both sides; XLA and PyTorch round the norms and the softplus
contact term in different places, and 20 steps let that drift).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfvae_tpu.envs.mpe import MPEState as JState
from mfvae_tpu.envs.mpe import SimpleTagEnv as JEnv
from mfvae_tpu_torch.envs.mpe import MPEState as TState
from mfvae_tpu_torch.envs.mpe import SimpleTagEnv as TEnv
from mfvae_tpu_torch.envs.mpe import make
from mfvae_tpu_torch.envs.spaces import Box, Discrete, get_space_size

ATOL = 1e-5


def _random_state(n_agents, n_obs, seed, contact=False):
    rng = np.random.default_rng(seed)
    # contact=True packs the agents into a small square so contacts happen
    span = 0.25 if contact else 1.0
    return (
        rng.uniform(-span, span, (n_agents, 2)).astype(np.float32),
        rng.uniform(-0.5, 0.5, (n_agents, 2)).astype(np.float32),
        rng.uniform(-0.9, 0.9, (n_obs, 2)).astype(np.float32),
    )


def _pair(pop, max_steps):
    return JEnv(max_steps=max_steps, **pop), TEnv(max_steps=max_steps, device="cpu", **pop)


def _compare(jout, tout, t):
    jobs, _, jrew, jdone, _ = jout
    tobs, _, trew, tdone, _ = tout
    np.testing.assert_allclose(tobs.adversary.numpy(), np.asarray(jobs.adversary), atol=ATOL, rtol=0, err_msg=f"step {t}")
    np.testing.assert_allclose(tobs.good.numpy(), np.asarray(jobs.good), atol=ATOL, rtol=0, err_msg=f"step {t}")
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=ATOL, rtol=0, err_msg=f"step {t}")
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))


def _roll(pop, steps, seed, contact=False, max_steps=10):
    jenv, tenv = _pair(pop, max_steps)
    pos, vel, lm = _random_state(jenv.num_agents, jenv.num_obs, seed, contact)
    js = JState(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(lm), jnp.int32(0))
    ts = TState(torch.from_numpy(pos), torch.from_numpy(vel), torch.from_numpy(lm), torch.tensor(0, dtype=torch.int32))
    # the observation of the injected state itself
    _compare((jenv._observe(js), None, jnp.zeros(1), jnp.zeros(1, bool), None),
             (tenv._observe(ts), None, torch.zeros(1), torch.zeros(1, dtype=torch.bool), None), -1)
    rng = np.random.default_rng(seed + 100)
    for t in range(steps):
        act = rng.integers(0, 5, jenv.num_agents).astype(np.int32)
        jout = jenv.step_stacked(None, js, jnp.asarray(act))
        tout = tenv.step_stacked(ts, torch.from_numpy(act))
        _compare(jout, tout, t)
        js, ts = jout[1], tout[1]
    return jenv, tenv


@pytest.mark.parametrize("contact", [False, True])
def test_small_population_20_steps(contact):
    # max_steps=10 puts a done flag inside the 20 steps
    _roll(dict(num_good_agents=2, num_adversaries=3, num_obs=2), 20, seed=1, contact=contact)


def test_reference_population_2_steps():
    jenv, tenv = _roll(dict(num_good_agents=10, num_adversaries=30, num_obs=20), 2, seed=2, max_steps=1000)
    assert tenv.obs_dim("adversary_0") == jenv.obs_dim(True) == 142
    assert tenv.obs_dim("agent_0") == jenv.obs_dim(False) == 140


def test_batched_state_matches_unbatched():
    tenv = TEnv(num_good_agents=2, num_adversaries=3, num_obs=2, device="cpu")
    g = torch.Generator().manual_seed(0)
    obs_b, st_b = tenv.reset_stacked(g, batch_shape=(4,))
    act = torch.randint(0, 5, (4, tenv.num_agents), generator=g)
    out_b = tenv.step_stacked(st_b, act)
    for e in range(4):
        st = TState(*(x[e] for x in st_b))
        out = tenv.step_stacked(st, act[e])
        torch.testing.assert_close(out[0].adversary, out_b[0].adversary[e])
        torch.testing.assert_close(out[0].good, out_b[0].good[e])
        torch.testing.assert_close(out[2], out_b[2][e])


def test_reset_ranges_and_make():
    env = make("MPE_simple_tag_v3", device="cpu", num_good_agents=2, num_adversaries=3, num_obs=2, unused=1)
    obs, st = env.reset_stacked(torch.Generator().manual_seed(0))
    assert st.agent_pos.abs().max() <= 1.0 and st.landmark_pos.abs().max() <= 0.9
    assert obs.adversary.shape == (3, env.obs_dim(True)) and obs.good.shape == (2, env.obs_dim(False))
    assert get_space_size(env.action_space("adversary_0")) == 5
    assert isinstance(env.action_space("agent_0"), Discrete)
    assert get_space_size(Box(-1.0, 1.0, (2,))) == 2
    # every scenario of the JAX registry is made; tests/test_torch_scenarios.py holds them
    spread = make("MPE_simple_spread_v3", device="cpu", num_good_agents=3)
    assert spread.agents == ("agent_0", "agent_1", "agent_2")
    with pytest.raises(ValueError):
        make("nope", device="cpu")
