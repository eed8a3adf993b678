"""simple_spread, simple_adversary and simple_world_comm of the port against
the JAX envs under state injection, as tests/test_torch_env.py holds
simple_tag.

Both envs start from one injected state (made with numpy) and take the same
actions; observations, rewards and done flags are compared at every step,
at atol 1e-5 (float32 on both sides; the norms and the softplus contact
term round in different places).  Over 20 steps at small populations, with
a done flag inside them:

- spread with the agents packed close (contacts and collision penalties);
- adversary at every goal index;
- world_comm with agents inside one forest, in different forests, on the
  food and outside the unit box, the leader's comm actions 0-19 in turn;
- continuous actions for spread and adversary.

And over 2 steps at the default ExperimentConfig population, as
``make`` builds it from the experiment's kwargs.  A batched [E] state must
equal E unbatched ones; the dict surface must equal the JAX package's; and
``make`` remaps ``num_good_agents`` for spread and refuses unknown names.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfvae_tpu.envs import mpe as J
from mfvae_tpu_torch.envs import mpe as T
from mfvae_tpu_torch.training.experiment import build_spec

ATOL = 1e-5
DEFAULT_POP = dict(num_good_agents=10, num_adversaries=30, num_obs=20, max_steps=1000)
SMALL = {
    "MPE_simple_spread_v3": dict(num_good_agents=4),
    "MPE_simple_adversary_v3": dict(num_good_agents=3),
    "MPE_simple_world_comm_v3": dict(num_good_agents=2, num_adversaries=4, num_obs=1),
}


def envs(name, **kw):
    return J.make(name, **kw), T.make(name, device="cpu", **kw)


def j_state(tstate):
    """The JAX package's state of one port state."""
    jcls = {T.MPEState: J.MPEState, T.AdversaryState: J.AdversaryState, T.WorldCommState: J.WorldCommState}
    return jcls[type(tstate)](*(jnp.asarray(x.numpy()) for x in tstate))


def inject(tenv, pos, vel, lm, **extra):
    """(JAX state, port state) of one injected numpy state; ``extra`` gives
    the fields past landmark_pos (goal, leader_comm) and step defaults to 0."""
    _, proto = tenv.reset_stacked(torch.Generator().manual_seed(0), batch_shape=pos.shape[:-2])
    fields = dict(agent_pos=pos, agent_vel=vel, landmark_pos=lm,
                  step=np.zeros(pos.shape[:-2], np.int32), **extra)
    arrays = [np.asarray(fields[f]) for f in proto._fields]
    tstate = type(proto)(*(torch.from_numpy(a) for a in arrays))
    return j_state(tstate), tstate


def compare(jout, tout, t):
    jobs, _, jrew, jdone, _ = jout
    tobs, _, trew, tdone, _ = tout
    assert len(jobs) == len(tobs)
    for a, b in zip(tobs, jobs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0, err_msg=f"step {t}")
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=ATOL, rtol=0, err_msg=f"step {t}")
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))


def actions(jenv, rng, t, discrete=True):
    if not discrete:
        return rng.uniform(-1, 1, (jenv.num_agents, 2)).astype(np.float32)
    dims = [jenv.action_space(a).n for a in jenv.agents]
    act = np.array([rng.integers(0, d) for d in dims], np.int32)
    if dims[0] > 5:
        act[0] = t % dims[0]  # the leader's comm actions in turn
    return act


def roll(jenv, tenv, jstate, tstate, steps, seed, discrete=True):
    compare((jenv._observe(jstate), None, jnp.zeros(1), jnp.zeros(1, bool), None),
            (tenv._observe(tstate), None, torch.zeros(1), torch.zeros(1, dtype=torch.bool), None), -1)
    rng = np.random.default_rng(seed)
    for t in range(steps):
        act = actions(jenv, rng, t, discrete)
        jout = jenv.step_stacked(None, jstate, jnp.asarray(act))
        tout = tenv.step_stacked(tstate, torch.from_numpy(act))
        compare(jout, tout, t)
        jstate, tstate = jout[1], tout[1]
    return jstate, tstate


def uniform_state(jenv, seed, span=1.0):
    rng = np.random.default_rng(seed)
    n = jenv.num_agents
    n_lm = jenv.num_obs if isinstance(jenv, J.SimpleTagEnv) else jenv.num_landmarks
    return (rng.uniform(-span, span, (n, 2)).astype(np.float32),
            rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32),
            rng.uniform(-0.9, 0.9, (n_lm, 2)).astype(np.float32))


# ----------------------------------------------------------------- spread
@pytest.mark.parametrize("discrete", [True, False])
@pytest.mark.parametrize("packed", [False, True])
def test_spread_20_steps(packed, discrete):
    jenv, tenv = envs("MPE_simple_spread_v3", max_steps=10, discrete_actions=discrete,
                      **SMALL["MPE_simple_spread_v3"])
    # packed: four agents of size .15 inside a 0.3 square all touch
    pos, vel, lm = uniform_state(jenv, 1, span=0.15 if packed else 1.0)
    js, ts = inject(tenv, pos, vel, lm)
    if packed:
        touching = torch.cdist(ts.agent_pos, ts.agent_pos) < 2 * T.SPREAD_AGENT_SIZE
        assert int(touching.sum()) > tenv.num_agents  # pairs beyond the diagonal
    roll(jenv, tenv, js, ts, 20, seed=2, discrete=discrete)


# -------------------------------------------------------------- adversary
@pytest.mark.parametrize("goal", [0, 1, 2])
def test_adversary_20_steps_at_every_goal(goal):
    jenv, tenv = envs("MPE_simple_adversary_v3", max_steps=10, **SMALL["MPE_simple_adversary_v3"])
    pos, vel, lm = uniform_state(jenv, 3 + goal)
    js, ts = inject(tenv, pos, vel, lm, goal=np.int32(goal))
    # the good agents see the goal: their first two columns are goal - own pos
    np.testing.assert_array_equal(tenv._observe(ts).good[:, :2].numpy(), lm[goal] - pos[1:])
    roll(jenv, tenv, js, ts, 20, seed=4 + goal)


def test_adversary_continuous_20_steps():
    jenv, tenv = envs("MPE_simple_adversary_v3", max_steps=10, discrete_actions=False,
                      **SMALL["MPE_simple_adversary_v3"])
    pos, vel, lm = uniform_state(jenv, 5)
    js, ts = inject(tenv, pos, vel, lm, goal=np.int32(1))
    roll(jenv, tenv, js, ts, 20, seed=6, discrete=False)


# -------------------------------------------------------------- world_comm
def world_comm_case(jenv, case, seed):
    """Agent, velocity and landmark positions for one case; landmarks are
    [obstacle, food 0, food 1, forest 0, forest 1] at the small population,
    agents [leader, adversary 0-2, agent 0-1]."""
    rng = np.random.default_rng(seed)
    pos, vel, lm = uniform_state(jenv, seed)
    vel *= 0.2
    lm[3], lm[4] = (0.4, 0.4), (-0.5, -0.4)
    jitter = lambda: rng.uniform(-0.15, 0.15, 2).astype(np.float32)  # noqa: E731
    if case == "same_forest":  # adversary 0 and both good agents in forest 0
        for i in (1, 4, 5):
            pos[i] = lm[3] + jitter()
    elif case == "different_forests":  # the leader and agent 0 in one, adversary 1 and agent 1 in the other
        pos[0], pos[4] = lm[3] + jitter(), lm[3] + jitter()
        pos[2], pos[5] = lm[4] + jitter(), lm[4] + jitter()
    elif case == "food":  # each good agent on a food, an adversary on a good agent
        pos[4], pos[5] = lm[1] + 0.02, lm[2] - 0.02
        pos[1] = pos[4] + 0.05
    elif case == "outside":  # good agents in every band of the bound, everyone beyond the box once
        pos[4], pos[5] = (0.95, -1.3), (-0.5, 1.05)
        pos[0], pos[2] = (-1.2, 0.1), (0.3, 1.4)
    return pos, vel, lm


@pytest.mark.parametrize("case", ["same_forest", "different_forests", "food", "outside"])
def test_world_comm_20_steps(case):
    jenv, tenv = envs("MPE_simple_world_comm_v3", max_steps=10, **SMALL["MPE_simple_world_comm_v3"])
    pos, vel, lm = world_comm_case(jenv, case, 7)
    js, ts = inject(tenv, pos, vel, lm, leader_comm=np.zeros(4, np.float32))
    in_f = tenv._forest_membership(ts)
    if case == "same_forest":
        assert in_f[[1, 4, 5], 0].all() and not in_f[[1, 4, 5], 1].any()
    if case == "different_forests":
        assert in_f[[0, 4], 0].all() and in_f[[2, 5], 1].all()
    if case == "food":
        # agent 1 eats food 1; adversary 0 touches agent 0, which the leader is paid for
        assert float(tenv._rewards(ts)[5]) > 1.0 and float(tenv._rewards(ts)[0]) >= 4.0
    if case == "outside":
        assert float(tenv._rewards(ts)[0]) < -9.0
    _, ts = roll(jenv, tenv, js, ts, 20, seed=8)


def test_world_comm_leader_action_splits_move_and_comm():
    jenv, tenv = envs("MPE_simple_world_comm_v3", **SMALL["MPE_simple_world_comm_v3"])
    pos, vel, lm = world_comm_case(jenv, "none", 9)
    _, ts = inject(tenv, pos, np.zeros_like(vel), lm, leader_comm=np.zeros(4, np.float32))
    for a in range(20):
        act = torch.zeros(tenv.num_agents, dtype=torch.int32)
        act[0] = a
        _, st, *_ = tenv.step_stacked(ts, act)
        assert st.leader_comm.tolist() == [float(i == a // 5) for i in range(4)]
        # from rest: velocity accel × DT, displacement that × DT
        want = torch.tensor(T.DISCRETE_DIRECTIONS[a % 5]) * T.ADV_ACCEL * T.DT * T.DT
        torch.testing.assert_close(st.agent_pos[0] - ts.agent_pos[0], want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="discrete"):
        T.make("MPE_simple_world_comm_v3", device="cpu", discrete_actions=False).action_space("agent_0")


# ------------------------------------------------ the default population
@pytest.mark.parametrize("name,dims", [
    ("MPE_simple_spread_v3", (60,)),
    ("MPE_simple_adversary_v3", (40, 42)),
    ("MPE_simple_world_comm_v3", (156, 164, 150)),
])
def test_default_population_2_steps(name, dims):
    jenv, tenv = envs(name, discrete_actions=True, **DEFAULT_POP)
    assert tuple(dict.fromkeys(tenv.obs_dim(a) for a in tenv.agents)) == dims
    assert [tenv.obs_dim(a) for a in tenv.agents] == [jenv.obs_dim(a) for a in jenv.agents]
    assert tenv.agents == jenv.agents
    pos, vel, lm = uniform_state(jenv, 10)
    extra = {"MPE_simple_adversary_v3": dict(goal=np.int32(7)),
             "MPE_simple_world_comm_v3": dict(leader_comm=np.zeros(4, np.float32))}.get(name, {})
    js, ts = inject(tenv, pos, vel, lm, **extra)
    roll(jenv, tenv, js, ts, 2, seed=11)


# ------------------------------------------------------------ batched, dict
def batched_state(tenv, e, seed):
    _, st = tenv.reset_stacked(torch.Generator().manual_seed(seed), batch_shape=(e,))
    g = torch.Generator().manual_seed(seed + 1)
    st = st._replace(agent_vel=torch.rand(st.agent_vel.shape, generator=g) - 0.5)
    if hasattr(st, "leader_comm"):
        st = st._replace(leader_comm=torch.eye(4)[torch.arange(e) % 4])
    return st


def random_actions(tenv, lead, seed):
    g = torch.Generator().manual_seed(seed)
    if not tenv.discrete_actions:
        return 2 * torch.rand(*lead, tenv.num_agents, 2, generator=g) - 1
    dims = torch.tensor([tenv.action_space(a).n for a in tenv.agents])
    return (torch.rand(*lead, tenv.num_agents, generator=g) * dims).to(torch.int32)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_batched_state_matches_unbatched(name):
    jenv, tenv = envs(name, max_steps=3, **SMALL[name])
    e = 4
    st_b = batched_state(tenv, e, 12)
    if name == "MPE_simple_adversary_v3":
        st_b = st_b._replace(goal=torch.tensor([0, 1, 2, 1], dtype=torch.int32))
    act = random_actions(tenv, (e,), 13)
    out_b = tenv.step_stacked(st_b, act)
    for i in range(e):
        st = type(st_b)(*(x[i] for x in st_b))
        out = tenv.step_stacked(st, act[i])
        for a, b in zip(out[0], out_b[0]):
            torch.testing.assert_close(a, b[i], rtol=0, atol=0)
        torch.testing.assert_close(out[2], out_b[2][i], rtol=0, atol=0)
        torch.testing.assert_close(out[3], out_b[3][i], rtol=0, atol=0)
        # and the JAX env on the same env's state
        jout = jenv.step_stacked(None, j_state(st), jnp.asarray(act[i].numpy()))
        compare(jout, out, i)


@pytest.mark.parametrize("name", sorted(SMALL) + ["MPE_simple_tag_v3"])
def test_dict_surface_matches_jax(name):
    kw = SMALL.get(name, dict(num_good_agents=2, num_adversaries=3, num_obs=2))
    jenv, tenv = envs(name, max_steps=1, **kw)
    obs_d, st = tenv.reset(torch.Generator().manual_seed(14))
    assert list(obs_d) == list(tenv.agents)
    for a, o in obs_d.items():
        assert tuple(o.shape) == (tenv.obs_dim(a),)
    act = random_actions(tenv, (), 15)
    act_d = {a: act[i] for i, a in enumerate(tenv.agents)}
    tobs, _, trew, tdone, _ = tenv.step(st, act_d)
    jobs, _, jrew, jdone, _ = jenv.step(None, j_state(st),
                                        {a: jnp.asarray(v.numpy()) for a, v in act_d.items()})
    assert list(tobs) == list(jobs) and list(trew) == list(jrew) and list(tdone) == list(jdone)
    for a in jobs:
        np.testing.assert_allclose(tobs[a].numpy(), np.asarray(jobs[a]), atol=ATOL, rtol=0)
        np.testing.assert_allclose(trew[a].numpy(), np.asarray(jrew[a]), atol=ATOL, rtol=0)
    for a in jdone:
        assert bool(tdone[a]) and bool(jdone[a])  # max_steps 1
    # over a leading [E] axis too
    st_b = batched_state(tenv, 3, 16)
    act_b = random_actions(tenv, (3,), 17)
    obs_b, _, rew_b, done_b, _ = tenv.step(st_b, {a: act_b[:, i] for i, a in enumerate(tenv.agents)})
    stacked = tenv.step_stacked(st_b, act_b)
    for i, a in enumerate(tenv.agents):
        torch.testing.assert_close(rew_b[a], stacked[2][:, i], rtol=0, atol=0)
    assert tuple(done_b["__all__"].shape) == (3,)
    assert tuple(obs_b[tenv.agents[-1]].shape) == (3, tenv.obs_dim(tenv.agents[-1]))


def test_make_remaps_and_refuses_as_jax():
    kw = dict(num_good_agents=5, num_adversaries=7, num_obs=3, max_steps=9, unused=1)
    for name in sorted(SMALL):
        jenv, tenv = envs(name, **kw)
        assert tenv.agents == jenv.agents and tenv.max_steps == jenv.max_steps == 9
    spread = T.make("MPE_simple_spread_v3", device="cpu", num_good_agents=6)
    assert spread.num_agents == 6 and spread.obs_dim() == 4 + 12 + 20
    with pytest.raises(ValueError, match="unknown env"):
        T.make("MPE_simple_push_v3", device="cpu")


@pytest.mark.parametrize("name", sorted(SMALL))
def test_reset_ranges(name):
    tenv = T.make(name, device="cpu", **SMALL[name])
    obs, st = tenv.reset_stacked(torch.Generator().manual_seed(18), batch_shape=(64,))
    assert float(st.agent_pos.abs().max()) <= 1.0 and float(st.landmark_pos.abs().max()) <= 0.9
    assert not bool(st.agent_vel.any()) and not bool(st.step.any())
    if name == "MPE_simple_adversary_v3":
        assert st.goal.dtype == torch.int32 and set(st.goal.tolist()) == {0, 1, 2}
    if name == "MPE_simple_world_comm_v3":
        assert tuple(st.leader_comm.shape) == (64, 4) and not bool(st.leader_comm.any())
    # one class tensor per agent group (the leader's 34 equals an
    # adversary's at this population; its 20 actions set it apart)
    assert [(o.shape[-2], o.shape[-1]) for o in obs] == [(len(i), od) for (od, _), i in build_spec(tenv).groups]
