"""The port's planners (``mfvae_tpu_torch/planning.py``) against
``mfvae_tpu/planning.py``.

A tiny ``WorldModel`` (the JAX ``init`` bridged by ``params_from_jax``)
serves both packages.  The port cannot replay threefry, so its actors take
the draws as inputs, and each test hands them JAX's own, replayed from the
JAX actor's key:

- MPC (joint, factorized, repeat, a custom ``score_fn``): JAX's plans; the
  chosen joint action must equal the JAX actor's, exactly.
- CEM with ``iters`` 1 and 2, with the ``proposal_fn`` warm start, and on a
  simple_world_comm spec whose leader has 20 actions beside 5 (the invalid
  ids masked): each iteration's Gumbel noise and uniform draw and the
  final draw; the action must equal the JAX actor's, exactly.
- ``EnvDynamicsModel._rollout`` against JAX's on an injected state at atol
  1e-5, and against stepping the port's env by hand.
- An [E]-batched call of each actor equals E single calls with the same
  draws.
- ``eval_joint_policy`` returns [E, T, A]; through true dynamics,
  distance-scored factorized MPC beats random on adversary return, as
  tests/test_planning.py requires of the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfvae_tpu import planning as jplan
from mfvae_tpu.config import ModelConfig as JModelConfig
from mfvae_tpu.envs.mpe import make as j_make
from mfvae_tpu.inference import WorldModel as JWorldModel
from mfvae_tpu.models.mavae import GroupedBatch as JBatch
from mfvae_tpu.models.mavae import MAVAE as JMAVAE
from mfvae_tpu.models.mavae import zero_actions_grouped as j_zero_actions
from mfvae_tpu.training.experiment import build_spec as j_build_spec
from mfvae_tpu.training.trainer import make_action_sampler as j_make_action_sampler
from mfvae_tpu.training.trainer import stacked_to_grouped as j_stacked_to_grouped
from mfvae_tpu_torch import planning as tplan
from mfvae_tpu_torch.config import ModelConfig
from mfvae_tpu_torch.envs.mpe import make
from mfvae_tpu_torch.inference import WorldModel
from mfvae_tpu_torch.models.convert import params_from_jax
from mfvae_tpu_torch.models.mavae import MAVAE
from mfvae_tpu_torch.training.experiment import build_spec
from mfvae_tpu_torch.training.trainer import make_action_sampler
from tests.test_torch_experiment import one_torch_thread  # noqa: F401

TAG = ("MPE_simple_tag_v3", dict(num_good_agents=1, num_adversaries=2, num_obs=1, max_steps=16))
WORLD_COMM = ("MPE_simple_world_comm_v3", dict(num_good_agents=2, num_adversaries=2, num_obs=1, max_steps=16))
MODEL = dict(idx_features=8, obs_features=8, action_features=8, encoder_hidden=(16,), decoder_hidden=(32,),
             compute_dtype="float32")
H, N = 3, 8


class Setup:
    """Both packages' env, spec and world model over one set of params."""

    def __init__(self, scenario=TAG, discrete=True):
        name, pop = scenario
        self.jenv = j_make(name, discrete_actions=discrete, **pop)
        self.tenv = make(name, device="cpu", discrete_actions=discrete, **pop)
        self.jspec, self.tspec = j_build_spec(self.jenv), build_spec(self.tenv)
        jcfg = JModelConfig(discrete_act=discrete, **MODEL)
        jmodel = JMAVAE.from_config(jcfg, self.jspec)
        obs, _ = self.jenv.reset_stacked(jax.random.PRNGKey(0))
        obs_g = tuple(o[None] for o in j_stacked_to_grouped(self.jspec, obs))
        batch = JBatch(obs=obs_g, actions=j_zero_actions(self.jspec, 1, discrete))
        variables = jax.device_get(jmodel.init(jax.random.PRNGKey(0), batch, None, jax.random.PRNGKey(1)))
        self.jwm = JWorldModel(jmodel, variables)
        tmodel = MAVAE.from_config(ModelConfig(discrete_act=discrete, **MODEL), self.tspec, device="cpu")
        tmodel.load_state_dict(params_from_jax(variables), strict=True)
        self.twm = WorldModel(tmodel)
        self.jsample = j_make_action_sampler(self.jenv, self.jspec)[0]
        self.tsample = make_action_sampler(self.tenv, self.tspec)[0]

    def start(self, seed, n_envs=None):
        """(JAX obs, JAX state, port obs, port state) of JAX resets; with
        ``n_envs`` the port's carry a leading [n_envs] axis."""
        keys = [jax.random.PRNGKey(seed + e) for e in range(n_envs or 1)]
        outs = [self.jenv.reset_stacked(k) for k in keys]
        stack = (lambda xs: np.stack(xs)) if n_envs else (lambda xs: xs[0])
        _, proto = self.tenv.reset_stacked(torch.Generator().manual_seed(0))
        tstate = type(proto)(*(torch.from_numpy(np.array(stack([np.asarray(o[1][i]) for o in outs])))
                               for i in range(len(proto))))
        return outs[0][0], outs[0][1], self.tenv._observe(tstate), tstate


def t(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------------- MPC
def neg_reward_j(states, rewards):
    return -jnp.sum(rewards, axis=(0, 2))


def neg_reward_t(states, rewards):
    return -torch.sum(rewards, dim=(0, 2))


MPC_MODES = {
    "joint": dict(),
    "factorized": dict(plan_agents=(0, 1), factorized=True),
    "repeat": dict(factorized=True, candidate_mode="repeat"),
    "score_fn": dict(score_fn=(neg_reward_j, neg_reward_t)),
}


def _mpc_pair(s, wm_pair, mode):
    kw = dict(MPC_MODES[mode])
    jscore, tscore = kw.pop("score_fn", (None, None))
    jact = jplan.make_mpc_actor(wm_pair[0], s.jenv, s.jspec, horizon=H, n_candidates=N, score_fn=jscore, **kw)
    tact = tplan.make_mpc_actor(wm_pair[1], s.tenv, s.tspec, horizon=H, n_candidates=N, score_fn=tscore, **kw)
    return jact, tact


def _jax_plans(s, key, mode):
    if MPC_MODES[mode].get("candidate_mode") == "repeat":
        first = s.jsample(key, (N,))
        return jnp.broadcast_to(first[None], (H,) + first.shape)
    return s.jsample(key, (H, N))


@pytest.mark.parametrize("mode", sorted(MPC_MODES))
def test_mpc_chooses_jaxs_action_from_jaxs_plans(mode):
    s = Setup()
    jact, tact = _mpc_pair(s, (s.jwm, s.twm), mode)
    for seed in range(3):
        jobs, _, tobs, _ = s.start(10 + seed)
        key = jax.random.PRNGKey(20 + seed)
        want = np.asarray(jact(jobs, key))
        got = tact(tobs, plans=t(_jax_plans(s, key, mode)))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"seed {seed}")


@pytest.mark.parametrize("mode", ["joint", "factorized"])
def test_mpc_through_true_dynamics_matches_jax(mode):
    s = Setup(WORLD_COMM)
    jact, tact = _mpc_pair(s, (jplan.EnvDynamicsModel(s.jenv, s.jspec), tplan.EnvDynamicsModel(s.tenv, s.tspec)),
                           mode)
    jobs, jstate, tobs, tstate = s.start(30)
    key = jax.random.PRNGKey(31)
    want = np.asarray(jact(jobs, key, jstate))
    np.testing.assert_array_equal(tact(tobs, None, tstate, plans=t(_jax_plans(s, key, mode))).numpy(), want)
    with pytest.raises(ValueError, match="EnvDynamicsModel"):
        tact(tobs, torch.Generator().manual_seed(0))


def test_mpc_continuous_actions():
    s = Setup(discrete=False)
    jact, tact = _mpc_pair(s, (s.jwm, s.twm), "factorized")
    jobs, _, tobs, _ = s.start(32)
    key = jax.random.PRNGKey(33)
    want = np.asarray(jact(jobs, key))
    got = tact(tobs, plans=t(s.jsample(key, (H, N))))
    assert tuple(got.shape) == (3, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(NotImplementedError, match="discrete"):
        tplan.make_cem_actor(s.twm, s.tenv, s.tspec)


# --------------------------------------------------------------------- CEM
def jax_cem_noise(s, key, iters, p, k, n=16):
    """The draws of JAX's CEM actor for ``key``: each iteration's Gumbel
    noise (categorical = argmax(gumbel + logits)) and uniform actions, and
    the final uniform draw."""
    gumbel, others = [], []
    for i in range(iters):
        k_plan, k_other = jax.random.split(jax.random.fold_in(key, i))
        gumbel.append(t(jax.random.gumbel(k_plan, (H, n, p, k))))
        others.append(t(s.jsample(k_other, (H, n))))
    return tplan.CEMNoise(gumbel, others, t(s.jsample(jax.random.fold_in(key, iters))))


def _proposal(p, k):
    logits = np.zeros((p, k), np.float32)
    logits[:, 2] = 3.0
    logits[0, 4] = 2.0
    return logits


CEM_CASES = {
    "tag iters=1": (TAG, dict(iters=1, plan_agents=(0, 1))),
    "tag iters=3": (TAG, dict(iters=3, plan_agents=(0, 1))),
    "tag iters=2 proposal": (TAG, dict(iters=2, plan_agents=(0, 1), proposal=True)),
    # true tag rewards are 0 without a contact: most scores tie, and the
    # elites are the lowest tied candidates, as lax.top_k keeps them
    "tag iters=2 true dynamics": (TAG, dict(iters=2, plan_agents=(0, 1), true_dynamics=True)),
    "world_comm iters=2": (WORLD_COMM, dict(iters=2)),
    "world_comm iters=1 proposal": (WORLD_COMM, dict(iters=1, plan_agents=(0, 1, 3), proposal=True)),
    "world_comm iters=2 true dynamics": (WORLD_COMM, dict(iters=2, true_dynamics=True)),
    # a coarse score: many ties, which the elites and the best-seen update break
    "world_comm iters=3 true dynamics, coarse score": (WORLD_COMM, dict(iters=3, true_dynamics=True, coarse=True)),
    "tag iters=3 coarse score": (TAG, dict(iters=3, plan_agents=(0, 1), coarse=True)),
}
CEM_N, ELITE_FRAC = 16, 0.25  # four elites per agent


@pytest.mark.parametrize("case", sorted(CEM_CASES))
def test_cem_chooses_jaxs_action_from_jaxs_draws(case):
    scenario, kw = CEM_CASES[case]
    kw = dict(kw, elite_frac=ELITE_FRAC)
    s = Setup(scenario)
    plan = kw.get("plan_agents") or tuple(range(s.tspec.n_agents))
    p, k = len(plan), max(s.tspec.act_dims)
    jprop = tprop = None
    if kw.pop("proposal", False):
        prop = _proposal(p, k)
        jprop, tprop = (lambda obs: jnp.asarray(prop)), (lambda obs: torch.from_numpy(prop))
    jscore = tscore = None
    if kw.pop("coarse", False):
        idx = list(plan)
        jscore = lambda st, rew: jnp.floor(jnp.sum(rew[..., jnp.asarray(idx)], axis=0) * 2.0)  # noqa: E731
        tscore = lambda st, rew: torch.floor(torch.sum(rew[..., idx], dim=0) * 2.0)  # noqa: E731
    jwm, twm = s.jwm, s.twm
    if kw.pop("true_dynamics", False):
        jwm, twm = jplan.EnvDynamicsModel(s.jenv, s.jspec), tplan.EnvDynamicsModel(s.tenv, s.tspec)
    jact = jplan.make_cem_actor(jwm, s.jenv, s.jspec, horizon=H, n_candidates=CEM_N, proposal_fn=jprop,
                                score_fn=jscore, **kw)
    tact = tplan.make_cem_actor(twm, s.tenv, s.tspec, horizon=H, n_candidates=CEM_N, proposal_fn=tprop,
                                score_fn=tscore, **kw)
    for seed in range(2):
        jobs, jstate, tobs, tstate = s.start(40 + seed)
        key = jax.random.PRNGKey(50 + seed)
        want = np.asarray(jax.jit(jact)(jobs, key, jstate))
        got = tact(tobs, None, tstate, noise=jax_cem_noise(s, key, kw["iters"], p, k))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"seed {seed}")
        assert (got.numpy() < np.asarray(s.tspec.act_dims)).all()


def test_cem_masks_the_ids_past_an_agents_actions():
    s = Setup(WORLD_COMM)
    act = tplan.make_cem_actor(s.twm, s.tenv, s.tspec, horizon=H, n_candidates=N, iters=2)
    assert act.valid.sum(-1).tolist() == [20, 5, 5, 5]
    _, _, tobs, _ = s.start(60)
    g = torch.Generator().manual_seed(61)
    for _ in range(5):
        a = act(tobs, g)
        assert (a.numpy() < np.asarray(s.tspec.act_dims)).all() and (a.numpy() >= 0).all()


# ------------------------------------------------------ true dynamics
@pytest.mark.parametrize("scenario", [TAG, WORLD_COMM], ids=["tag", "world_comm"])
def test_env_dynamics_rollout_matches_jax_and_the_env_by_hand(scenario):
    s = Setup(scenario)
    _, jstate, _, tstate = s.start(70)
    plans = s.jsample(jax.random.PRNGKey(71), (H, N))
    want_s, want_r = jplan.EnvDynamicsModel(s.jenv, s.jspec)._rollout(jstate, plans)
    tdm = tplan.EnvDynamicsModel(s.tenv, s.tspec)
    got_s, got_r = tdm._rollout(tstate, t(plans))
    assert tuple(got_s.shape) == (H, N, sum(s.tspec.obs_dims)) and tuple(got_r.shape) == (H, N, s.tspec.n_agents)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), atol=1e-5, rtol=0)
    from mfvae_tpu_torch.rollout_eval import flatten_global_state
    from mfvae_tpu_torch.training.trainer import stacked_to_grouped

    for n in range(N):
        st = tstate
        for h in range(H):
            obs, st, rew, _, _ = s.tenv.step_stacked(st, t(plans[h, n]))
            torch.testing.assert_close(got_s[h, n], flatten_global_state(s.tspec, stacked_to_grouped(s.tspec, obs)),
                                       rtol=0, atol=0)
            torch.testing.assert_close(got_r[h, n], rew, rtol=0, atol=0)


# ------------------------------------------------------------- batching
E = 3


def _slice_noise(noise, e):
    return tplan.CEMNoise([g[:, e] for g in noise.gumbel], [o[:, e] for o in noise.others], noise.final[e])


@pytest.mark.parametrize("actor", ["mpc", "mpc true dynamics", "cem", "cem true dynamics"])
def test_batched_call_equals_single_calls(actor):
    s = Setup()
    wm = tplan.EnvDynamicsModel(s.tenv, s.tspec) if "true" in actor else s.twm
    _, _, tobs, tstate = s.start(80, n_envs=E)
    g = torch.Generator().manual_seed(81)
    if actor.startswith("mpc"):
        act = tplan.make_mpc_actor(wm, s.tenv, s.tspec, horizon=H, n_candidates=N, plan_agents=(0, 1),
                                   factorized=True)
        plans = s.tsample(g, (H, E, N))
        batched = act(tobs, None, tstate, plans=plans)
        singles = [act(type(tobs)(*(o[e] for o in tobs)), None, type(tstate)(*(x[e] for x in tstate)),
                       plans=plans[:, e]) for e in range(E)]
    else:
        act = tplan.make_cem_actor(wm, s.tenv, s.tspec, horizon=H, n_candidates=N, plan_agents=(0, 1), iters=2)
        noise = act.draw_noise(g, (E,))
        batched = act(tobs, None, tstate, noise=noise)
        singles = [act(type(tobs)(*(o[e] for o in tobs)), None, type(tstate)(*(x[e] for x in tstate)),
                       noise=_slice_noise(noise, e)) for e in range(E)]
    assert tuple(batched.shape) == (E, s.tspec.n_agents)
    torch.testing.assert_close(batched, torch.stack(singles), rtol=0, atol=0)


# ------------------------------------------------------------ eval loop
def test_eval_joint_policy_shape_and_true_dynamics_mpc_beats_random():
    s = Setup()
    n_adv, od_adv = 2, s.tspec.obs_dims[0]
    prey_off = 4 + 2 * 1 + 2 * (n_adv - 1)  # tiny tag adversary obs: [vel, pos, obstacle, other adv, prey, ...]

    def dist_fact(states, rewards):
        h, n = states.shape[:2]
        rel = states[:, :, : n_adv * od_adv].reshape(h, n, n_adv, od_adv)[..., prey_off : prey_off + 2]
        return -torch.sum(torch.sqrt(torch.sum(rel * rel, dim=-1) + 1e-12), dim=0)  # [N, n_adv]

    mpc = tplan.make_mpc_actor(tplan.EnvDynamicsModel(s.tenv, s.tspec), s.tenv, s.tspec, horizon=4,
                               n_candidates=16, plan_agents=(0, 1), score_fn=dist_fact, factorized=True,
                               candidate_mode="repeat")
    is_adv = torch.arange(s.tspec.n_agents) < n_adv

    def joint_mpc(obs, state, g):
        return torch.where(is_adv, mpc(obs, g, state), s.tsample(g, (8,)))

    def joint_rand(obs, state, g):
        return s.tsample(g, (8,))

    r_mpc = tplan.eval_joint_policy(s.tenv, s.tspec, joint_mpc, n_episodes=8, ep_len=16,
                                    generator=torch.Generator().manual_seed(42))
    r_rand = tplan.eval_joint_policy(s.tenv, s.tspec, joint_rand, n_episodes=8, ep_len=16,
                                     generator=torch.Generator().manual_seed(42))
    assert tuple(r_mpc.shape) == (8, 16, 3) and bool(torch.isfinite(r_mpc).all())
    adv_mpc = float(r_mpc[:, :, :n_adv].sum((1, 2)).mean())
    adv_rand = float(r_rand[:, :, :n_adv].sum((1, 2)).mean())
    assert adv_mpc > adv_rand, (adv_mpc, adv_rand)


def test_cem_in_the_eval_loop_through_the_learned_model():
    s = Setup()
    cem = tplan.make_cem_actor(s.twm, s.tenv, s.tspec, horizon=2, n_candidates=4, plan_agents=(0, 1), iters=2)
    is_adv = torch.arange(s.tspec.n_agents) < 2

    def joint(obs, state, g):
        return torch.where(is_adv, cem(obs, g), s.tsample(g, (2,)))

    rewards = tplan.eval_joint_policy(s.tenv, s.tspec, joint, n_episodes=2, ep_len=3,
                                      generator=torch.Generator().manual_seed(15))
    assert tuple(rewards.shape) == (2, 3, 3) and bool(torch.isfinite(rewards).all())
