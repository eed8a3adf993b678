"""The port's imagination networks, rollout, REINFORCE and actor-critic
trainers and policy actor (``mfvae_tpu_torch/imagination.py``) against
``mfvae_tpu/imagination.py``.

Both packages share one tiny simple_tag world model (2 adversaries, 1 good
agent, 1 obstacle; the JAX ``init`` bridged by ``params_from_jax``) and
the policy networks' JAX params (bridged by ``policy_params_from_jax``).
The port cannot replay threefry, so every draw is handed in: JAX's
categorical is argmax(logits + Gumbel(k)), its Gaussian action takes
normal(k), and the other agents' actions are the JAX sampler's, each
replayed from the key the JAX function splits.

Tolerances (float32 both; JAX matmul precision "highest"):
- the networks' forwards, ``tanh_gaussian_sample``, ``lambda_returns``,
  ``symlog``/``symexp``: rtol 1e-6; ``symexp`` near 0 also atol 2^-23
  (XLA's exp differs from torch's by an ulp), the Gaussian logp and the
  λ-returns atol 1e-6 (sums of terms up to ~8 that cancel, rounded
  through FMAs by XLA), and each forward atol 1e-6 of
  its largest output (a product summed in another order moves an
  output by an ulp of the largest terms, not of itself);
- the H = 4 rollout on the real tiny MAVAE: states, rewards, logp and
  entropy rtol 1e-5 (atol 1e-6 for the same reason); discrete sampled
  actions equal, continuous ones rtol 1e-5;
- params after one Adam step: rtol 1e-5 (atol 1e-7: a parameter that
  starts at 0 is compared to its own size, a few lr); the update's
  metrics, means of products that cancel, rtol 1e-4 / atol 1e-5;
- the continuous actor-critic's grads before the step: rtol 1e-4 (atol
  1e-4 of the largest grad of the leaf).  JAX's grads are read from its
  Adam state after one step, mu = (1 - b1)·g.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfvae_tpu import imagination as jimag
from mfvae_tpu.models.mavae import state_to_grouped as j_state_to_grouped
from mfvae_tpu_torch import imagination as timag
from mfvae_tpu_torch.imagination import ActorNoise, ImaginationNoise
from mfvae_tpu_torch.models.mavae import GroupedBatch
from mfvae_tpu_torch.models.convert import policy_params_from_jax
from tests.test_torch_experiment import one_torch_thread  # noqa: F401
from tests.test_torch_planning import Setup, t

PLAN = (0, 1)
P = len(PLAN)
H, S, N = 4, 3, 2  # horizon, starts, rollouts per start
HIDDEN = (16,)


def bridge(jparams):
    return policy_params_from_jax(jax.device_get(jparams))


def assert_state_close(module, jparams, rtol=1e-5, atol=1e-7):
    want = bridge(jparams)
    got = module.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(), rtol=rtol, atol=atol, err_msg=name)


def starts(s, n, seed):
    """Per-group start obs [n, A_g, od] in both packages."""
    rng = np.random.default_rng(seed)
    obs = [rng.normal(size=(n, len(idxs), od)).astype(np.float32) for (od, _), idxs in s.jspec.groups]
    return tuple(map(jnp.asarray, obs)), tuple(map(torch.from_numpy, obs))


def jax_rollout_noise(s, key, horizon, b, discrete):
    """The draws of JAX's rollout for ``key``: per step k_plan, k_other."""
    pol, others = [], []
    shape = (b, P, s.tspec.act_dims[0])
    for k_t in jax.random.split(key, horizon):
        k_plan, k_other = jax.random.split(k_t)
        pol.append(jax.random.gumbel(k_plan, shape) if discrete else jax.random.normal(k_plan, shape))
        others.append(s.jsample(k_other, (b,)))
    return ImaginationNoise(t(np.stack(pol)), t(np.stack(others)))


# ----------------------------------------------------------------- networks
NETS = {
    "policy": (lambda: jimag.PolicyMLP(hidden=(16, 8), act_dim=5),
               lambda: timag.PolicyMLP(12, (16, 8), 5)),
    "gaussian": (lambda: jimag.GaussianPolicyMLP(hidden=(16, 8), act_dim=2),
                 lambda: timag.GaussianPolicyMLP(12, (16, 8), 2)),
    "value": (lambda: jimag.ValueMLP(hidden=(16, 8)), lambda: timag.ValueMLP(12, (16, 8))),
}


@pytest.mark.parametrize("net", sorted(NETS))
def test_network_forward_matches_jax(net):
    jnet, tnet = NETS[net][0](), NETS[net][1]()
    x = np.random.default_rng(0).normal(size=(6, 3, 12)).astype(np.float32)
    jparams = jnet.init(jax.random.PRNGKey(1), jnp.asarray(x[:1, :1]))
    assert set(tnet.state_dict()) == set(bridge(jparams))
    tnet.load_state_dict(bridge(jparams))
    want = jnet.apply(jparams, jnp.asarray(x))
    got = tnet(torch.from_numpy(x))
    if net != "gaussian":
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-6, atol=1e-6 * np.abs(w).max())


def test_fresh_networks_have_flax_init():
    g = torch.Generator().manual_seed(0)
    net = timag.GaussianPolicyMLP(12, (16, 8), 2, generator=g)
    for name, p in net.state_dict().items():
        if name == "norm.scale":
            assert torch.all(p == 1)
        elif name.endswith("bias"):
            assert torch.all(p == 0), name
        else:
            assert p.abs().max() <= 2.0 / (0.87962566 * p.shape[0] ** 0.5) + 1e-6, name
            assert p.abs().max() > 0, name


# ------------------------------------------------------------- elementwise
def test_tanh_gaussian_sample_and_entropy_given_jaxs_draws():
    rng = np.random.default_rng(2)
    mu = rng.normal(size=(5, 3, 2)).astype(np.float32)
    log_std = rng.uniform(-2, 0.5, size=(5, 3, 2)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ja, jlogp = jimag.tanh_gaussian_sample(jnp.asarray(mu), jnp.asarray(log_std), key, -1.0, 1.0)
    noise = t(jax.random.normal(key, mu.shape))
    ta, tlogp = timag.tanh_gaussian_sample(t(mu), t(log_std), noise, -1.0, 1.0)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6)
    # logp sums terms of magnitude up to ~8 that cancel: an ulp of them is
    # 1e-6 of a result that may lie near 0
    np.testing.assert_allclose(tlogp.numpy(), np.asarray(jlogp), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(timag.gaussian_entropy(t(log_std)).numpy(),
                               np.asarray(jimag.gaussian_entropy(jnp.asarray(log_std))), rtol=1e-6)


@pytest.mark.parametrize("lam", [0.0, 0.5, 0.95, 1.0])
def test_lambda_returns_match_jax(lam):
    rng = np.random.default_rng(4)
    r = rng.normal(size=(6, 4, 2)).astype(np.float32)
    v = rng.normal(size=(6, 4, 2)).astype(np.float32)
    want = jimag.lambda_returns(jnp.asarray(r), jnp.asarray(v), 0.9, lam)
    # XLA contracts the multiply-adds into FMAs: a few ulps of terms up to
    # ~5 on results that may lie near 0
    np.testing.assert_allclose(timag.lambda_returns(t(r), t(v), 0.9, lam).numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_symlog_symexp_match_jax():
    x = np.concatenate([np.linspace(-50, 50, 201), np.linspace(-1e-3, 1e-3, 21)]).astype(np.float32)
    np.testing.assert_allclose(timag.symlog(t(x)).numpy(), np.asarray(jimag.symlog(jnp.asarray(x))), rtol=1e-6)
    y = x / 10.0
    np.testing.assert_allclose(timag.symexp(t(y)).numpy(), np.asarray(jimag.symexp(jnp.asarray(y))),
                               rtol=1e-6, atol=2.0 ** -23)


def test_plan_prefix_and_obs_builder():
    s = Setup()
    with pytest.raises(ValueError, match="prefix"):
        timag.make_obs_builder(s.tspec, (1, 0))
    _, tobs = starts(s, 4, 5)
    jobs, _ = starts(s, 4, 5)
    for centralized in (False, True):
        jfn, jdim = jimag.make_obs_builder(s.jspec, PLAN, centralized)
        tfn, tdim = timag.make_obs_builder(s.tspec, PLAN, centralized)
        assert tdim == jdim == (12 + 12 + 12 + 10 if centralized else 12)
        torch.testing.assert_close(tfn(tobs), t(jfn(jobs)), rtol=0, atol=0)


# ------------------------------------------------------------------ rollout
@pytest.mark.parametrize("discrete", [True, False], ids=["discrete", "continuous"])
def test_rollout_matches_jax(discrete):
    s = Setup(discrete=discrete)
    b = 6
    jobs, tobs = starts(s, b, 6)
    k = s.tspec.act_dims[0]
    jnet = jimag.PolicyMLP(hidden=HIDDEN, act_dim=k) if discrete else jimag.GaussianPolicyMLP(hidden=HIDDEN, act_dim=k)
    jparams = jnet.init(jax.random.PRNGKey(7), jobs[0][:1, :1])
    tnet = (timag.PolicyMLP if discrete else timag.GaussianPolicyMLP)(12, HIDDEN, k)
    tnet.load_state_dict(bridge(jparams))
    key = jax.random.PRNGKey(8)
    jroll = jimag.make_imagination_rollout(s.jwm, s.jenv, s.jspec, PLAN, horizon=H)
    want = jroll(jparams, jnet.apply, jobs, key)
    seen = []
    predict = s.twm._predict
    s.twm._predict = lambda batch: (seen.append(batch.actions[0][:, :P]), predict(batch))[1]
    troll = timag.make_imagination_rollout(s.twm, s.tenv, s.tspec, PLAN, horizon=H)
    got = troll(tnet, tobs, noise=jax_rollout_noise(s, key, H, b, discrete))
    for g, w, name in zip(got, want, ("states", "rewards", "logp", "ent")):
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-5, atol=1e-6, err_msg=name)
    # the plan agents' actions at each step, recomputed from JAX's states and keys
    for step, k_t in enumerate(jax.random.split(key, H)):
        k_plan, _ = jax.random.split(k_t)
        obs_t = jobs if step == 0 else j_state_to_grouped(s.jspec, want[0][step - 1])
        if discrete:
            logits = jax.nn.log_softmax(jnet.apply(jparams, obs_t[0][:, :P]), axis=-1)
            np.testing.assert_array_equal(seen[step].numpy(), np.asarray(jax.random.categorical(k_plan, logits)))
        else:
            mu, log_std = jnet.apply(jparams, obs_t[0][:, :P])
            a, _ = jimag.tanh_gaussian_sample(mu, log_std, k_plan, -1.0, 1.0)
            np.testing.assert_allclose(seen[step].detach().numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)


def test_continuous_rollout_grad_reaches_the_policy_through_the_states_only():
    """The reparameterized actions flow through the world model, whose
    parameters ``_predict`` detaches: the policy's grad from the last
    step's state is nonzero, and the world model collects none."""
    s = Setup(discrete=False)
    _, tobs = starts(s, 4, 9)
    net = timag.GaussianPolicyMLP(12, HIDDEN, 2, generator=torch.Generator().manual_seed(0))
    roll = timag.make_imagination_rollout(s.twm, s.tenv, s.tspec, PLAN, horizon=3)
    states, *_ = roll(net, tobs, torch.Generator().manual_seed(1))
    states[-1].sum().backward()
    assert sum(float(p.grad.abs().sum()) for p in net.parameters() if p.grad is not None) > 0
    assert all(p.grad is None for p in s.twm.model.parameters())


def test_predict_and_differentiable_predict_agree_after_the_model_trains():
    """``WorldModel`` reads the model it was given: after that model takes
    Adam steps, ``predict`` and ``_predict`` still give the same answer,
    the new one, and a backward through ``_predict`` leaves the model's
    training grads as they were."""
    s = Setup()
    _, tobs = starts(s, 5, 15)
    acts = tuple(torch.zeros(o.shape[:2], dtype=torch.int32) for o in tobs)
    batch = GroupedBatch(obs=tobs, actions=acts)
    before = s.twm.predict(batch, None)
    model = s.twm.model
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    for _ in range(2):
        opt.zero_grad(set_to_none=True)
        sum(x.square().mean() for x in model.mean_call(batch)).backward()
        opt.step()
    grads = [p.grad.clone() for p in model.parameters()]
    served = s.twm.predict(batch, None)
    obs = tuple(o.clone().requires_grad_(True) for o in tobs)
    imagined = s.twm._predict(GroupedBatch(obs=obs, actions=acts))
    for got, want, old in zip(imagined, served, before):
        torch.testing.assert_close(got.detach(), want, rtol=0, atol=0)
        assert not torch.equal(want, old)
    imagined[0].sum().backward()
    assert all(o.grad is not None and float(o.grad.abs().sum()) > 0 for o in obs)
    assert all(torch.equal(p.grad, g) for p, g in zip(model.parameters(), grads))


# ----------------------------------------------------------------- trainers
def _updated(s, jtrainer, ttrainer, discrete, seed):
    """One update of both trainers from JAX's init (bridged) and JAX's
    draws; returns (JAX params, JAX opt state, JAX metrics, port params,
    port metrics)."""
    *_, jinit, jupdate = jtrainer
    tinit, tupdate = ttrainer
    jobs, tobs = starts(s, S, seed)
    jparams, jopt = jinit(jax.random.PRNGKey(seed), jobs[0][0, 0])
    tparams, topt = tinit(torch.Generator().manual_seed(seed))
    if isinstance(tparams, dict):
        for name, module in tparams.items():
            module.load_state_dict(bridge(jparams[name]))
    else:
        tparams.load_state_dict(bridge(jparams))
    key = jax.random.PRNGKey(100 + seed)
    jp, jo, jm = jupdate(jparams, jopt, jobs, key)
    tm = tupdate(tparams, topt, tobs, noise=jax_rollout_noise(s, key, H, S * N, discrete))
    return jp, jo, jm, tparams, tm


def _metrics_close(tm, jm):
    assert set(tm) == set(jm)
    for name, w in jm.items():
        np.testing.assert_allclose(float(tm[name]), float(w), rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("discrete", [True, False], ids=["discrete", "continuous"])
def test_reinforce_update_matches_jax(discrete):
    s = Setup(discrete=discrete)
    kw = dict(horizon=H, n_rollouts=N, hidden=HIDDEN, learning_rate=1e-3)
    jtr = jimag.make_imagination_trainer(s.jwm, s.jenv, s.jspec, PLAN, **kw)
    ttr = timag.make_imagination_trainer(s.twm, s.tenv, s.tspec, PLAN, **kw)
    jp, _, jm, tp, tm = _updated(s, jtr, ttr, discrete, seed=11)
    assert_state_close(tp, jp)
    _metrics_close(tm, jm)


AC_CASES = {
    "default": dict(),
    "target_ema": dict(target_ema=0.1),
    "critic_symlog": dict(critic_symlog=True),
    "finite_lam1": dict(bootstrap_tail=False, lam=1.0, gamma=1.0),
    "time_feature": dict(critic_time_feature=True, bootstrap_tail=False, lam=1.0),
    "centralized": dict(centralized=True),
}


@pytest.mark.parametrize("case", sorted(AC_CASES))
def test_actor_critic_update_matches_jax(case):
    s = Setup()
    kw = dict(horizon=H, n_rollouts=N, hidden=HIDDEN, learning_rate=1e-3, **AC_CASES[case])
    jtr = jimag.make_actor_critic_trainer(s.jwm, s.jenv, s.jspec, PLAN, **kw)
    ttr = timag.make_actor_critic_trainer(s.twm, s.tenv, s.tspec, PLAN, **kw)
    jp, _, jm, tp, tm = _updated(s, jtr, ttr, True, seed=12)
    assert set(tp) == set(jp)
    for name in jp:
        assert_state_close(tp[name], jp[name])
    _metrics_close(tm, jm)
    if "target_ema" in kw:
        # the target critic moved by the EMA only, outside the optimizer
        assert not any(p.requires_grad for p in tp["v_target"].parameters())


def test_actor_critic_warns_on_finite_horizon_with_lam_below_one():
    s = Setup()
    with pytest.warns(UserWarning, match="lam=1"):
        timag.make_actor_critic_trainer(s.twm, s.tenv, s.tspec, PLAN, bootstrap_tail=False, lam=0.9)


def test_continuous_actor_critic_grads_and_update_match_jax():
    """The critic's inputs depend on the reparameterized actions through
    the imagined states: the grads before the Adam step match JAX's."""
    s = Setup(discrete=False)
    kw = dict(horizon=H, n_rollouts=N, hidden=HIDDEN, learning_rate=1e-3)
    jtr = jimag.make_actor_critic_trainer(s.jwm, s.jenv, s.jspec, PLAN, **kw)
    ttr = timag.make_actor_critic_trainer(s.twm, s.tenv, s.tspec, PLAN, **kw)
    jp, jo, jm, tp, tm = _updated(s, jtr, ttr, False, seed=13)
    jgrads = jax.tree.map(lambda m: m / (1.0 - 0.9), jo[0].mu)  # optax adam: mu = (1 - b1) g after one step
    for name in ("pi", "v"):
        assert_state_close(tp[name], jp[name])
        want = bridge(jgrads[name])
        for pname, p in tp[name].named_parameters():
            w = want[pname].numpy()
            np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                       err_msg=f"{name}.{pname}")
    # JAX's grads include the critic loss's path through the imagined
    # states into the policy; they matched above, and are not all zero
    assert float(tp["pi"].dense[0].kernel.grad.abs().sum()) > 0
    assert all(p.grad is None for p in s.twm.model.parameters())
    _metrics_close(tm, jm)


# ------------------------------------------------------------------ serving
ACTOR_CASES = {
    "discrete greedy": (True, True, False),
    "discrete sampled": (True, False, False),
    "continuous greedy": (False, True, False),
    "continuous sampled": (False, False, False),
    "centralized sampled": (True, False, True),
}


@pytest.mark.parametrize("case", sorted(ACTOR_CASES))
def test_policy_actor_matches_jax(case):
    discrete, greedy, centralized = ACTOR_CASES[case]
    s = Setup(discrete=discrete)
    k = s.tspec.act_dims[0]
    od = 12 + (34 if centralized else 0)  # own row + Σobs
    jnet = jimag.PolicyMLP(hidden=HIDDEN, act_dim=k) if discrete else jimag.GaussianPolicyMLP(hidden=HIDDEN, act_dim=k)
    jparams = jnet.init(jax.random.PRNGKey(14), jnp.zeros((1, 1, od)))
    tnet = (timag.PolicyMLP if discrete else timag.GaussianPolicyMLP)(od, HIDDEN, k)
    tnet.load_state_dict(bridge(jparams))
    jact = jimag.make_policy_actor(jnet, jparams, s.jenv, s.jspec, PLAN, greedy=greedy, centralized=centralized)
    tact = timag.make_policy_actor(tnet, s.tenv, s.tspec, PLAN, greedy=greedy, centralized=centralized)
    for seed in range(3):
        jobs, _, tobs, _ = s.start(20 + seed)
        key = jax.random.PRNGKey(30 + seed)
        k_p, k_o = jax.random.split(key)
        draw = jax.random.gumbel if discrete else jax.random.normal
        noise = ActorNoise(t(draw(k_p, (P, k))), t(s.jsample(k_o)))
        want, got = np.asarray(jact(jobs, key)), tact(tobs, noise=noise).numpy()
        if discrete:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_policy_actor_batched_equals_single_calls():
    s = Setup()
    net = timag.PolicyMLP(12, HIDDEN, 5, generator=torch.Generator().manual_seed(0))
    act = timag.make_policy_actor(net, s.tenv, s.tspec, PLAN, greedy=False)
    _, _, tobs, tstate = s.start(40, n_envs=3)
    noise = act.draw_noise(torch.Generator().manual_seed(1), (3,))
    batched = act(tobs, noise=noise)
    singles = [act(type(tobs)(*(o[e] for o in tobs)), noise=ActorNoise(noise.policy[e], noise.others[e]))
               for e in range(3)]
    assert tuple(batched.shape) == (3, 3)
    torch.testing.assert_close(batched, torch.stack(singles), rtol=0, atol=0)
