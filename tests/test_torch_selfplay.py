"""Self-play in imagination (``mfvae_tpu_torch/imagination.py``:
``make_selfplay_rollout``, ``make_selfplay_trainer``, ``make_team_actor``)
against ``mfvae_tpu/imagination.py``.

On the tiny simple_tag world model of tests/test_torch_planning.py (2
adversaries = team A, 1 good agent = team B; the JAX ``init`` bridged) and
both teams' policy networks bridged from JAX's, the port takes JAX's own
Gumbel draws, replayed from the keys its rollout splits (per step k_a,
k_b; ``jax.random.categorical`` is argmax(logits + Gumbel)):

- the rollout: actions equal (through the states they lead to), logp and
  entropy rtol 1e-6 / atol 1e-6, states and rewards rtol 1e-5 / atol 1e-6
  (each step feeds the model's mean back in);
- one update of each team, the other frozen: params after the Adam step
  at rtol 1e-5 / atol 1e-7, the frozen team's params untouched with no
  ``.grad``;
- ``make_team_actor``: greedy actions equal, sampled ones equal under
  JAX's draws.

The three stub tests of tests/test_selfplay.py run on torch stubs of its
world models: gradient isolation, independent payoffs that both teams
learn, and the best-response cycle of the interactive payoff.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mfvae_tpu import imagination as jimag
from mfvae_tpu_torch import imagination as timag
from mfvae_tpu_torch.imagination import SelfplayNoise
from mfvae_tpu_torch.models.convert import policy_params_from_jax
from mfvae_tpu_torch.models.mavae import AgentSpec, agent_order_concat, state_to_grouped
from tests.test_torch_experiment import one_torch_thread  # noqa: F401
from tests.test_torch_planning import Setup, t

H, S, N = 3, 2, 2  # horizon, starts, rollouts per start
HIDDEN = (16,)


@pytest.fixture(scope="module")
def setup():
    return Setup()


def policies(s, seed=1):
    """Both teams' JAX policy params and the port's modules holding them."""
    (od_a, _), _ = s.jspec.groups[0]
    (od_b, _), _ = s.jspec.groups[1]
    k_a, k_b = jax.random.split(jax.random.PRNGKey(seed))
    out = []
    for k, od in ((k_a, od_a), (k_b, od_b)):
        params = jax.device_get(jimag.PolicyMLP(hidden=HIDDEN, act_dim=5).init(k, jnp.zeros((1, 1, od))))
        mod = timag.PolicyMLP(od, HIDDEN, 5)
        mod.load_state_dict(policy_params_from_jax(params))
        out.append((params, mod))
    return out


def starts(s, n, seed):
    rng = np.random.default_rng(seed)
    obs = [rng.normal(size=(n, len(idxs), od)).astype(np.float32) for (od, _), idxs in s.jspec.groups]
    return tuple(map(jnp.asarray, obs)), tuple(map(torch.from_numpy, obs))


def jax_noise(s, key, b):
    """JAX's rollout draws for ``key``: per step k_t -> (k_a, k_b)."""
    a, bb = [], []
    for k_t in jax.random.split(key, H):
        k_a, k_b = jax.random.split(k_t)
        a.append(jax.random.gumbel(k_a, (b, len(s.jspec.groups[0][1]), 5)))
        bb.append(jax.random.gumbel(k_b, (b, len(s.jspec.groups[1][1]), 5)))
    return SelfplayNoise(t(np.stack(a)), t(np.stack(bb)))


def test_rollout_matches_jax_under_its_draws(setup):
    s = setup
    (pa, ma), (pb, mb) = policies(s)
    jobs, tobs = starts(s, 4, 0)
    key = jax.random.PRNGKey(5)
    jroll = jimag.make_selfplay_rollout(s.jwm, s.jenv, s.jspec, horizon=H)
    want = jroll(pa, jimag.PolicyMLP(hidden=HIDDEN, act_dim=5).apply, pb,
                 jimag.PolicyMLP(hidden=HIDDEN, act_dim=5).apply, jobs, key)
    roll = timag.make_selfplay_rollout(s.twm, s.tenv, s.tspec, horizon=H)
    with torch.no_grad():
        got = roll(ma, mb, tobs, noise=jax_noise(s, key, 4))
    (ws, wr, (wla, wea), (wlb, web)), (gs, gr, (gla, gea), (glb, geb)) = want, got
    assert tuple(gs.shape) == (H, 4, sum(s.tspec.obs_dims)) and tuple(gla.shape) == (H, 4, 2)
    for g, w in ((gla, wla), (gea, wea), (glb, wlb), (geb, web)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    for g, w in ((gs, ws), (gr, wr)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("team", ["a", "b"])
def test_one_update_of_each_team_matches_jax(setup, team):
    s = setup
    (pa, ma), (pb, mb) = policies(s)

    def score_a(states, rewards):
        return rewards[..., :2].sum(0)

    def score_b(states, rewards):
        return rewards[..., 2:].sum(0)

    _, _, _, jup_a, jup_b = jimag.make_selfplay_trainer(
        s.jwm, s.jenv, s.jspec, score_a, score_b, horizon=H, n_rollouts=N, learning_rate=1e-3, hidden=HIDDEN)
    pols_a, pols_b, init, up_a, up_b = timag.make_selfplay_trainer(
        s.twm, s.tenv, s.tspec, score_a, score_b, horizon=H, n_rollouts=N, learning_rate=1e-3, hidden=HIDDEN)
    jobs, tobs = starts(s, S, 1)
    (ta, opt_a), (tb, opt_b) = init(torch.Generator().manual_seed(0), tobs[0][0, 0], tobs[1][0, 0])
    assert ta is pols_a and tb is pols_b
    ta.load_state_dict(ma.state_dict())
    tb.load_state_dict(mb.state_dict())
    key = jax.random.PRNGKey(7)
    noise = jax_noise(s, key, S * N)
    if team == "a":
        want, _, _ = jup_a(pa, optax.adam(1e-3).init(pa), pb, jobs, key)
        trained, _, _ = up_a(ta, opt_a, tb, tobs, noise=noise)
        other, frozen_before = tb, mb.state_dict()
    else:
        want, _, _ = jup_b(pb, optax.adam(1e-3).init(pb), pa, jobs, key)
        trained, _, _ = up_b(tb, opt_b, ta, tobs, noise=noise)
        other, frozen_before = ta, ma.state_dict()
    for name, w in policy_params_from_jax(jax.device_get(want)).items():
        np.testing.assert_allclose(trained.state_dict()[name].numpy(), w.numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    for name, p in other.named_parameters():
        assert p.grad is None and torch.equal(p.detach(), frozen_before[name]), name
    assert all(p.grad is None for p in trained.parameters())  # cleared after the step


def test_team_actor_matches_jax(setup):
    s = setup
    (pa, ma), (pb, mb) = policies(s)
    jobs, _ = s.jenv.reset_stacked(jax.random.PRNGKey(3))
    tobs = type(s.tenv.reset_stacked(torch.Generator().manual_seed(0))[0])(*(t(o) for o in jobs))
    for group, params, mod in ((0, pa, ma), (1, pb, mb)):
        pol = jimag.PolicyMLP(hidden=HIDDEN, act_dim=5)
        greedy = jimag.make_team_actor(pol, params, s.jspec, group, greedy=True)(jobs, jax.random.PRNGKey(0))
        got = timag.make_team_actor(mod, s.tspec, group, greedy=True)(tobs)
        np.testing.assert_array_equal(got.numpy(), np.asarray(greedy))
        for seed in range(3):
            key = jax.random.PRNGKey(seed)
            want = jimag.make_team_actor(pol, params, s.jspec, group)(jobs, key)
            noise = t(jax.random.gumbel(key, (len(s.jspec.groups[group][1]), 5)))
            got = timag.make_team_actor(mod, s.tspec, group)(tobs, noise=noise)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    batched = timag.make_team_actor(ma, s.tspec, 0)(type(tobs)(*(o.expand(4, *o.shape) for o in tobs)),
                                                    torch.Generator().manual_seed(1))
    assert tuple(batched.shape) == (4, 2)


def test_the_guards_keep_jaxs_messages(setup):
    s = setup
    three = AgentSpec.from_dicts(("a", "b", "c"), {"a": 2, "b": 3, "c": 4}, {"a": 5, "b": 5, "c": 5})
    with pytest.raises(AssertionError, match="exactly two agent groups"):
        timag.make_selfplay_rollout(s.twm, s.tenv, three)

    class Continuous:
        discrete_actions = False
        device = torch.device("cpu")

    with pytest.raises(AssertionError, match="discrete-actions only"):
        timag.make_selfplay_rollout(s.twm, Continuous(), s.tspec)


# ------------------------------------------------------------------ stubs
class StubEnv:
    discrete_actions = True
    device = torch.device("cpu")


def two_team_spec():
    agents = ("adversary_0", "adversary_1", "adversary_2", "agent_0")
    return AgentSpec.from_dicts(agents, {a: 6 for a in agents[:3]} | {"agent_0": 4}, {a: 5 for a in agents})


class StubWM:
    """tests/test_selfplay.py's frozen-state world models: independent
    payoffs (adversaries paid for action 3, the prey for 1) or the
    interactive one (adversary i paid for matching the prey's action; the
    prey per mismatch, plus 0.5 for action 1)."""

    def __init__(self, spec, interactive=False):
        self.spec, self.interactive = spec, interactive

    def _predict(self, batch):
        acts_a, acts_b = batch.actions  # [B, 3], [B, 1]
        if self.interactive:
            match = (acts_a == acts_b).to(torch.float32)
            rew_b = torch.sum(1.0 - match, dim=1, keepdim=True) + 0.5 * (acts_b == 1).to(torch.float32)
            rew = torch.cat([match, rew_b], dim=1)
        else:
            rew = torch.cat([(acts_a == 3).to(torch.float32), (acts_b == 1).to(torch.float32)], dim=1)
        return agent_order_concat(self.spec, batch.obs), rew

    def _state_to_grouped(self, state):
        return state_to_grouped(self.spec, state)


def stub_starts(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, 3, 6, generator=g), torch.randn(n, 1, 4, generator=g)


def score_a(states, rewards):
    return torch.sum(rewards[..., :3], dim=0)


def score_b(states, rewards):
    return torch.sum(rewards[..., 3:], dim=0)


def stub_trainer(wm):
    spec = wm.spec
    return timag.make_selfplay_trainer(wm, StubEnv(), spec, score_a, score_b, horizon=4, n_rollouts=8,
                                       learning_rate=3e-3, hidden=(32,))


def test_stub_shapes_and_gradient_isolation():
    spec = two_team_spec()
    wm = StubWM(spec)
    pa, pb, init_fn, up_a, _ = timag.make_selfplay_trainer(wm, StubEnv(), spec, score_a, score_b, horizon=4,
                                                            n_rollouts=2)
    obs = stub_starts(6)
    (ma, opt_a), (mb, _) = init_fn(torch.Generator().manual_seed(1), obs[0][0, 0], obs[1][0, 0])
    roll = timag.make_selfplay_rollout(wm, StubEnv(), spec, horizon=4)
    states, rewards, (lp_a, _), (lp_b, _) = roll(ma, mb, obs, torch.Generator().manual_seed(2))
    assert tuple(states.shape) == (4, 6, 3 * 6 + 4) and tuple(rewards.shape) == (4, 6, 4)
    assert tuple(lp_a.shape) == (4, 6, 3) and tuple(lp_b.shape) == (4, 6, 1)
    # team B's log-probs carry no gradient to team A's params
    grads = torch.autograd.grad(lp_b.sum(), list(ma.parameters()), allow_unused=True)
    assert all(g is None or float(g.abs().max()) == 0.0 for g in grads)
    # an update of A leaves B as it was, with no grad
    before = {k: v.clone() for k, v in mb.state_dict().items()}
    up_a(ma, opt_a, mb, obs, torch.Generator().manual_seed(3))
    assert all(p.grad is None for p in mb.parameters())
    assert all(torch.equal(v, before[k]) for k, v in mb.state_dict().items())


def _alternate(upd_a, upd_b, ma, opt_a, mb, opt_b, obs, g, rounds, updates_each):
    hist = {"a": [], "b": []}
    for _ in range(rounds):
        for _ in range(updates_each):
            _, _, m = upd_a(ma, opt_a, mb, obs, g)
        hist["a"].append(float(m["score_mean"]))
        for _ in range(updates_each):
            _, _, m = upd_b(mb, opt_b, ma, obs, g)
        hist["b"].append(float(m["score_mean"]))
    return hist


def test_stub_independent_payoffs_both_converge():
    wm = StubWM(two_team_spec())
    _, _, init_fn, upd_a, upd_b = stub_trainer(wm)
    obs = stub_starts(16)
    (ma, opt_a), (mb, opt_b) = init_fn(torch.Generator().manual_seed(1))
    hist = _alternate(upd_a, upd_b, ma, opt_a, mb, opt_b, obs, torch.Generator().manual_seed(3), 2, 60)
    # adversaries learn action 3, the prey action 1: score ~4 (H = 4 steps x reward 1)
    assert hist["a"][-1] > 3.0 and hist["b"][-1] > 3.0, hist
    with torch.no_grad():
        assert int(torch.bincount(torch.argmax(ma(obs[0]), -1).ravel(), minlength=5).argmax()) == 3
        assert int(torch.bincount(torch.argmax(mb(obs[1]), -1).ravel(), minlength=5).argmax()) == 1


def test_stub_interactive_payoff_best_response_cycle():
    """The prey settles on its preferred action, the adversaries learn to
    MATCH it (far above the chance 0.8 per agent), and the retrained prey
    escapes: the frozen adversaries' match score collapses."""
    wm = StubWM(two_team_spec(), interactive=True)
    _, _, init_fn, upd_a, upd_b = stub_trainer(wm)
    obs = stub_starts(16)
    (ma, opt_a), (mb, opt_b) = init_fn(torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(3)
    roll = timag.make_selfplay_rollout(wm, StubEnv(), wm.spec, horizon=4)

    def train(update, mine, opt, other, n):
        for _ in range(n):
            update(mine, opt, other, obs, g)

    def a_match_score():
        with torch.no_grad():
            _, rewards, _, _ = roll(ma, mb, tuple(o.repeat_interleave(8, dim=0) for o in obs),
                                    torch.Generator().manual_seed(9))
        return float(torch.mean(score_a(None, rewards)))

    train(upd_b, mb, opt_b, ma, 60)
    train(upd_a, ma, opt_a, mb, 80)
    a1 = a_match_score()
    assert a1 > 2.0, a1
    train(upd_b, mb, opt_b, ma, 80)
    a2 = a_match_score()
    assert a2 < 0.6 * a1, (a1, a2)
