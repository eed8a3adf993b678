"""The port's Q-learning modules (``mfvae_tpu_torch/models/qlearning.py``,
``baselines/vdn.py``'s ``VdnNetwork``, ``_pack_obs`` and
``td_lambda_targets``, ``baselines/qmix.py``'s ``MixingNetwork``) against
the JAX package's.

Both packages run on the same numpy inputs with the JAX ``init`` bridged
by ``qnet_params_from_jax`` / ``mixer_params_from_jax``.  The port cannot
replay threefry, so ``eps_greedy`` takes JAX's own draws, replayed from the
key it splits (``k_bern`` uniform, ``k_rand`` randint).

Tolerances (float32 both, JAX matmul precision "highest"): forwards rtol
1e-6 / atol 1e-6 (XLA contracts multiply-adds into FMAs and sums matmuls
in another order: an ulp of the largest terms, not of a result near 0);
``td_lambda_targets`` the same; the packing, the schedule and the actions
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfvae_tpu.baselines.qmix import MixingNetwork as JMixer
from mfvae_tpu.baselines.vdn import VdnNetwork as JVdnNetwork
from mfvae_tpu.baselines.vdn import _pack_obs as j_pack_obs
from mfvae_tpu.baselines.vdn import td_lambda_targets as j_td_lambda_targets
from mfvae_tpu.envs.mpe import make as j_make
from mfvae_tpu.models.qlearning import ScannedGRU as JScannedGRU
from mfvae_tpu.models.qlearning import eps_greedy as j_eps_greedy
from mfvae_tpu.models.qlearning import epsilon_by_step as j_epsilon_by_step
from mfvae_tpu_torch.baselines.qmix import MixingNetwork
from mfvae_tpu_torch.baselines.vdn import VdnNetwork, _pack_obs, td_lambda_targets
from mfvae_tpu_torch.envs.mpe import make
from mfvae_tpu_torch.models.convert import (
    flatten_flax,
    mixer_params_from_jax,
    mixer_params_to_jax,
    qnet_params_from_jax,
    qnet_params_to_jax,
)
from mfvae_tpu_torch.models.qlearning import EpsNoise, ScannedGRU, eps_greedy, epsilon_by_step
from tests.test_torch_experiment import one_torch_thread  # noqa: F401

T, B, N, D, H, A = 5, 2, 3, 7, 8, 5


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def jax_vdn(share, seed=0):
    net = JVdnNetwork(action_dim=A, n_agents=N, hidden_dim=H, param_share=share)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((B, N, H)), jnp.zeros((1, B, N, D)), jnp.zeros((1, B), bool))
    port = VdnNetwork(A, N, H, share, in_dim=D)
    port.load_state_dict(qnet_params_from_jax(jax.device_get(params)))
    return net, params, port


def inputs(seed=1):
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(T, B, N, D)).astype(np.float32)
    hidden = rng.normal(size=(B, N, H)).astype(np.float32)
    done = np.zeros((T, B), bool)
    done[2, 0] = done[3, 1] = True  # episodes ending mid-sequence, per row
    return obs, hidden, done


# ------------------------------------------------------------------ the GRU
def test_scanned_gru_resets_on_done_as_jax():
    """tests/test_vdn.py::test_scanned_gru_resets_on_done on both packages:
    done[t] zeroes the carry BEFORE step t, so step 2 repeats step 0."""
    gru = JScannedGRU(hidden_dim=4)
    x = jnp.ones((T, B, 3))
    done = jnp.zeros((T, B), bool).at[2, :].set(True)
    h0 = JScannedGRU.initialize_carry(B, 4)
    params = jax.device_get(gru.init(jax.random.PRNGKey(0), h0, (x, done)))
    _, want = gru.apply(params, h0, (x, done))
    port = ScannedGRU(3, 4)
    tree = params["params"]["GRUCell_0"]
    port.load_state_dict({f"cell.{g}.{leaf}": t(v) for g, d in tree.items() for leaf, v in d.items()})
    _, ys = port(ScannedGRU.initialize_carry(B, 4), (t(x), t(done)))
    close(ys, want)
    torch.testing.assert_close(ys[2], ys[0], rtol=1e-5, atol=0)
    assert not torch.allclose(ys[3], ys[0])


@pytest.mark.parametrize("share", [True, False], ids=["shared", "independent"])
def test_vdn_network_matches_jax(share):
    net, params, port = jax_vdn(share)
    obs, hidden, done = inputs()
    jh, jq = net.apply(params, jnp.asarray(hidden), jnp.asarray(obs), jnp.asarray(done))
    h, q = port(t(hidden), t(obs), t(done))
    assert tuple(q.shape) == (T, B, N, A) and tuple(h.shape) == (B, N, H)
    close(h, jh)
    close(q, jq)


@pytest.mark.parametrize("share", [True, False], ids=["shared", "independent"])
def test_flax_paths_bridge_both_ways(share):
    _, params, port = jax_vdn(share)
    root = "AgentRNN_0" if share else "VmapAgentRNN_0"
    flat = flatten_flax(jax.device_get(params))
    assert set(flat) == {f"params/{root}/{p}" for p in (
        "Dense_0/kernel", "Dense_0/bias", "Dense_1/kernel", "Dense_1/bias",
        *(f"ScannedGRU_0/GRUCell_0/{g}/{leaf}" for g in ("ir", "iz", "in") for leaf in ("kernel", "bias")),
        "ScannedGRU_0/GRUCell_0/hr/kernel", "ScannedGRU_0/GRUCell_0/hz/kernel",
        "ScannedGRU_0/GRUCell_0/hn/kernel", "ScannedGRU_0/GRUCell_0/hn/bias")}
    back = flatten_flax(qnet_params_to_jax(port.state_dict()))
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].shape[0] == N or share, k


@pytest.mark.parametrize("share", [True, False], ids=["shared", "independent"])
def test_fresh_network_has_flax_init(share):
    net = VdnNetwork(A, N, H, share, in_dim=D, generator=torch.Generator().manual_seed(0))
    for name, p in net.state_dict().items():
        if name.endswith("bias"):
            assert torch.all(p == 0), name
            continue
        k = p.reshape(-1, *p.shape[-2:])
        if name.split(".")[-2] in ("hr", "hz", "hn"):  # orthogonal, per agent
            eye = torch.eye(H).expand_as(k)
            torch.testing.assert_close(k.transpose(-1, -2) @ k, eye, atol=1e-5, rtol=0)
        else:  # lecun normal, truncated at 2 sigma of 1/sqrt(fan_in)
            assert 0 < k.abs().max() <= 2.0 / (0.87962566 * k.shape[-2] ** 0.5) + 1e-6, name
    if not share:
        assert all(p.shape[0] == N for p in net.parameters())
        assert not torch.equal(net.agent.dense0.kernel[0], net.agent.dense0.kernel[1])


# ---------------------------------------------------------------- the mixer
def jax_mixer(n, s_dim, m, h, seed=0):
    mixer = JMixer(n_agents=n, mixing_dim=m, hypernet_dim=h)
    params = jax.device_get(mixer.init(jax.random.PRNGKey(seed), jnp.zeros((1, n)), jnp.zeros((1, s_dim))))
    port = MixingNetwork(n, s_dim, m, h)
    port.load_state_dict(mixer_params_from_jax(params))
    return mixer, params, port


def test_mixing_network_matches_jax_and_bridges_back():
    mixer, params, port = jax_mixer(4, 20, 8, 16)
    rng = np.random.default_rng(0)
    state = rng.normal(size=(6, 5, 20)).astype(np.float32)
    qs = rng.normal(size=(6, 5, 4)).astype(np.float32)
    close(port(t(qs), t(state)), mixer.apply(params, jnp.asarray(qs), jnp.asarray(state)))
    back = flatten_flax(mixer_params_to_jax(port.state_dict()))
    assert back.keys() == flatten_flax(params).keys()
    assert {k.split("/")[1] for k in back} == {"hyper_w1_h", "hyper_w1", "hyper_b1", "hyper_w2_h", "hyper_w2",
                                               "hyper_b2_h", "hyper_b2_out"}


def test_mixing_network_is_monotonic_in_agent_qs():
    """tests/test_qmix.py: dQ_tot/dQ_a >= 0 for every agent."""
    _, _, port = jax_mixer(4, 20, 8, 16)
    rng = np.random.default_rng(0)
    state = t(rng.normal(size=(6, 20)).astype(np.float32))
    qs = t(rng.normal(size=(6, 4)).astype(np.float32)).requires_grad_(True)
    port(qs, state).sum().backward()
    assert float(qs.grad.min()) >= 0.0


def test_mixing_network_depends_on_the_state():
    _, _, port = jax_mixer(2, 10, 4, 8, seed=1)
    qs = torch.ones(1, 2)
    with torch.no_grad():
        assert float(port(qs, torch.zeros(1, 10))) != float(port(qs, torch.ones(1, 10)))


# ------------------------------------------------------------ TD(λ) targets
def hand_td_lambda(rew, done, qbar_next, gamma, lam):
    L = done.shape[0]
    g = np.empty((L,) + rew.shape[1:], np.float32)
    g[L - 1] = qbar_next[-1] * (1.0 - done[L - 1])
    for k in range(L - 2, -1, -1):
        g[k] = rew[k] + gamma * (1.0 - done[k]) * ((1.0 - lam) * qbar_next[k] + lam * g[k + 1])
    return g[: L - 1]


@pytest.mark.parametrize("lam", [0.0, 0.6, 1.0])
def test_td_lambda_targets_match_jax_and_the_hand_recursion(lam):
    rng = np.random.default_rng(7)
    L, S, gamma = 9, 5, 0.93
    rew = rng.normal(size=(L - 1, S)).astype(np.float32)
    qbar_next = rng.normal(size=(L - 1, S)).astype(np.float32)
    done = rng.random(size=(L, S)) < 0.25
    got = td_lambda_targets(t(rew), t(done), t(qbar_next), gamma, lam)
    close(got, j_td_lambda_targets(jnp.asarray(rew), jnp.asarray(done), jnp.asarray(qbar_next), gamma, lam))
    np.testing.assert_allclose(got.numpy(), hand_td_lambda(rew, done, qbar_next, gamma, lam), rtol=1e-5, atol=1e-6)
    if lam == 0.0:  # the one-step double-DQN target
        np.testing.assert_allclose(got.numpy(), rew + gamma * (1.0 - done[:-1]) * qbar_next, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------ exploration schedule
@pytest.mark.parametrize("decay", [100.0, 3.2, 0.4])
def test_epsilon_schedule_equals_jax(decay):
    for step in (0, 1, 2, 3, 50, 99, 100, 1000):
        want = float(j_epsilon_by_step(jnp.int32(step), 1.0, 0.05, decay))
        assert epsilon_by_step(step, 1.0, 0.05, decay) == want, step


@pytest.mark.parametrize("eps", [0.0, 0.3, 1.0])
def test_eps_greedy_equals_jax_under_its_draws(eps):
    q = np.random.default_rng(3).normal(size=(6, 4, 20)).astype(np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = j_eps_greedy(key, jnp.asarray(q), jnp.float32(eps))
        k_bern, k_rand = jax.random.split(key)
        noise = EpsNoise(t(jax.random.uniform(k_bern, q.shape[:-1])),
                         t(jax.random.randint(k_rand, q.shape[:-1], 0, q.shape[-1], dtype=jnp.int32)))
        got = eps_greedy(t(q), eps, noise=noise)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_eps_greedy_draws_from_its_generator():
    q = torch.tensor([[0.0, 10.0, 0.0]])
    assert int(eps_greedy(q, 0.0, torch.Generator().manual_seed(0))[0]) == 1
    acts = {int(eps_greedy(q, 1.0, torch.Generator().manual_seed(i))[0]) for i in range(30)}
    assert len(acts) > 1


# ------------------------------------------------------------------ packing
SCENARIOS = {
    "simple_tag": ("MPE_simple_tag_v3", dict(num_good_agents=2, num_adversaries=3, num_obs=2)),
    "simple_world_comm": ("MPE_simple_world_comm_v3", dict(num_good_agents=2, num_adversaries=3, num_obs=1)),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_pack_obs_equals_jax_exactly(scenario):
    name, pop = SCENARIOS[scenario]
    jenv, tenv = j_make(name, **pop), make(name, device="cpu", **pop)
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    obs_d, _ = jax.vmap(jenv.reset)(keys)
    want = np.asarray(j_pack_obs(jenv, obs_d, jenv.num_agents))
    stacked, _ = jax.vmap(jenv.reset_stacked)(keys)
    classes = tuple(t(c) for c in stacked)
    n = tenv.num_agents
    for got in (_pack_obs(tenv, classes, n), _pack_obs(tenv, {a: t(v) for a, v in obs_d.items()}, n),
                _pack_obs(tenv, classes, n, torch.eye(n))):
        np.testing.assert_array_equal(got.numpy(), want)
