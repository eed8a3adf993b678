"""The ``vdn:`` collect policy (``mfvae_tpu_torch/baselines/collect_policy.py``)
against ``mfvae_tpu/baselines/collect_policy.py``.

The policy file is the JAX package's ``.npz`` in both packages, read and
written with numpy alone:

- a policy JAX's ``save_policy`` wrote, loaded by the port, acts greedily
  as JAX's ``QCollectPolicy`` does over 8 steps of a JAX rollout with the
  hidden state carried (shared and independent params): actions equal,
  hidden states at rtol 1e-6 / atol 1e-6 (the Q-networks' forward
  tolerance, tests/test_torch_qlearning.py);
- a file the port wrote loads in JAX's ``load_policy`` and gives the same
  Q-values (rtol 1e-6 / atol 1e-6);
- epsilon 1 is the sampler's draw, a wrong population raises JAX's
  ``ValueError``, an [E]-batched step equals E single ones;
- a tiny experiment trains under ``vdn:`` with one env, with
  ``n_envs=2`` and with an independent-params policy, and ``vdn.main``'s
  ``save_policy_path`` writes a policy the experiment loads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfvae_tpu.baselines import collect_policy as jcp
from mfvae_tpu.baselines.vdn import VdnNetwork as JVdnNetwork
from mfvae_tpu.training.experiment import Experiment as JExperiment
from mfvae_tpu.training.trainer import make_action_sampler as j_make_action_sampler
from mfvae_tpu_torch.baselines import collect_policy as cp
from mfvae_tpu_torch.baselines import vdn
from mfvae_tpu_torch.models.mavae import AgentSpec
from mfvae_tpu_torch.training.experiment import Experiment, build_spec
from mfvae_tpu_torch.training.trainer import make_action_sampler
from tests.test_torch_batched import tiny_cfg
from tests.test_torch_experiment import one_torch_thread  # noqa: F401
from tests.test_training import tiny_cfg as j_tiny_cfg


def t(x):
    return torch.from_numpy(np.array(x))


def jax_policy_file(path, hidden_dim=8, param_share=True, seed=3):
    """A VdnNetwork for the tiny population, saved by the JAX package."""
    exp = JExperiment(j_tiny_cfg())
    n = exp.spec.n_agents
    d_pad = max(od for (od, _), _ in exp.spec.groups)
    net = JVdnNetwork(action_dim=5, n_agents=n, hidden_dim=hidden_dim, param_share=param_share)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, n, hidden_dim)), jnp.zeros((1, 1, n, d_pad + n)),
                      jnp.zeros((1, 1), bool))
    jcp.save_policy(str(path), params, hidden_dim=hidden_dim, param_share=param_share, action_dim=5, n_agents=n)
    return str(path), exp


def port_env(cfg=None):
    exp = Experiment(cfg or tiny_cfg(None), device="cpu")
    return exp.env, exp.spec


@pytest.mark.parametrize("share", [True, False], ids=["shared", "independent"])
def test_a_jax_saved_policy_acts_as_jaxs_over_8_steps(tmp_path, share):
    path, jexp = jax_policy_file(tmp_path / "p.npz", param_share=share)
    jpol = jcp.load_collect_policy(path, jexp.env, jexp.spec, 0.0, j_make_action_sampler(jexp.env, jexp.spec)[0])
    env, spec = port_env()
    pol = cp.load_collect_policy(path, env, spec, 0.0, make_action_sampler(env, spec)[0])
    obs, state = jexp.env.reset_stacked(jax.random.PRNGKey(0))
    jc, tc = jpol.init_carry(), pol.init_carry()
    g = torch.Generator().manual_seed(0)
    for step in range(8):
        jc, ja = jpol.step(jc, obs, state, jax.random.PRNGKey(step))
        tc, ta = pol.step(tc, tuple(t(o) for o in obs), None, g)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja), err_msg=f"step {step}")
        np.testing.assert_allclose(tc[0].numpy(), np.asarray(jc)[0], rtol=1e-6, atol=1e-6)
        obs, state, *_ = jexp.env.step_stacked(jax.random.PRNGKey(99), state, ja)


def test_a_port_saved_policy_loads_in_jax(tmp_path):
    env, spec = port_env()
    n = spec.n_agents
    d = max(spec.obs_dims) + n
    for share in (True, False):
        net = vdn.VdnNetwork(5, n, 8, share, in_dim=d, generator=torch.Generator().manual_seed(int(share)))
        path = str(tmp_path / f"port_{share}.npz")
        cp.save_policy(path, net, hidden_dim=8, param_share=share, action_dim=5, n_agents=n)
        params, meta = jcp.load_policy(path)
        assert meta == {"hidden_dim": 8, "param_share": share, "action_dim": 5, "n_agents": n}
        x = np.random.default_rng(0).normal(size=(3, 2, n, d)).astype(np.float32)
        h = np.random.default_rng(1).normal(size=(2, n, 8)).astype(np.float32)
        done = np.array([[False, False], [True, False], [False, False]])
        jh, jq = JVdnNetwork(action_dim=5, n_agents=n, hidden_dim=8, param_share=share).apply(
            params, jnp.asarray(h), jnp.asarray(x), jnp.asarray(done))
        with torch.no_grad():
            th, tq = net(t(h), t(x), t(done))
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6, atol=1e-6)
        # the port reads its own file back to the same weights
        back, _ = cp.load_policy(path)
        pol = cp.QCollectPolicy(env, spec, back, meta, 0.0, make_action_sampler(env, spec)[0])
        for (name, p), q in zip(net.state_dict().items(), pol.network.state_dict().values()):
            assert torch.equal(p, q), name


def test_epsilon_one_is_the_samplers_draw(tmp_path):
    path, _ = jax_policy_file(tmp_path / "p.npz")
    env, spec = port_env()
    sample_fn = make_action_sampler(env, spec)[0]
    pol = cp.load_collect_policy(path, env, spec, 1.0, sample_fn)
    obs, state = env.reset_stacked(torch.Generator().manual_seed(1))
    _, actions = pol.step(pol.init_carry(), obs, state, torch.Generator().manual_seed(5))
    assert torch.equal(actions, sample_fn(torch.Generator().manual_seed(5)))


def test_a_wrong_population_is_refused(tmp_path):
    path, _ = jax_policy_file(tmp_path / "p.npz")
    env, spec = port_env()
    params, meta = cp.load_policy(path)
    meta["n_agents"] += 1
    with pytest.raises(ValueError, match="agents"):
        cp.QCollectPolicy(env, spec, params, meta, 0.0, make_action_sampler(env, spec)[0])


def test_a_batched_step_equals_single_steps(tmp_path):
    path, _ = jax_policy_file(tmp_path / "p.npz")
    env, spec = port_env()
    pol = cp.load_collect_policy(path, env, spec, 0.3, make_action_sampler(env, spec)[0])
    obs, state = env.reset_stacked(torch.Generator().manual_seed(2), batch_shape=(3,))
    carry = (torch.randn(3, spec.n_agents, 8, generator=torch.Generator().manual_seed(4)),)
    noise = pol.draw_noise(torch.Generator().manual_seed(6), (3,))
    (h,), acts = pol.step(carry, obs, state, None, noise)
    for e in range(3):
        (he,), ae = pol.step((carry[0][e],), tuple(o[e] for o in obs), None, None,
                             cp.QNoise(noise.rand[e], noise.mix[e]))
        assert torch.equal(ae, acts[e])
        torch.testing.assert_close(he, h[e], rtol=1e-6, atol=1e-7)


def test_the_policy_packs_as_pack_obs_in_agent_order():
    """The class-tensor packing equals ``vdn._pack_obs`` of the agent
    dict, also where a group's agents are not contiguous (agent order
    a0, g0, a1; groups (a0, a1), (g0,))."""
    agents = ("a0", "g0", "a1")
    dims = {"a0": 4, "g0": 3, "a1": 4}
    spec = AgentSpec.from_dicts(agents, dims, {a: 5 for a in agents})
    assert not spec.grouped_is_identity
    pol = cp.QCollectPolicy.__new__(cp.QCollectPolicy)  # packing only: no network
    pol.spec, pol._d_pad, pol._eye = spec, 4, torch.eye(3)
    obs = (torch.randn(2, 2, 4), torch.randn(2, 1, 3))

    class Env:
        pass

    Env.agents, Env.obs_dim = agents, staticmethod(dims.get)
    named = {"a0": obs[0][:, 0], "a1": obs[0][:, 1], "g0": obs[1][:, 0]}
    assert torch.equal(pol._pack(obs), vdn._pack_obs(Env, named, 3))


@pytest.mark.parametrize("case", ["one env", "n_envs=2", "independent"])
def test_an_experiment_trains_under_vdn_collection(tmp_path, case):
    path, _ = jax_policy_file(tmp_path / "p.npz", param_share=case != "independent")
    cfg = tiny_cfg(tmp_path, collect_policy=f"vdn:{path}", collect_epsilon=0.25,
                   n_envs=2 if case == "n_envs=2" else 1)
    exp = Experiment(cfg, device="cpu").setup()
    out = exp.run()
    assert np.isfinite(out["loss_train"]) and np.isfinite(out["loss_test"])
    (hidden,) = exp.carry.env.policy
    assert tuple(hidden.shape) == ((2,) if case == "n_envs=2" else ()) + (exp.spec.n_agents, 8)


def test_vdn_main_saves_a_loadable_policy(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "p.npz")
    vdn.main(None, device="cpu", num_good_agents=1, num_adversaries=2, num_obs=1, num_updates=2, num_envs=2,
             buffer_size_time=64, min_buffer_time=16, batch_size=2, hidden_dim=8, log_during_training=False,
             test_during_training=False, save_policy_path=path)
    env, spec = port_env()
    pol = cp.load_collect_policy(path, env, spec, 0.0, make_action_sampler(env, spec)[0])
    obs, state = env.reset_stacked(torch.Generator().manual_seed(0))
    _, actions = pol.step(pol.init_carry(), obs, state, torch.Generator().manual_seed(1))
    assert actions.shape == (spec.n_agents,)
    # and the JAX package reads it
    _, meta = jcp.load_policy(path)
    assert meta["n_agents"] == spec.n_agents == build_spec(env).n_agents


def test_the_host_collectors_policy_waits_for_the_host_path(tmp_path):
    """Once refused as unported, ``HostQCollectPolicy`` now serves the
    JAX-saved file to the host collectors: greedy actions over K envs
    from the named obs, and a wrong population refused as in JAX
    (tests/test_torch_host.py holds its actions against JAX's)."""
    path, exp = jax_policy_file(tmp_path / "p.npz")
    dims = {a: exp.spec.obs_dims[i] for i, a in enumerate(exp.spec.agents)}
    pol = cp.HostQCollectPolicy(path, exp.spec.agents, dims, 0.0, np.random.default_rng(0), n_envs=2)
    obs = {a: np.zeros((2, d), np.float32) for a, d in dims.items()}
    acts = pol.actions(obs)
    assert acts.shape == (2, exp.spec.n_agents) and acts.dtype == np.int32
    with pytest.raises(ValueError, match="agents"):
        cp.HostQCollectPolicy(path, exp.spec.agents[:1], dims, 0.0, np.random.default_rng(0))
