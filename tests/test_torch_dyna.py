"""Dyna imagination (``mfvae_tpu_torch/baselines/dyna.py``) against
``mfvae_tpu/baselines/dyna.py``: the world model generates TD windows for
the Q-learner.

Both packages share tests/test_dyna.py's ``tiny_wm`` (simple_tag with 2
adversaries, 1 good agent, 1 obstacle; the JAX ``init`` bridged by
``params_from_jax``) and one Q-network (bridged by
``qnet_params_from_jax``); the port takes JAX's own exploration draws,
replayed from the keys its imagination splits.

Tolerances (float32 both): the windows' obs and rewards rtol 1e-5 / atol
1e-6 (each step feeds the model's posterior mean back in, so ulps of the
decoder compound over the horizon), actions equal; Dyna's total loss (real
+ weighted imagined) at rtol 1e-6 and the params after its clip + Adam
step at rtol 1e-5 / atol 1e-7, as tests/test_torch_baselines.py holds the
other losses.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfvae_tpu.baselines import dyna as jdyna
from mfvae_tpu.baselines import vdn as jvdn
from mfvae_tpu_torch.baselines import dyna, vdn
from mfvae_tpu_torch.config import ModelConfig
from mfvae_tpu_torch.envs.mpe import make
from mfvae_tpu_torch.inference import WorldModel
from mfvae_tpu_torch.models.convert import params_from_jax, qnet_params_from_jax
from mfvae_tpu_torch.models.mavae import MAVAE, GroupedBatch
from mfvae_tpu_torch.models.qlearning import EpsNoise
from mfvae_tpu_torch.training.experiment import build_spec
from tests.test_dyna import tiny_vdn_cfg, tiny_wm
from tests.test_torch_baselines import jax_windows, port_batch
from tests.test_torch_experiment import one_torch_thread  # noqa: F401


def t(x):
    return torch.from_numpy(np.array(x))


def port_cfg(jcfg, **kw):
    return vdn.VdnConfig(**{**dataclasses.asdict(jcfg), **kw})


@pytest.fixture(scope="module")
def worlds():
    """(JAX WorldModel, port WorldModel) over one set of params."""
    jwm, exp = tiny_wm()
    env = make("MPE_simple_tag_v3", device="cpu", num_good_agents=1, num_adversaries=2, num_obs=1)
    m = exp.cfg.model
    cfg = ModelConfig(**{f.name: getattr(m, f.name) for f in dataclasses.fields(ModelConfig)})
    model = MAVAE.from_config(cfg, build_spec(env), device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(jwm.variables)), strict=True)
    return jwm, WorldModel(model)


def q_networks(n, d, hidden, seed=1):
    jnet = jvdn.VdnNetwork(action_dim=5, n_agents=n, hidden_dim=hidden, param_share=True)
    params = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, n, hidden)), jnp.zeros((1, 1, n, d)),
                       jnp.zeros((1, 1), bool))
    net = vdn.VdnNetwork(5, n, hidden, True, in_dim=d)
    net.load_state_dict(qnet_params_from_jax(jax.device_get(params)))
    return params, net


def jax_eps_draws(key, horizon, s, n):
    """The draws of JAX's imagination for ``key``: per step k_bern, k_rand."""
    uni, rnd = [], []
    for k in jax.random.split(key, horizon + 1):
        k_bern, k_rand = jax.random.split(k)
        uni.append(jax.random.uniform(k_bern, (s, n)))
        rnd.append(jax.random.randint(k_rand, (s, n), 0, 5, dtype=jnp.int32))
    return EpsNoise(t(np.stack(uni)), t(np.stack(rnd)))


@pytest.mark.parametrize("eps", [0.0, 0.5])
def test_imagined_windows_match_jax(worlds, eps):
    jwm, wm = worlds
    jcfg = tiny_vdn_cfg(reward_scale=0.5)
    horizon, S = 3, 4
    n = wm.spec.n_agents
    d = max(od for (od, _), _ in wm.spec.groups) + n
    params, net = q_networks(n, d, jcfg.hidden_dim)
    rng = np.random.default_rng(0)
    real = jvdn.Timestep(obs=jnp.asarray(rng.normal(size=(S, 2, n, d)).astype(np.float32)),
                         actions=jnp.zeros((S, 2, n), jnp.int32), rewards=jnp.zeros((S, 2)),
                         done=jnp.zeros((S, 2), bool))
    key = jax.random.PRNGKey(3)
    want = jax.jit(jdyna.make_imagine_fn(jwm, jcfg, horizon=horizon, imagine_eps=eps))(params, real, key)
    imagine = dyna.make_imagine_fn(wm, port_cfg(jcfg), horizon=horizon, imagine_eps=eps)
    with torch.no_grad():
        got = imagine(net, port_batch(real), noise=jax_eps_draws(key, horizon, S, n))
    assert tuple(got.obs.shape) == (S, horizon + 1, n, d) and tuple(got.rewards.shape) == (S, horizon + 1)
    np.testing.assert_array_equal(got.actions.numpy(), np.asarray(want.actions))
    assert got.actions.dtype == torch.int32 and not bool(got.done.any())
    np.testing.assert_array_equal(got.obs[:, 0].numpy(), np.asarray(real.obs[:, 0]))  # anchored at the real starts
    np.testing.assert_allclose(got.obs.numpy(), np.asarray(want.obs), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.rewards.numpy(), np.asarray(want.rewards), rtol=1e-5, atol=1e-6)


def test_step_zero_reward_is_the_world_models(worlds):
    """tests/test_dyna.py: the step-0 imagined reward is reward_scale times
    the team sum of the model's prediction for (obs0, greedy actions)."""
    _, wm = worlds
    spec = wm.spec
    n = spec.n_agents
    d_pad = max(od for (od, _), _ in spec.groups)
    _, net = q_networks(n, d_pad + n, 8)
    imagine = dyna.make_imagine_fn(wm, vdn.VdnConfig(hidden_dim=8, reward_scale=0.5), horizon=1, imagine_eps=0.0)
    obs0 = torch.randn(2, n, d_pad + n, generator=torch.Generator().manual_seed(2))
    real = vdn.Timestep(obs0[:, None], torch.zeros(2, 1, n, dtype=torch.int32), torch.zeros(2, 1),
                        torch.zeros(2, 1, dtype=torch.bool))
    with torch.no_grad():
        seq = imagine(net, real, torch.Generator().manual_seed(3))
        _, q = net(torch.zeros(2, n, 8), obs0[None], torch.ones(1, 2, dtype=torch.bool))
        greedy = torch.argmax(q[0], dim=-1)
        obs_g = tuple(torch.stack([obs0[:, i, :od] for i in idxs], dim=1) for (od, _), idxs in spec.groups)
        act_g = tuple(greedy[:, list(idxs)] for _, idxs in spec.groups)
        _, rew = wm._predict(GroupedBatch(obs=obs_g, actions=act_g))
    assert torch.equal(seq.actions[:, 0], greedy.to(torch.int32))
    torch.testing.assert_close(seq.rewards[:, 0], 0.5 * rew.sum(-1), rtol=1e-6, atol=0)


def test_a_continuous_world_model_is_refused():
    env = make("MPE_simple_tag_v3", device="cpu", num_good_agents=1, num_adversaries=2, num_obs=1,
               discrete_actions=False)
    model = MAVAE.from_config(ModelConfig(discrete_act=False, idx_features=8, obs_features=8, action_features=8,
                                          encoder_hidden=(16,), decoder_hidden=(16,), compute_dtype="float32"),
                              build_spec(env), device="cpu")
    with pytest.raises(ValueError, match="discrete-action"):
        dyna.make_imagine_fn(WorldModel(model), vdn.VdnConfig())


def test_dyna_total_loss_step_matches_jax(worlds):
    """One Dyna update's loss (real + imagine_weight x imagined) and its
    clip + Adam step against JAX's: the real windows and JAX's imagined
    windows (from its k_img, the fourth key of the update's split) handed
    to the port's ``learn``."""
    jwm, wm = worlds
    jcfg = tiny_vdn_cfg(num_steps=8, min_buffer_time=8, max_env_steps=5)
    jtrain = jdyna.make_dyna_train(jcfg, jwm, horizon=3, imagine_weight=0.5)
    r0 = jax.jit(jtrain.init_runner)(jax.random.PRNGKey(0))
    r1, m1 = jax.jit(lambda r: jtrain.update_chunk(r, 1))(r0)
    jbatch = jax_windows(jcfg, r0, r1, n_keys=4)
    k_img = jax.random.split(r0.rng, 4)[3]
    jimg = jdyna.make_imagine_fn(jwm, jcfg, horizon=3)(r0.train_state.params, jbatch, k_img)

    train = dyna.make_dyna_train(port_cfg(jcfg), wm, horizon=3, imagine_weight=0.5, device="cpu")
    runner = train.init_runner(0)
    runner.network.load_state_dict(qnet_params_from_jax(jax.device_get(r0.train_state.params)))
    runner.target.load_state_dict(qnet_params_from_jax(jax.device_get(r0.target_params)))
    loss = train.learn(runner, port_batch(jbatch), port_batch(jimg))
    np.testing.assert_allclose(float(loss), float(m1["loss"][0]), rtol=1e-6)
    want = qnet_params_from_jax(jax.device_get(r1.train_state.params))
    for name, p in runner.network.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-5, atol=1e-7, err_msg=name)


def test_dyna_trains_end_to_end_and_imagines_without_grad(worlds):
    _, wm = worlds
    cfg = port_cfg(tiny_vdn_cfg())
    out = dyna.make_dyna_train(cfg, wm, horizon=3, imagine_weight=0.5, device="cpu")(0)
    assert out["metrics"]["loss"].shape == (cfg.num_updates,) and np.isfinite(out["metrics"]["loss"]).all()
    assert all(p.grad is None for p in wm.model.parameters())
    imagine, seen = dyna.make_imagine_fn(wm, cfg, horizon=3), []

    def spy(network, batch, generator):
        img = imagine(network, batch, generator)
        seen.append((torch.is_grad_enabled(), img.obs.requires_grad, tuple(img.obs.shape)))
        return img

    vdn.make_train(cfg, imagine_fn=spy, imagine_weight=0.5, device="cpu")(0)
    n = wm.spec.n_agents
    d = max(od for (od, _), _ in wm.spec.groups) + n
    assert seen and all(s == (False, False, (cfg.batch_size, 4, n, d)) for s in seen), seen


def test_plain_vdn_rng_unchanged():
    """tests/test_dyna.py: two runs of the unhooked path agree exactly."""
    cfg = port_cfg(tiny_vdn_cfg())
    a = vdn.make_train(cfg, device="cpu")(0)["metrics"]["loss"]
    b = vdn.make_train(cfg, device="cpu")(0)["metrics"]["loss"]
    np.testing.assert_array_equal(a, b)
