"""The port's Q-learning baselines (``mfvae_tpu_torch/baselines/vdn.py``,
``iql.py``, ``qmix.py``) against the JAX package's.

- One learn step by each loss: the JAX package runs two updates
  (``init_runner`` and ``update_chunk(1)`` twice; QMIX, which has no
  chunked API, one ``train`` update), and the port replays them on the
  same params: JAX's init bridged in, the windows JAX sampled (gathered
  from its buffer at the rows and starts replayed from its key), the
  target copy after update 0.  Cases: VDN one-step and TD(λ), IQL one-step
  and TD(λ), QMIX, independent params, ``max_grad_norm=0.1`` (the clip
  runs), ``lr_linear_decay`` (the second step's lr differs).  The loss at
  rtol 1e-6, the clipped grads of the first step at rtol 1e-5 (JAX's read
  from its Adam state, mu = (1 - b1)·g; atol 1e-5 of the leaf's largest:
  a sum over the batch rounds to an ulp of its largest terms), params
  after each clip + Adam step at rtol 1e-5 (atol 1e-7: a bias that starts
  at 0 is compared to its own size, a few lr).
- Whole runs on the CPU: tiny VDN (shared and independent), TD(λ), IQL and
  QMIX, finite metrics of shape [updates]; the spread, world_comm and
  adversary cases of tests/test_baselines_spread.py; IQL's per-agent
  rewards; chunked updates equal one ``train`` bit for bit; seeds; the
  metrics callback; a same-seed rerun bit-equal; no host read inside an
  update.
- The seed band: over 8 seeds of tests/test_vdn.py's ``tiny_config`` the
  port's final loss and mean ``returned_episode_returns`` lie within 3
  standard errors of JAX's.
- The CLI with ``--device cpu``, its refusal without a card, the
  ``{tag}_params.safetensors`` file against JAX's, and the YAML copies.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfvae_tpu.baselines import iql as jiql
from mfvae_tpu.baselines import qmix as jqmix
from mfvae_tpu.baselines import vdn as jvdn
from mfvae_tpu.data.buffer import TrajectoryBuffer as JTrajectoryBuffer
from mfvae_tpu_torch.baselines import iql, qmix, vdn
from mfvae_tpu_torch.models.convert import mixer_params_from_jax, qnet_params_from_jax
from tests.test_torch_experiment import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

TINY = dict(num_good_agents=1, num_adversaries=2, num_obs=1, max_env_steps=5, num_envs=2, num_steps=8,
            num_updates=4, buffer_size_time=64, min_buffer_time=8, batch_size=4, sample_sequence_length=4,
            hidden_dim=16, test_during_training=False, log_during_training=False)


def t(x):
    return torch.from_numpy(np.array(x))


def port_batch(jbatch) -> vdn.Timestep:
    return vdn.Timestep(*(t(x) for x in jbatch))


def jax_windows(cfg, runner_before, runner_after, n_keys=3):
    """The windows JAX's update sampled: its buffer after the add, at the
    key its update split off (third of 3, or of 4 with an imagine_fn)."""
    buf = JTrajectoryBuffer(add_batch_size=cfg.num_envs, time_capacity=cfg.buffer_size_time,
                            min_length_time=cfg.min_buffer_time, sample_batch_size=cfg.batch_size,
                            sample_sequence_length=cfg.sample_sequence_length)
    k_sample = jax.random.split(runner_before.rng, n_keys)[2]
    return buf.sample(runner_after.buffer_state, k_sample).experience


def adam_grads(opt_state):
    """JAX's first-step grads from its Adam state: mu / (1 - b1)."""
    mu = opt_state[1][0].mu
    return jax.tree.map(lambda m: np.asarray(m) / 0.1, mu)


def assert_module_close(module, want_sd, rtol=1e-5, atol=1e-7, what="param"):
    got = dict(module.named_parameters())
    assert set(got) == set(want_sd)
    for name, w in want_sd.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {name}")


def assert_grads_close(module, want_sd):
    for name, p in module.named_parameters():
        w = want_sd[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max(), err_msg=name)


LEARN_CASES = {
    "vdn": ("vdn", {}),
    "vdn_td_lambda": ("vdn", dict(td_lambda_loss=True, td_lambda=0.6)),
    "iql": ("iql", dict(reward_scale=0.05)),
    "iql_td_lambda": ("iql", dict(reward_scale=0.05, td_lambda_loss=True)),
    "independent": ("vdn", dict(param_share=False)),
    "clip_0.1": ("vdn", dict(max_grad_norm=0.1)),
    "lr_linear_decay": ("vdn", dict(lr_linear_decay=True)),
}


@pytest.mark.parametrize("case", sorted(LEARN_CASES))
def test_two_learn_steps_match_jax(case):
    algo, kw = LEARN_CASES[case]
    jmod, tmod, cls = (jvdn, vdn, vdn.VdnConfig) if algo == "vdn" else (jiql, iql, iql.IqlConfig)
    jcfg = (jvdn.VdnConfig if algo == "vdn" else jiql.IqlConfig)(**TINY, **kw)
    jtrain = jmod.make_train(jcfg)
    r0 = jax.jit(jtrain.init_runner)(jax.random.PRNGKey(0))
    chunk = jax.jit(lambda r: jtrain.update_chunk(r, 1))
    r1, m1 = chunk(r0)
    r2, m2 = chunk(r1)

    train = tmod.make_train(cls(**TINY, **kw), device="cpu")
    runner = train.init_runner(0)
    bridge = (lambda tree: qnet_params_from_jax(jax.device_get(tree)))
    runner.network.load_state_dict(bridge(r0.train_state.params))
    runner.target.load_state_dict(bridge(r0.target_params))

    loss1 = train.learn(runner, port_batch(jax_windows(jcfg, r0, r1)))
    np.testing.assert_allclose(float(loss1), float(m1["loss"][0]), rtol=1e-6)
    if case == "clip_0.1":  # the clip ran: the clipped grads' global norm is max_grad_norm
        norm = torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in runner.network.parameters()]))
        assert abs(float(norm) - 0.1) < 1e-6
    assert_grads_close(runner.network, bridge(adam_grads(r1.train_state.opt_state)))
    assert_module_close(runner.network, bridge(r1.train_state.params))
    # update 0 copies the post-step params into the target
    runner.target.load_state_dict(runner.network.state_dict())
    np.testing.assert_array_equal(np.asarray(jax.tree.leaves(r1.target_params)[0]),
                                  np.asarray(jax.tree.leaves(r1.train_state.params)[0]))
    loss2 = train.learn(runner, port_batch(jax_windows(jcfg, r1, r2)))
    np.testing.assert_allclose(float(loss2), float(m2["loss"][0]), rtol=1e-6)
    assert_module_close(runner.network, bridge(r2.train_state.params))
    assert runner.opt_step == 2 == int(r2.train_state.step)


def test_qmix_learn_step_matches_jax():
    kw = dict(TINY, mixing_dim=8, hypernet_dim=16, reward_scale=0.05, num_updates=1)
    jcfg = jqmix.QmixConfig(**kw)
    out = jax.jit(jqmix.make_train(jcfg))(jax.random.PRNGKey(0))
    jr = out["runner"]
    # the init JAX's train drew: rng, k_reset, k_agent, k_mix = split(key, 4)
    rng, _, k_agent, k_mix = jax.random.split(jax.random.PRNGKey(0), 4)
    n, d_in = 3, jvdn._pad_width(jvdn.make_env(jcfg.env_name, num_good_agents=1, num_adversaries=2,
                                               num_obs=1)) + 3
    agent0 = jvdn.VdnNetwork(action_dim=5, n_agents=n, hidden_dim=16).init(
        k_agent, jnp.zeros((1, n, 16)), jnp.zeros((1, 1, n, d_in)), jnp.zeros((1, 1), bool))
    mixer0 = jqmix.MixingNetwork(n_agents=n, mixing_dim=8, hypernet_dim=16).init(
        k_mix, jnp.zeros((1, n)), jnp.zeros((1, n * d_in)))

    train = qmix.make_train(qmix.QmixConfig(**kw), device="cpu")
    runner = train.init_runner(0)
    for module in (runner.network, runner.target):
        module.agent.load_state_dict(qnet_params_from_jax(jax.device_get(agent0)))
        module.mixer.load_state_dict(mixer_params_from_jax(jax.device_get(mixer0)))

    class Before:  # the runner state the update started from
        pass

    before = Before()
    before.rng = rng
    loss = train.learn(runner, port_batch(jax_windows(jcfg, before, jr)))
    np.testing.assert_allclose(float(loss), float(out["metrics"]["loss"][0]), rtol=1e-6)
    grads = adam_grads(jr.train_state.opt_state)
    assert_grads_close(runner.network.agent, qnet_params_from_jax(grads.agent))
    assert_grads_close(runner.network.mixer, mixer_params_from_jax(grads.mixer))
    assert_module_close(runner.network.agent, qnet_params_from_jax(jax.device_get(jr.train_state.params.agent)))
    assert_module_close(runner.network.mixer, mixer_params_from_jax(jax.device_get(jr.train_state.params.mixer)))


# --------------------------------------------------------------- whole runs
WHOLE = {
    "vdn shared": (vdn, vdn.VdnConfig, dict(test_during_training=True, test_num_envs=2, test_num_steps=4,
                                            test_interval=2)),
    "vdn independent": (vdn, vdn.VdnConfig, dict(param_share=False)),
    "vdn td_lambda": (vdn, vdn.VdnConfig, dict(td_lambda_loss=True)),
    "iql": (iql, iql.IqlConfig, dict(reward_scale=0.05)),
    "qmix": (qmix, qmix.QmixConfig, dict(mixing_dim=8, hypernet_dim=16, reward_scale=0.05)),
}


@pytest.mark.parametrize("case", sorted(WHOLE))
def test_whole_run_trains(case):
    mod, cls, kw = WHOLE[case]
    cfg = cls(**dict(TINY, **kw))
    out = mod.make_train(cfg, device="cpu")(0)
    m = out["metrics"]
    keys = {"loss", "epsilon", "mean_reward", "returned_episode_returns"} | ({"test_return"} if mod is not qmix
                                                                           else set())
    assert set(m) == keys
    for k, v in m.items():
        assert v.shape == (cfg.num_updates,) and np.isfinite(v).all(), k
    assert out["runner"].update_i == cfg.num_updates
    assert out["runner"].opt_step == cfg.num_updates  # 8 steps a update >= min_buffer_time 8: learns from update 0
    if case == "vdn shared":  # tested at updates 0 and 2; in between the last result carries
        assert m["test_return"][1] == m["test_return"][0] and m["test_return"][3] == m["test_return"][2]


SPREAD = dict(env_name="MPE_simple_spread_v3", num_good_agents=3, max_env_steps=8, num_envs=2, num_steps=8,
              num_updates=3, buffer_size_time=64, min_buffer_time=8, batch_size=4, sample_sequence_length=4,
              hidden_dim=16, test_during_training=False, log_during_training=False)


@pytest.mark.parametrize("algo", ["vdn", "iql", "qmix"])
def test_training_on_spread(algo):
    """tests/test_baselines_spread.py: spread's shared rewards are negative."""
    mod, cls, extra = {"vdn": (vdn, vdn.VdnConfig, {}), "iql": (iql, iql.IqlConfig, {}),
                       "qmix": (qmix, qmix.QmixConfig, dict(mixing_dim=8, hypernet_dim=16))}[algo]
    cfg = cls(**SPREAD, **extra)
    m = mod.make_train(cfg, device="cpu")(0)["metrics"]
    assert m["loss"].shape == (cfg.num_updates,) and np.isfinite(m["loss"]).all()
    assert float(m["mean_reward"][-1]) < 0.0


@pytest.mark.parametrize("env_name,pop", [
    ("MPE_simple_world_comm_v3", dict(num_good_agents=2, num_adversaries=4, num_obs=1, reward_scale=0.05)),
    ("MPE_simple_adversary_v3", dict(num_good_agents=2)),
])
def test_vdn_on_the_other_scenarios(env_name, pop):
    """world_comm: the leader's Discrete(20) sets every agent's Q-head (the
    env moves by a % 5); adversary: heterogeneous obs through the shared
    Q stack."""
    cfg = vdn.VdnConfig(**dict(SPREAD, env_name=env_name, **pop))
    train = vdn.make_train(cfg, device="cpu")
    out = train(0)
    assert np.isfinite(out["metrics"]["loss"]).all()
    want_actions = 20 if "world_comm" in env_name else 5
    assert out["runner"].network.agent.dense1.kernel.shape[-1] == want_actions


def test_iql_stores_per_agent_rewards_and_keeps_their_signs():
    """tests/test_iql.py: the ring carries [N] rewards, and where the
    adversaries scored a tag some prey lost."""
    cfg = iql.IqlConfig(**dict(TINY, num_updates=8, num_steps=25, num_adversaries=8, num_good_agents=4,
                               num_envs=4, reward_scale=1.0, max_env_steps=25))
    train = iql.make_train(cfg, device="cpu")
    runner, _ = train.update_chunk(train.init_runner(2), 8)
    rew = runner.buffer_state.data.rewards.numpy()  # [B, T, N]
    assert rew.shape[-1] == 12
    adv, good = rew[..., :8], rew[..., 8:]
    assert (adv > 0).any(), "no adversary collision reward in the rollout"
    assert (good[adv[..., 0] > 0] < 0).any(axis=-1).all()


def test_chunked_updates_equal_one_train_call_bit_for_bit():
    cfg = vdn.VdnConfig(**dict(TINY, num_updates=6, log_chunk=3))
    train = vdn.make_train(cfg, device="cpu")
    whole = train(4)
    runner = train.init_runner(4)
    runner, m1 = train.update_chunk(runner, 4)
    runner, m2 = train.update_chunk(runner, 2)
    for k, v in whole["metrics"].items():
        np.testing.assert_array_equal(np.concatenate([m1[k], m2[k]]), v, err_msg=k)
    for a, b in zip(runner.network.parameters(), whole["runner"].network.parameters()):
        assert torch.equal(a, b)


def test_seeds_run_one_after_another_and_differ():
    cfg = vdn.VdnConfig(**dict(TINY, num_updates=2))
    out = vdn.run_seeds(vdn.make_train(cfg, device="cpu"), [0, 1, 2])
    assert out["metrics"]["loss"].shape == (3, 2)
    assert not np.allclose(out["metrics"]["mean_reward"][0], out["metrics"]["mean_reward"][1])


def test_metrics_callback_fires_once_per_update_in_order():
    seen = []
    cfg = vdn.VdnConfig(**dict(TINY, num_updates=3, log_chunk=2, test_during_training=True, test_num_envs=2,
                               test_num_steps=4))
    vdn.make_train(cfg, metrics_callback=lambda m, i: seen.append((i, {k: float(v) for k, v in m.items()})),
                   device="cpu")(0)
    assert [i for i, _ in seen] == [0, 1, 2]
    # the keys of the JAX package's callback
    jseen = []
    jcfg = jvdn.VdnConfig(**dict(TINY, num_updates=1, test_during_training=True, test_num_envs=2, test_num_steps=4))
    out = jax.jit(jvdn.make_train(jcfg, metrics_callback=lambda m, i: jseen.append(set(m))))(jax.random.PRNGKey(0))
    jax.block_until_ready(out["metrics"]["loss"])
    jax.effects_barrier()
    for _, m in seen:
        assert set(m) == jseen[0]
        assert all(np.isfinite(v) for v in m.values()), m


def test_same_seed_rerun_is_bit_equal():
    cfg = vdn.VdnConfig(**dict(TINY, num_updates=3))
    a = vdn.make_train(cfg, device="cpu")(0)["metrics"]
    b = vdn.make_train(cfg, device="cpu")(0)["metrics"]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_an_update_reads_nothing_back(monkeypatch):
    """The JAX package's three lax.conds become host decisions on host
    counters: inside an update (rollout, add, sample, learn, target copy,
    greedy test) no tensor is read by the host.  Adam keeps its step count
    as a CPU tensor (on the card too) and reads it; that read is allowed."""
    cfg = vdn.VdnConfig(**dict(TINY, test_during_training=True, test_interval=1, test_num_envs=2,
                               test_num_steps=4, target_update_interval=1))
    train = vdn.make_train(cfg, device="cpu")
    runner = train.init_runner(0)
    train.update_step(runner)  # Adam makes its state at the first step
    steps = {id(s["step"]) for s in runner.optimizer.state.values()}

    real_item = torch.Tensor.item

    def item(self):
        if id(self) in steps:
            return real_item(self)
        raise RuntimeError("a host read of a tensor")

    def refuse(self, *_):
        raise RuntimeError("a host read of a tensor")

    with monkeypatch.context() as m:
        for name in ("__bool__", "__int__", "__float__", "tolist"):
            m.setattr(torch.Tensor, name, refuse)
        m.setattr(torch.Tensor, "item", item)
        metrics = train.update_step(runner)
        assert runner.opt_step == 2
    assert np.isfinite(float(metrics["loss"]))


# ---------------------------------------------------------------- seed band
def test_seed_band_against_jax():
    """Over 8 seeds of tests/test_vdn.py's tiny_config, the port's final
    loss and mean returned_episode_returns lie within 3 standard errors of
    JAX's (the runs cannot match draw for draw)."""
    from tests.test_vdn import tiny_config

    jcfg = tiny_config(test_during_training=False, log_during_training=False)
    jm = jax.jit(jax.vmap(jvdn.make_train(jcfg)))(jax.random.split(jax.random.PRNGKey(0), 8))["metrics"]
    cfg = vdn.VdnConfig(**{k: getattr(jcfg, k) for k in jcfg.__dataclass_fields__})
    pm = vdn.run_seeds(vdn.make_train(cfg, device="cpu"), list(range(8)))["metrics"]
    for key in ("loss", "returned_episode_returns"):
        j, p = np.asarray(jm[key])[:, -1], pm[key][:, -1]
        se = np.sqrt(j.var(ddof=1) / 8 + p.var(ddof=1) / 8)
        gap = abs(j.mean() - p.mean()) / se
        print(f"{key}: JAX {j.mean():.4f} +- {j.std(ddof=1) / 8 ** 0.5:.4f}, port {p.mean():.4f} +- "
              f"{p.std(ddof=1) / 8 ** 0.5:.4f}, gap {gap:.2f} standard errors")
        assert gap < 3.0, key


# ------------------------------------------------------------ CLI and files
CLI_TINY = ["num_good_agents=1", "num_adversaries=2", "num_obs=1", "num_updates=2", "num_envs=2",
            "num_steps=8", "buffer_size_time=64", "min_buffer_time=8", "batch_size=2", "hidden_dim=8",
            "sample_sequence_length=4", "test_num_envs=2", "test_num_steps=4", "log_dir=results"]


def test_cli_prints_jaxs_final_line_on_the_cpu(tmp_path):
    cfg = ROOT / "mfvae_tpu_torch/baselines/config/vdn.yaml"
    proc = subprocess.run([sys.executable, "-m", "mfvae_tpu_torch.baselines.vdn", str(cfg), "--device", "cpu",
                           *CLI_TINY], cwd=tmp_path, capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith("final loss=") and " mean_return=" in last and " test_return=" in last, last
    assert (tmp_path / "vdn_params.safetensors").exists()
    assert (tmp_path / "results" / "vdn" / "metrics.jsonl").exists()


def test_cli_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vdn.cli(CLI_TINY, vdn.main)
    assert not (tmp_path / "vdn_params.safetensors").exists()


def test_params_file_matches_jaxs(tmp_path, monkeypatch):
    from safetensors.numpy import load_file

    kw = dict(num_good_agents=1, num_adversaries=2, num_obs=1, num_updates=2, num_envs=2, buffer_size_time=64,
              min_buffer_time=16, batch_size=2, hidden_dim=8, log_during_training=False,
              test_during_training=False)
    for share in (True, False):
        (tmp_path / "jax").mkdir(exist_ok=True)
        (tmp_path / "port").mkdir(exist_ok=True)
        monkeypatch.chdir(tmp_path / "jax")
        jvdn.main(None, param_share=share, **kw)
        monkeypatch.chdir(tmp_path / "port")
        vdn.main(None, device="cpu", param_share=share, **kw)
        want = load_file(str(tmp_path / "jax" / "vdn_params.safetensors"))
        got = load_file(str(tmp_path / "port" / "vdn_params.safetensors"))
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
            assert np.isfinite(got[k]).all()


def test_save_safetensors_round_trips(tmp_path):
    from safetensors.numpy import load_file

    arrays = {"a/b": np.arange(6, dtype=np.float32).reshape(2, 3), "c": np.array([1, 2], np.int32),
              "flag": np.array([True, False]), "s": np.float32(3.0)[None]}
    vdn.save_safetensors(arrays, str(tmp_path / "x.safetensors"))
    back = load_file(str(tmp_path / "x.safetensors"))
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype


@pytest.mark.parametrize("name", ["vdn.yaml", "vdn_tuned.yaml", "iql.yaml"])
def test_yaml_copies_are_byte_equal(name):
    got = (ROOT / "mfvae_tpu_torch/baselines/config" / name).read_bytes()
    assert got == (ROOT / "mfvae_tpu/baselines/config" / name).read_bytes()
    cfg = (iql.IqlConfig if name == "iql.yaml" else vdn.VdnConfig).from_yaml(
        str(ROOT / "mfvae_tpu_torch/baselines/config" / name))
    assert cfg.env_name == "MPE_simple_tag_v3" and cfg.num_adversaries == 30
