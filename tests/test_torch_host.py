"""The host backend of the port (``mfvae_tpu_torch/utils/native_build.py``,
``envs/native_engine.py``, ``data/host_buffer.py``, ``envs/host_adapter.py``,
``envs/policies.py`` ``host_pursuit_actions``, ``baselines/collect_policy.py``
``HostQCollectPolicy``, ``training/host_experiment.py``) against the JAX
package's.

- The port's native engine, all four scenarios: against the port's own
  MPE envs under state injection at tests/test_native_engine.py's
  tolerances (obs rtol 2e-4 / atol 2e-5, rewards rtol 1e-4 / atol 1e-5,
  done exact: C++ and torch round differently), and against the JAX
  package's wrappers of the same source, bit-equal.
- ``HostRingBuffer`` (native and numpy), the collectors' synchronous
  ``collect(n)`` under random, pursuit, episode_mix and ``vdn:``, and
  ``host_pursuit_actions``: bit-equal to the JAX package's at one seed,
  ring contents and ``sample()`` alike.
- ``HostQCollectPolicy`` on a JAX-saved ``.npz``: the same actions.
- ``HostExperiment``: the same host batch as JAX's, one train step with
  bridged params and JAX's eps at rtol 1e-5 (float32); a threaded run, the
  CLI with ``--device cpu``, a collector that dies, the fallbacks.
"""

import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfvae_tpu.baselines import collect_policy as jcp
from mfvae_tpu.baselines.vdn import VdnNetwork as JVdnNetwork
from mfvae_tpu.data import host_buffer as jhb
from mfvae_tpu.envs import host_adapter as jha
from mfvae_tpu.envs import native_engine as jne
from mfvae_tpu.envs.policies import host_pursuit_actions as j_host_pursuit_actions
from mfvae_tpu.training.host_experiment import HostExperiment as JHostExperiment
from mfvae_tpu_torch.baselines import collect_policy as cp
from mfvae_tpu_torch.data import host_buffer as hb
from mfvae_tpu_torch.envs import host_adapter as ha
from mfvae_tpu_torch.envs import mpe
from mfvae_tpu_torch.envs import native_engine as ne
from mfvae_tpu_torch.envs.policies import host_pursuit_actions
from mfvae_tpu_torch.models.convert import params_from_jax
from mfvae_tpu_torch.training.experiment import run_experiment
from mfvae_tpu_torch.training.host_experiment import HostExperiment
from mfvae_tpu_torch.utils import native_build
from tests.test_torch_batched import tiny_cfg
from tests.test_torch_experiment import one_torch_thread  # noqa: F401
from tests.test_training import tiny_cfg as j_tiny_cfg

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def native_toolchain():
    """Both packages' engines and rings build here (g++ is part of the
    test image, as for tests/test_native_engine.py)."""
    assert ne.native_engine_available() and jne.native_engine_available()
    assert hb._get_lib() is not None


# ------------------------------------------------------------------ engine
SCENARIOS = {
    # name -> (the port's torch env, the native env's kwargs, the native class's name)
    "tag": (lambda: mpe.SimpleTagEnv(num_good_agents=2, num_adversaries=3, num_obs=2, max_steps=50, device="cpu"),
            dict(num_good_agents=2, num_adversaries=3, num_obs=2, max_steps=50), "NativeSimpleTagEnv"),
    "spread": (lambda: mpe.SimpleSpreadEnv(num_agents=3, max_steps=50, device="cpu"),
               dict(num_agents=3, max_steps=50), "NativeSimpleSpreadEnv"),
    "adversary": (lambda: mpe.SimpleAdversaryEnv(num_good_agents=3, max_steps=50, device="cpu"),
                  dict(num_good_agents=3, max_steps=50), "NativeSimpleAdversaryEnv"),
    "world_comm": (lambda: mpe.SimpleWorldCommEnv(max_steps=50, device="cpu"),
                   dict(max_steps=50), "NativeSimpleWorldCommEnv"),
}


def _injected_state(name, env, rng):
    n, lm = env.num_agents, env.num_landmarks if name != "tag" else env.num_obs
    pos = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    vel = rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32)
    lmk = rng.uniform(-0.9, 0.9, (lm, 2)).astype(np.float32)
    t = [torch.from_numpy(x) for x in (pos, vel, lmk)]
    step = torch.tensor(0, dtype=torch.int32)
    if name == "adversary":
        return (pos, vel, lmk), mpe.AdversaryState(*t, torch.tensor(1, dtype=torch.int32), step)
    if name == "world_comm":
        return (pos, vel, lmk), mpe.WorldCommState(*t, torch.zeros(env.dim_c), step)
    return (pos, vel, lmk), mpe.MPEState(*t, step)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_native_engine_tracks_the_port_env(name):
    """12 steps from one injected state: obs, rewards and done of the
    native engine against the port's torch env."""
    make_env, kw, cls = SCENARIOS[name]
    env = make_env()
    nenv = getattr(ne, cls)(n_envs=1, n_threads=1, auto_reset=False, **kw)
    rng = np.random.default_rng(0)
    (pos, vel, lmk), state = _injected_state(name, env, rng)
    nenv.set_state(0, pos, vel, lmk, step=0)
    if name == "adversary":
        nenv.set_goal(1, env=0)
    highs = nenv.action_highs
    for t in range(12):
        acts = rng.integers(0, highs)
        obs, state, rew, done, _ = env.step_stacked(state, torch.from_numpy(acts.astype(np.int32)))
        nobs, nrew, ndone = nenv.step(acts[None].astype(np.int32))
        parts = nenv.split_obs(nobs)
        parts = (parts,) if name == "spread" else parts
        for got, want in zip(parts, obs):
            np.testing.assert_allclose(got[0], want.numpy(), rtol=2e-4, atol=2e-5, err_msg=f"obs, step {t}")
        np.testing.assert_allclose(nrew[0], rew.numpy(), rtol=1e-4, atol=1e-5, err_msg=f"rewards, step {t}")
        assert bool(ndone[0]) == bool(done.any())


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_native_engine_bit_equal_to_jax_wrappers(name):
    """The same seed and actions through both packages' wrappers: every
    obs, reward, done and position equal, auto-resets included."""
    _, kw, cls = SCENARIOS[name]
    kw = dict(kw, max_steps=7)
    ours = getattr(ne, cls)(n_envs=3, seed=5, n_threads=1, **kw)
    theirs = getattr(jne, cls)(n_envs=3, seed=5, n_threads=1, **kw)
    np.testing.assert_array_equal(ours.reset(), theirs.reset())
    rng = np.random.default_rng(1)
    for _ in range(16):  # past two auto-resets
        acts = rng.integers(0, ours.action_highs, size=(3, ours.num_agents)).astype(np.int32)
        for got, want in zip(ours.step(acts), theirs.step(acts)):
            np.testing.assert_array_equal(got, want)
        for e in range(3):
            for got, want in zip(ours.get_state(e), theirs.get_state(e)):
                np.testing.assert_array_equal(got, want)
    assert ours.agents == theirs.agents


def test_host_env_spaces_are_the_ports():
    env = ne.NativeWorldCommHostEnv(num_good=2, num_adversaries=4, num_obstacles=1, max_cycles=25)
    lead = env.action_space("leadadversary_0")
    assert type(lead).__module__ == "mfvae_tpu_torch.envs.spaces" and lead.n == 20
    assert ha.get_space_size(env.observation_space("agent_0")) == env._env.obs_dim_good
    cont = ne.NativeHostEnv(1, 2, 1, 25, continuous=True)
    assert ha.get_space_size(cont.action_space("agent_0")) == 2


def test_space_sizes_by_duck_typing():
    gym = pytest.importorskip("gymnasium")
    assert ha.get_space_size(gym.spaces.Discrete(7)) == 7
    assert ha.get_space_size(gym.spaces.MultiBinary((2, 3))) == 6
    assert ha.get_space_size(gym.spaces.Box(-1, 1, (4,))) == 4
    for space in (gym.spaces.Discrete(7), gym.spaces.MultiBinary(5), gym.spaces.Box(-1, 1, (4,))):
        assert ha.get_space_size(space) == jha.get_space_size(space)


def test_create_transition_matches_jax():
    rng = np.random.default_rng(5)
    agents = ("agent_0", "agent_1")
    obs, nobs = ({a: rng.normal(size=(4,)).astype(np.float32) for a in agents} for _ in range(2))
    act, done = {a: i for i, a in enumerate(agents)}, {"agent_0": False, "agent_1": True}
    for got, want in zip(ha.create_transition(obs, act, nobs, done, 1.5),
                         jha.create_transition(obs, act, nobs, done, 1.5)):
        np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------------- ring
SCHEMA = {"obs": ((3,), np.float32), "act": ((), np.int64), "rew": ((1,), np.float32)}


@pytest.mark.parametrize("force_numpy", [False, True])
def test_ring_bit_equal_to_jax(force_numpy):
    ours = hb.HostRingBuffer(SCHEMA, capacity=10, seed=4, force_numpy=force_numpy)
    theirs = jhb.HostRingBuffer(SCHEMA, capacity=10, seed=4, force_numpy=force_numpy)
    assert ours.backend == theirs.backend == ("numpy" if force_numpy else "native")
    with pytest.raises(RuntimeError, match="empty"):
        ours.sample(2)
    rng = np.random.default_rng(0)
    for i in range(9):
        if i % 3:
            item = {"obs": rng.normal(size=(3,)).astype(np.float32), "act": np.int64(i),
                    "rew": np.float32([i])}
        else:  # a batch of 2, wrapping around past 10
            item = {"obs": rng.normal(size=(2, 3)).astype(np.float32), "act": np.arange(2, dtype=np.int64) + i,
                    "rew": np.float32([[i], [i + 1]])}
        ours.add(item)
        theirs.add(item)
        assert len(ours) == len(theirs)
        for got, want in ((ours.sample(5), theirs.sample(5)), (ours.gather(np.arange(len(ours))),
                                                               theirs.gather(np.arange(len(theirs))))):
            for k in SCHEMA:
                np.testing.assert_array_equal(got[k], want[k])
    assert len(ours) == 10


# ---------------------------------------------------------------- policies
@pytest.mark.parametrize("kind", ["tag", "adversary"])
@pytest.mark.parametrize("discrete", [True, False])
@pytest.mark.parametrize("batched", [False, True])
def test_host_pursuit_actions_bit_equal(kind, discrete, batched):
    rng = np.random.default_rng(3)
    lead = (4,) if batched else ()
    pos = rng.uniform(-1.2, 1.2, lead + (5, 2)).astype(np.float32)
    goal = rng.uniform(-1, 1, lead + (2,)).astype(np.float32) if kind == "adversary" else None
    n_adv = 2 if kind == "tag" else 1
    got = host_pursuit_actions(kind, pos, n_adv, np.random.default_rng(7), 0.3, discrete=discrete, goal_pos=goal)
    want = j_host_pursuit_actions(kind, pos, n_adv, np.random.default_rng(7), 0.3, discrete=discrete, goal_pos=goal)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _qnet_file(path, n, d_pad, hidden=8, param_share=True):
    net = JVdnNetwork(action_dim=5, n_agents=n, hidden_dim=hidden, param_share=param_share)
    params = net.init(jax.random.PRNGKey(3), jnp.zeros((1, n, hidden)), jnp.zeros((1, 1, n, d_pad + n)),
                      jnp.zeros((1, 1), bool))
    jcp.save_policy(str(path), params, hidden_dim=hidden, param_share=param_share, action_dim=5, n_agents=n)
    return str(path)


@pytest.mark.parametrize("param_share", [True, False])
def test_host_q_policy_acts_as_jax(tmp_path, param_share):
    agents = ["adversary_0", "adversary_1", "agent_0"]
    dims = {"adversary_0": 6, "adversary_1": 6, "agent_0": 4}
    path = _qnet_file(tmp_path / "q.npz", 3, 6, param_share=param_share)
    ours = cp.HostQCollectPolicy(path, agents, dims, 0.2, np.random.default_rng(1), n_envs=4)
    theirs = jcp.HostQCollectPolicy(path, agents, dims, 0.2, np.random.default_rng(1), n_envs=4)
    rng = np.random.default_rng(2)
    for t in range(6):
        obs = {a: rng.normal(size=(4, d)).astype(np.float32) for a, d in dims.items()}
        np.testing.assert_array_equal(ours.actions(obs), theirs.actions(obs))
        np.testing.assert_allclose(ours._h.numpy(), np.asarray(theirs._h), rtol=1e-6, atol=1e-6)
        if t == 2:
            done = np.array([True, False, True, False])
            ours.reset(done_mask=done)
            theirs.reset(done_mask=done)
            assert not ours._h[torch.from_numpy(done)].any() and ours._h[~torch.from_numpy(done)].any()
    with pytest.raises(ValueError, match="agents"):
        cp.HostQCollectPolicy(path, agents[:2], dims, 0.2, np.random.default_rng(1))


# -------------------------------------------------------------- collectors
TAG = dict(env_name="simple_tag_v3", num_good=1, num_adversaries=2, num_obstacles=1, max_cycles=6)
ADVERSARY = dict(env_name="simple_adversary_v3", num_good=2, num_adversaries=1, num_obstacles=0, max_cycles=6)
WORLD_COMM = dict(env_name="simple_world_comm_v3", num_good=2, num_adversaries=3, num_obstacles=1, max_cycles=6)


def _batched_env(pkg, env_name, num_good, num_adversaries, num_obstacles, max_cycles, n_envs=3):
    kw = dict(n_envs=n_envs, max_steps=max_cycles, seed=2, n_threads=1, auto_reset=False)
    if env_name == "simple_adversary_v3":
        return pkg.NativeSimpleAdversaryEnv(num_good_agents=num_good, **kw)
    if env_name == "simple_world_comm_v3":
        return pkg.NativeSimpleWorldCommEnv(num_good_agents=num_good, num_adversaries=num_adversaries,
                                            num_obs=num_obstacles, **kw)
    return pkg.NativeSimpleTagEnv(num_good_agents=num_good, num_adversaries=num_adversaries,
                                  num_obs=num_obstacles, **kw)


def _collector(adapter, engine, pop, policy, batched):
    env, *_ = adapter.create_env(**pop, seed=2, scripted_policy=policy != "random")
    buf = adapter.MultiAgentHostBuffer(env, max_size=40, batch_size=6, seed=2)
    if batched:
        col = adapter.NativeBatchedCollector(buf, env=_batched_env(engine, **pop), seed=2, collect_policy=policy,
                                             epsilon=0.2, mix_frac=0.5)
    else:
        col = adapter.AsyncCollector(env, buf, seed=2, policy=policy, epsilon=0.2, mix_frac=0.5)
    return buf, col


@pytest.mark.parametrize("pop,policy,batched", [
    (TAG, "random", False), (TAG, "random", True), (TAG, "pursuit", False), (TAG, "pursuit", True),
    (TAG, "episode_mix", False), (TAG, "episode_mix", True), (TAG, "vdn", False), (TAG, "vdn", True),
    (ADVERSARY, "pursuit", False), (ADVERSARY, "pursuit", True), (WORLD_COMM, "random", False),
    (WORLD_COMM, "random", True),
], ids=lambda v: v["env_name"].split("_v3")[0] if isinstance(v, dict) else str(v))
def test_collect_fills_the_ring_as_jax(tmp_path, pop, policy, batched):
    """Synchronous collect(n) past episode ends and the ring's capacity:
    the same rows in the same slots, and the same sample()."""
    if policy == "vdn":
        engine = ne.NativeSimpleTagEnv(num_good_agents=1, num_adversaries=2, num_obs=1)
        policy = "vdn:" + _qnet_file(tmp_path / "q.npz", 3, max(engine.obs_dim_adv, engine.obs_dim_good))
    buf, col = _collector(ha, ne, pop, policy, batched)
    jbuf, jcol = _collector(jha, jne, pop, policy, batched)
    assert col.collect(50) == jcol.collect(50) >= 50
    assert len(buf) == len(jbuf) == 40
    idx = np.arange(40)
    for pair in ((buf.buffer.gather(idx), jbuf.buffer.gather(idx)), (buf.sample(), jbuf.sample())):
        assert list(pair[0]) == list(pair[1])
        for k in pair[1]:
            np.testing.assert_array_equal(pair[0][k], pair[1][k], err_msg=k)
    if pop is WORLD_COMM:  # the leader samples its Discrete(20)
        assert buf.buffer.gather(idx)["leadadversary_0_actions"].max() >= 5


def test_pursuit_refused_where_the_env_has_none():
    env, *_ = ha.create_env(**WORLD_COMM, seed=0, scripted_policy=True)
    buf = ha.MultiAgentHostBuffer(env, max_size=8, batch_size=2)
    with pytest.raises(ValueError, match="no host pursuit policy"):
        ha.AsyncCollector(env, buf, policy="pursuit")
    with pytest.raises(ValueError, match="no host pursuit policy"):
        ha.NativeBatchedCollector(buf, env=_batched_env(ne, **WORLD_COMM), collect_policy="pursuit")
    with pytest.raises(ValueError, match="unknown collect policy"):
        ha.AsyncCollector(env, buf, policy="sticky")


def test_local_env_fallback(monkeypatch):
    """Without the native engine, create_env serves the port's torch envs
    on the CPU, pursuit included."""
    monkeypatch.setattr(ne, "native_engine_available", lambda: False)
    env, obs_dims, act_dims, obs, _ = ha.create_env(**ADVERSARY, seed=3, scripted_policy=True)
    assert isinstance(env, ha.LocalHostEnv)
    assert act_dims == {a: 5 for a in env.agents} and set(obs) == set(env.agents)
    buf = ha.MultiAgentHostBuffer(env, max_size=16, batch_size=4, seed=0)
    col = ha.AsyncCollector(env, buf, seed=0, policy="pursuit")
    col.collect(10)
    assert len(buf) == 10 and np.isfinite(buf.sample()["agent_0_next_observations"]).all()
    kind, pos, n_adv, goal = env.pursuit_inputs()
    assert kind == "adversary" and pos.shape == (3, 2) and goal.shape == (2,)
    assert ha.create_env(**TAG, seed=3)[0].reset(seed=3)[0]["agent_0"].shape == (obs_dims["agent_0"],)


def test_native_build_cache_key_and_failure(tmp_path, monkeypatch):
    """The library's name follows the source, the command and the CPU; a
    failed build returns None (the callers' numpy fallback)."""
    src = native_build.NATIVE_DIR / "ringbuffer.cpp"
    assert native_build.library_path("ringbuffer.cpp").parent == ROOT / "mfvae_tpu_torch" / "build" / "native"
    before = native_build.library_path("ringbuffer.cpp")
    monkeypatch.setattr(native_build, "cpu_model", lambda: "another CPU")
    assert native_build.library_path("ringbuffer.cpp") != before
    monkeypatch.setattr(native_build, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    assert native_build.build_and_load("broken.cpp") is None
    assert native_build.build_and_load("missing.cpp") is None
    assert not list((tmp_path / "build").glob("*.tmp.*"))
    assert src.exists()


# --------------------------------------------------------------- experiment
def _host_cfgs(tmp_path, **train_kw):
    jcfg, cfg = j_tiny_cfg(tmp_path / "jax", **train_kw), tiny_cfg(tmp_path / "port", **train_kw)
    for c in (jcfg, cfg):
        c.env.backend = "host"
        c.buffer.max_size, c.buffer.batch_size = 32, 4
    return jcfg, cfg


def test_one_train_step_on_a_host_batch_matches_jax(tmp_path):
    jcfg, cfg = _host_cfgs(tmp_path)
    jexp, exp = JHostExperiment(jcfg).setup(), HostExperiment(cfg, "cpu").setup()
    assert jexp.collector.collect(40) == exp.collector.collect(40)
    sample, jsample = exp.buffer.sample(), jexp.buffer.sample()
    for k in jsample:
        np.testing.assert_array_equal(sample[k], jsample[k], err_msg=k)
    batch, jbatch = exp.device_batch(sample), jexp._device_batch(jsample)
    for got, want in zip(list(batch.inputs.obs) + list(batch.inputs.actions) + [batch.next_state, batch.rewards],
                         list(jbatch.inputs.obs) + list(jbatch.inputs.actions) + [jbatch.next_state, jbatch.rewards]):
        assert got.numpy().dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ts = exp.train_state
    ts.model.load_state_dict(params_from_jax(jax.device_get(jexp.train_state.params)))
    key = jax.random.PRNGKey(7)
    eps = np.array(jax.random.normal(key, (4, exp.spec.n_agents, cfg.model.obs_features)))
    jstate, jouts = jexp._train_jit(jexp.train_state, jbatch, key)
    _, outs = exp.train_step(ts, batch, eps=torch.from_numpy(eps))
    for name in jouts._fields:
        np.testing.assert_allclose(float(getattr(outs, name)), float(getattr(jouts, name)), rtol=1e-5, err_msg=name)
    want = params_from_jax(jax.device_get(jstate.params))
    got = ts.model.state_dict()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("n_host_envs", [1, 3])
def test_threaded_run(tmp_path, n_host_envs):
    _, cfg = _host_cfgs(tmp_path, epoch_num=2, sample_num=6, train_num=2)
    cfg.env.n_host_envs = n_host_envs
    cfg.model.use_pallas = True  # ignored by the host backend, as in JAX
    exp = HostExperiment(cfg, "cpu").setup()
    assert exp.buffer.buffer.backend == "native"
    want = ha.NativeBatchedCollector if n_host_envs > 1 else ha.AsyncCollector
    assert type(exp.collector) is want and isinstance(exp.env, ne.NativeHostEnv)
    result = exp.run()
    assert np.isfinite(result["loss_train"]) and result["epoch"] == 1
    assert result["host_steps"] >= cfg.train.epoch_num * cfg.train.sample_num
    assert len(result["epoch_wall_s"]) == len(result["collector_wait_s"]) == 2
    assert not exp.collector._thread.is_alive()


def test_dispatch_runs_the_host_backend(tmp_path, monkeypatch):
    """run_experiment sends env.backend='host' to HostExperiment (once
    refused as unported); without a card the default device raises."""
    _, cfg = _host_cfgs(tmp_path, epoch_num=1, sample_num=4, train_num=1)
    result = run_experiment(cfg, "cpu")
    assert "host_steps" in result and np.isfinite(result["loss_train"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_experiment(cfg)


def test_a_dying_collector_fails_the_run(tmp_path, monkeypatch):
    _, cfg = _host_cfgs(tmp_path, epoch_num=3, sample_num=1000, train_num=1)
    exp = HostExperiment(cfg, "cpu").setup()
    calls = []

    def boom():
        calls.append(1)
        if len(calls) > 10:
            raise OSError("env step failed")
        exp.collector._steps += 1

    monkeypatch.setattr(exp.collector, "_one_step", boom)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="collector thread failed") as info:
        exp.run()
    assert time.perf_counter() - t0 < 5.0
    assert isinstance(info.value.__cause__, OSError)


def test_batched_collector_falls_back(tmp_path, monkeypatch, capsys):
    """Where the batched native env cannot be built, the single-env
    collector serves, as in the JAX package."""
    _, cfg = _host_cfgs(tmp_path)
    cfg.env.n_host_envs = 4

    def unavailable(*args, **kwargs):
        raise RuntimeError("native MPE engine unavailable")

    monkeypatch.setattr(HostExperiment, "_make_batched_native_env", unavailable)
    exp = HostExperiment(cfg, "cpu")
    assert type(exp.collector) is ha.AsyncCollector
    assert "falling back" in capsys.readouterr().out


def test_cli_host_backend_on_the_cpu(tmp_path):
    args = [sys.executable, "-m", "mfvae_tpu_torch", str(ROOT / "examples" / "reference_parity.yaml"),
            "env.backend=host", "env.n_host_envs=2", "env.num_good_agents=1", "env.num_adversaries=2",
            "env.num_obs=1", "train.epoch_num=1", "train.sample_num=8", "train.train_num=1",
            "buffer.min_size=4", "buffer.batch_size=4", "model.compute_dtype=float32",
            f"train.log_dir={tmp_path}", "--device", "cpu"]
    proc = subprocess.run(args, cwd=tmp_path, capture_output=True, text=True, timeout=300,
                          env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    result = eval(proc.stdout.strip().splitlines()[-1], {})
    assert result["epoch"] == 0 and result["host_steps"] >= 8
