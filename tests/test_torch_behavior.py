"""Config-driven behavior learning in the port (``mfvae_tpu_torch/behavior.py``
and the ``imagination:`` collect policy), after tests/test_behavior.py.

A tiny simple_tag experiment (the ``tiny_exp`` of tests/test_behavior.py,
float32) trains a 2-epoch world model on the CPU; each algorithm then
trains a few updates through the config surface, saves, loads and serves.
Against the JAX package, on the same params and JAX's own draws:
- the prey-distance and reward scores (rtol 1e-6, atol 1e-6: a sqrt of
  summed squares, rounded in another order);
- a policy that JAX saved (flax msgpack, read here with flax, bridged by
  ``policy_params_from_jax``) serves the same actions in the port;
- the sidecar's keys and values equal JAX's for the same result;
- ``ImaginationCollectPolicy``'s epsilon and hold semantics: the same
  actions and carries step for step, from JAX's draws.
The CLI runs with ``--device cpu`` and refuses to run without a card by
default.
"""

import copy
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfvae_tpu import behavior as jbehavior
from mfvae_tpu import imagination as jimag
from mfvae_tpu.config import ExperimentConfig as JExperimentConfig
from mfvae_tpu.envs.policies import ImaginationCollectPolicy as JImaginationCollectPolicy
from mfvae_tpu_torch import behavior
from mfvae_tpu_torch.config import ExperimentConfig
from mfvae_tpu_torch.envs.policies import CollectNoise, ImaginationCollectPolicy
from mfvae_tpu_torch.imagination import ActorNoise, PolicyMLP, make_obs_builder, make_policy_actor
from mfvae_tpu_torch.training.experiment import Experiment
from mfvae_tpu_torch.training.trainer import make_action_sampler
from tests.test_torch_experiment import one_torch_thread  # noqa: F401
from tests.test_torch_imagination import bridge
from tests.test_torch_planning import Setup, t

REPO = Path(__file__).resolve().parents[1]
TINY = {
    "env.num_good_agents": 1, "env.num_adversaries": 2, "env.num_obs": 1, "env.max_steps": 16,
    "model.idx_features": 8, "model.obs_features": 8, "model.action_features": 8,
    "model.encoder_hidden": (16,), "model.decoder_hidden": (32,), "model.compute_dtype": "float32",
    "buffer.max_size": 256, "buffer.min_size": 16, "buffer.batch_size": 16,
    "train.epoch_num": 2, "train.sample_num": 16, "train.train_num": 1, "train.test_num": 1,
    "behavior.updates": 3, "behavior.start_pool": 8, "behavior.start_burn_in": 2, "behavior.n_starts": 4,
    "behavior.n_rollouts": 2, "behavior.m_rollouts": 2, "behavior.horizon": 2, "behavior.visit_steps": 1,
    "behavior.hidden": (8,),
}


def tiny_cfg(tmp, cls=ExperimentConfig):
    cfg = cls()
    for path, value in TINY.items():
        section, name = path.split(".")
        setattr(getattr(cfg, section), name, value)
    cfg.train.log_dir = str(tmp)
    cfg.train.run_name = "tiny_behavior"
    cfg.train.checkpoint_dir = ""
    return cfg


@pytest.fixture(scope="module")
def tiny_exp(tmp_path_factory):
    exp = Experiment(tiny_cfg(tmp_path_factory.mktemp("behavior_logs")), device="cpu").setup()
    exp.run()
    return exp


def save(tiny_exp, result, path, obs_dim=None):
    bcfg = tiny_exp.cfg.behavior
    if obs_dim is None:
        obs_dim = make_obs_builder(tiny_exp.spec, result.plan_agents, bcfg.centralized)[1]
    behavior.save_policy(str(path), result, bcfg, obs_dim=obs_dim, act_dim=int(tiny_exp.spec.act_dims[0]))


# ------------------------------------------------------------------- config
def test_plan_agents_resolution(tiny_exp):
    bcfg = copy.deepcopy(tiny_exp.cfg.behavior)
    assert behavior.resolve_plan_agents(tiny_exp, bcfg) == (0, 1)
    bcfg.plan_agents = "all"
    assert behavior.resolve_plan_agents(tiny_exp, bcfg) == (0, 1, 2)


@pytest.mark.parametrize("field,bad", [("algo", "ppo"), ("plan_agents", "prey"), ("score", "novelty"),
                                       ("continuation", "cem")])
def test_validate_rejects_bad_choices(field, bad):
    cfg = ExperimentConfig()
    setattr(cfg.behavior, field, bad)
    with pytest.raises(ValueError):
        cfg.validate()


def test_validate_accepts_imagination_and_rejects_unknown():
    cfg = ExperimentConfig()
    cfg.train.collect_policy = "imagination:/tmp/x.pt"
    cfg.validate()
    cfg.train.collect_policy = "dreamer:/tmp/x"
    with pytest.raises(ValueError):
        cfg.validate()


# ------------------------------------------------------------------- scores
@pytest.mark.parametrize("score", ["prey_distance", "reward"])
def test_scores_match_jax(tiny_exp, score):
    bcfg = copy.deepcopy(tiny_exp.cfg.behavior)
    bcfg.score = score
    jcfg = tiny_cfg("/nonexistent", JExperimentConfig)
    jexp = SimpleNamespace(cfg=jcfg, spec=Setup().jspec)
    jterminal, jstep = jbehavior.make_behavior_scores(jexp, bcfg, (0, 1))
    terminal, step = behavior.make_behavior_scores(tiny_exp, bcfg, (0, 1))
    rng = np.random.default_rng(0)
    states = rng.normal(size=(3, 5, sum(tiny_exp.spec.obs_dims))).astype(np.float32)
    rewards = rng.normal(size=(3, 5, 3)).astype(np.float32)
    for fn, jfn in ((terminal, jterminal), (step, jstep)):
        np.testing.assert_allclose(fn(t(states), t(rewards)).numpy(), np.asarray(jfn(states, rewards)),
                                   rtol=1e-6, atol=1e-6)


def test_prey_distance_matches_hand_slice(tiny_exp):
    terminal, step = behavior.make_behavior_scores(tiny_exp, tiny_exp.cfg.behavior, (0, 1))
    states = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 5, 34)).astype(np.float32))
    out, s = terminal(states, torch.zeros(3, 5, 3)), step(states, torch.zeros(3, 5, 3))
    assert tuple(out.shape) == (5, 2) and tuple(s.shape) == (3, 5, 2)
    torch.testing.assert_close(out, s.sum(0), rtol=1e-5, atol=1e-6)
    off = 4 + 2 * 1 + 2 * 1  # vel+pos, 1 obstacle, 1 other adversary
    rel = states[0, :, :12][:, off:off + 2]
    torch.testing.assert_close(-s[0, :, 0], torch.sqrt((rel ** 2).sum(-1) + 1e-12), rtol=1e-5, atol=1e-6)


def test_score_and_algo_guards(tiny_exp):
    bcfg = copy.deepcopy(tiny_exp.cfg.behavior)
    with pytest.raises(ValueError, match="non-adversary"):
        behavior.make_behavior_scores(tiny_exp, bcfg, (0, 1, 2))
    spread = SimpleNamespace(cfg=copy.deepcopy(tiny_exp.cfg), spec=tiny_exp.spec)
    spread.cfg.env.name = "MPE_simple_spread_v3"
    with pytest.raises(ValueError, match="simple_tag objective"):
        behavior.make_behavior_scores(spread, bcfg, (0, 1))
    continuous = SimpleNamespace(cfg=copy.deepcopy(tiny_exp.cfg))
    continuous.cfg.env.discrete_actions = False
    with pytest.raises(ValueError, match="discrete actions"):
        behavior.train_behavior(continuous)


# -------------------------------------------------------------- start pool
@pytest.mark.parametrize("cp", ["random", "pursuit", "sticky", "episode_mix", "vdn:unused.npz"])
def test_start_pool_for_each_collect_policy(tiny_exp, cp):
    exp = copy.copy(tiny_exp)
    exp.cfg = copy.deepcopy(tiny_exp.cfg)
    exp.cfg.train.collect_policy = cp
    pool = behavior.collect_start_states(exp, exp.cfg.behavior)
    assert [tuple(o.shape) for o in pool] == [(8, 2, 12), (8, 1, 10)]
    assert all(bool(torch.isfinite(o).all()) for o in pool)
    again = behavior.collect_start_states(exp, exp.cfg.behavior)
    assert all(torch.equal(a, b) for a, b in zip(pool, again))  # seeded (4242)


# ----------------------------------------------------------- train and serve
@pytest.mark.parametrize("algo", ["reinforce", "actor_critic", "distill"])
def test_each_algo_trains_saves_and_serves(tiny_exp, algo, tmp_path):
    exp = copy.copy(tiny_exp)
    exp.cfg = copy.deepcopy(tiny_exp.cfg)
    exp.cfg.behavior.algo = algo
    result = behavior.train_behavior(exp, torch.Generator().manual_seed(0))
    assert [c["update"] for c in result.curve] == [0, 2]
    assert all(np.isfinite(v) for c in result.curve for v in c.values())
    assert (result.aux_params is not None) == (algo == "actor_critic")
    path = tmp_path / f"{algo}.pt"
    save(exp, result, path)
    policy, meta = behavior.load_policy(str(path), device="cpu")
    assert meta["algo"] == algo
    for name, p in result.policy.state_dict().items():
        torch.testing.assert_close(policy.state_dict()[name], p, rtol=0, atol=0)
    obs, _ = exp.env.reset_stacked(torch.Generator().manual_seed(3))
    for greedy in (True, False):
        want = make_policy_actor(result.policy, exp.env, exp.spec, result.plan_agents, greedy)
        got = make_policy_actor(policy, exp.env, exp.spec, result.plan_agents, greedy)
        acts = got(obs, torch.Generator().manual_seed(4))
        assert torch.equal(acts, want(obs, torch.Generator().manual_seed(4)))
        assert tuple(acts.shape) == (3,) and bool((acts >= 0).all())


def test_train_behavior_takes_its_pool_and_rows(tiny_exp):
    exp = copy.copy(tiny_exp)
    exp.cfg = copy.deepcopy(tiny_exp.cfg)
    exp.cfg.behavior.algo = "reinforce"
    pool = behavior.collect_start_states(exp, exp.cfg.behavior, torch.Generator().manual_seed(5))
    rows = [torch.tensor([0, 1, 2, 3])] * 3
    a = behavior.train_behavior(exp, torch.Generator().manual_seed(6), pool=pool, rows=rows)
    b = behavior.train_behavior(exp, torch.Generator().manual_seed(6), pool=pool, rows=rows)
    assert a.curve == b.curve
    for (name, p), q in zip(a.policy.state_dict().items(), b.policy.state_dict().values()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=name)


def test_centralized_trains_saves_and_serves(tiny_exp, tmp_path):
    exp = copy.copy(tiny_exp)
    exp.cfg = copy.deepcopy(tiny_exp.cfg)
    exp.cfg.behavior.algo = "distill"
    exp.cfg.behavior.centralized = True
    result = behavior.train_behavior(exp, torch.Generator().manual_seed(0))
    _, obs_dim = make_obs_builder(exp.spec, result.plan_agents, centralized=True)
    assert obs_dim == 12 + 34
    save(exp, result, tmp_path / "central.pt")
    policy, meta = behavior.load_policy(str(tmp_path / "central.pt"), device="cpu")
    assert meta["centralized"] is True and meta["obs_dim"] == obs_dim
    actor = make_policy_actor(policy, exp.env, exp.spec, result.plan_agents, centralized=True)
    obs, _ = exp.env.reset_stacked(torch.Generator().manual_seed(3))
    assert tuple(actor(obs, torch.Generator().manual_seed(4)).shape) == (3,)


def test_eval_returns_policy_and_random(tiny_exp):
    exp = copy.copy(tiny_exp)
    exp.cfg = copy.deepcopy(tiny_exp.cfg)
    exp.cfg.behavior.algo = "reinforce"
    result = behavior.train_behavior(exp, torch.Generator().manual_seed(0))
    out = behavior.eval_returns(exp, result, episodes=3, ep_len=5)
    assert sorted(out) == sorted(f"eval_{a}_return_{s}" for a in ("policy", "random") for s in ("mean", "sem"))
    assert all(np.isfinite(v) for v in out.values())


# ------------------------------------------------------------- policy files
def _jax_result(hidden=(8,)):
    jnet = jimag.PolicyMLP(hidden=hidden, act_dim=5)
    jparams = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 12)))
    return jbehavior.BehaviorResult(jnet, jparams, None, (0, 1), [])


def test_sidecar_keys_and_values_equal_jaxs(tiny_exp, tmp_path):
    jres = _jax_result()
    bcfg = tiny_exp.cfg.behavior
    jbehavior.save_policy(str(tmp_path / "j.msgpack"), jres, bcfg, obs_dim=12, act_dim=5)
    net = PolicyMLP(12, (8,), 5)
    net.load_state_dict(bridge(jres.params))
    behavior.save_policy(str(tmp_path / "t.pt"), behavior.BehaviorResult(net, None, (0, 1), []), bcfg,
                         obs_dim=12, act_dim=5)
    jmeta = json.loads((tmp_path / "j.msgpack.json").read_text())
    tmeta = json.loads((tmp_path / "t.pt.json").read_text())
    assert tmeta == jmeta
    assert tmeta["plan_agents"] == [0, 1] and tmeta["hidden"] == [8]


def test_a_policy_jax_saved_serves_the_same_actions(tmp_path):
    """JAX writes flax msgpack; this test reads it with flax, bridges it
    and serves it in the port, greedy and under JAX's draws."""
    s = Setup()
    bcfg = JExperimentConfig().behavior
    bcfg.hidden = (16,)
    jbehavior.save_policy(str(tmp_path / "pol.msgpack"), _jax_result((16,)), bcfg, obs_dim=12, act_dim=5)
    jpolicy, jparams, meta = jbehavior.load_policy(str(tmp_path / "pol.msgpack"))
    net = PolicyMLP(meta["obs_dim"], tuple(meta["hidden"]), meta["act_dim"])
    net.load_state_dict(bridge(jparams))
    for greedy in (True, False):
        jact = jimag.make_policy_actor(jpolicy, jparams, s.jenv, s.jspec, tuple(meta["plan_agents"]), greedy)
        tact = make_policy_actor(net, s.tenv, s.tspec, tuple(meta["plan_agents"]), greedy)
        for seed in range(3):
            jobs, _, tobs, _ = s.start(50 + seed)
            key = jax.random.PRNGKey(60 + seed)
            k_p, k_o = jax.random.split(key)
            noise = ActorNoise(t(jax.random.gumbel(k_p, (2, 5))), t(s.jsample(k_o)))
            np.testing.assert_array_equal(tact(tobs, noise=noise).numpy(), np.asarray(jact(jobs, key)))


# ------------------------------------------------------ imagination collection
def _collect_noise(s, actor_key_parts):
    k_pol, k_hold, k_eps, k_rand = actor_key_parts
    k_p, k_o = jax.random.split(k_pol)
    return CollectNoise(
        rand=t(s.jsample(k_rand)),
        eps=t(jax.random.uniform(k_eps, (3,))),
        hold=t(jax.random.uniform(k_hold, (3,))),
        actor=ActorNoise(t(jax.random.gumbel(k_p, (2, 5))), t(s.jsample(k_o))),
    )


@pytest.mark.parametrize("epsilon,hold", [(0.0, 0.0), (0.3, 0.0), (0.0, 0.6), (0.3, 0.6)])
def test_imagination_collect_policy_matches_jax(tmp_path, epsilon, hold):
    s = Setup()
    bcfg = JExperimentConfig().behavior
    bcfg.hidden = (16,)
    jres = _jax_result((16,))
    jbehavior.save_policy(str(tmp_path / "pol.msgpack"), jres, bcfg, obs_dim=12, act_dim=5)
    net = PolicyMLP(12, (16,), 5)
    net.load_state_dict(bridge(jres.params))
    behavior.save_policy(str(tmp_path / "pol.pt"), behavior.BehaviorResult(net, None, (0, 1), []), bcfg,
                         obs_dim=12, act_dim=5)
    jpol = JImaginationCollectPolicy(s.jenv, s.jspec, str(tmp_path / "pol.msgpack"), epsilon, s.jsample, hold)
    tpol = ImaginationCollectPolicy(s.tenv, s.tspec, str(tmp_path / "pol.pt"), epsilon, s.tsample, hold)
    jobs, jstate, tobs, tstate = s.start(70)
    jc, tc = jpol.init_carry(), tpol.init_carry()
    for step in range(6):
        key = jax.random.PRNGKey(80 + step)
        jc, jact = jpol.step(jc, jobs, jstate, key)
        tc, tact = tpol.step(tc, tobs, tstate, None, noise=_collect_noise(s, jax.random.split(key, 4)))
        np.testing.assert_array_equal(tact.numpy(), np.asarray(jact), err_msg=f"step {step}")
        np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc[0]))
        assert bool(tc[1]) == bool(jc[1]) is False


def test_imagination_collect_policy_at_epsilon_one_is_the_samplers_draw(tiny_exp, tmp_path):
    net = PolicyMLP(12, (8,), 5, generator=torch.Generator().manual_seed(0))
    save(tiny_exp, behavior.BehaviorResult(net, None, (0, 1), []), tmp_path / "p.pt")
    sample = make_action_sampler(tiny_exp.env, tiny_exp.spec)[0]
    pol = ImaginationCollectPolicy(tiny_exp.env, tiny_exp.spec, str(tmp_path / "p.pt"), 1.0, sample, hold=0.5)
    obs, state = tiny_exp.env.reset_stacked(torch.Generator().manual_seed(1), batch_shape=(4,))
    carry = pol.init_carry((4,))
    _, act = pol.step(carry, obs, state, torch.Generator().manual_seed(2))
    want = sample(torch.Generator().manual_seed(2), (4,))
    assert torch.equal(act, want)  # fresh carry: no hold at an episode's first step


@pytest.mark.parametrize("n_envs", [1, 2])
def test_collect_policy_closes_the_dreamer_loop(tiny_exp, tmp_path, n_envs):
    """Save a behavior policy, then train a fresh experiment collecting
    with collect_policy='imagination:<path>'."""
    exp = copy.copy(tiny_exp)
    exp.cfg = copy.deepcopy(tiny_exp.cfg)
    exp.cfg.behavior.algo = "reinforce"
    result = behavior.train_behavior(exp, torch.Generator().manual_seed(5))
    path = tmp_path / "iter_pol.pt"
    save(exp, result, path)
    cfg = copy.deepcopy(tiny_exp.cfg)
    cfg.train.collect_policy = f"imagination:{path}"
    cfg.train.collect_epsilon = 0.1
    cfg.train.n_envs = n_envs
    cfg.train.log_dir = str(tmp_path / "logs")
    cfg.train.run_name = "imag_collect"
    exp2 = Experiment(cfg, device="cpu").setup()
    out = exp2.run()
    assert np.isfinite(out["loss_train"]) and np.isfinite(out["loss_test"])
    assert int(exp2.carry.buffer_state.size) >= cfg.train.sample_num * cfg.train.epoch_num // n_envs
    prev, fresh = exp2.carry.env.policy
    assert tuple(prev.shape) == ((n_envs,) if n_envs > 1 else ()) + (3,)


# ---------------------------------------------------------------------- CLI
def _cli_args(tmp_path):
    args = [f"{k}={','.join(map(str, v)) if isinstance(v, tuple) else v}" for k, v in TINY.items()]
    return [str(REPO / "examples" / "behavior_policy.yaml"), *args,
            "model.det_features=8", "train.epoch_num=1", "train.epochs_per_dispatch=1",
            f"train.log_dir={tmp_path}/logs", f"train.checkpoint_dir={tmp_path}/ckpt",
            f"behavior.save_path={tmp_path}/pol.pt", "behavior.eval_episodes=2", "behavior.eval_ep_len=4"]


def test_cli_runs_on_the_cpu_when_asked(tmp_path):
    env = dict(os.environ, PYTHONPATH=f"{REPO}{os.pathsep}" + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "mfvae_tpu_torch.behavior", *_cli_args(tmp_path), "--device", "cpu"],
                          capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"algo", "updates", "plan_agents", "final", "save_path", "eval_policy_return_mean",
            "eval_policy_return_sem", "eval_random_return_mean", "eval_random_return_sem"} <= set(out)
    assert out["algo"] == "distill" and out["plan_agents"] == 2
    assert (tmp_path / "pol.pt").exists() and (tmp_path / "pol.pt.json").exists()


def test_cli_raises_without_a_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        behavior.main(_cli_args(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        behavior.load_policy(str(tmp_path / "absent.pt"))  # the device is checked before any file is read
