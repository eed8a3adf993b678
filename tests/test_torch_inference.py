"""Serving (``inference.WorldModel``) and imagination accuracy
(``rollout_eval``) of the port against the JAX package.

- ``predict`` and ``encode`` against JAX's ``WorldModel`` with the same
  parameters (the world-model options, grouped order unlike agent order),
  on grouped and dict inputs: rtol 1e-5 / atol 1e-6.  ``rollout`` over
  T = 5 steps, from a dict plan and a grouped one: rtol 1e-4 / atol 1e-5
  (the feedback compounds the rounding).
- ``sample`` with zero eps is ``predict``, bit for bit.
- ``from_checkpoint`` after a tiny run gives the trained model's
  ``mean_call`` bit for bit, and defaults to the card.
- ``flatten_global_state`` exact.
- ``score`` on given trajectories against JAX's ``wm._rollout`` and
  ``huber`` per horizon: rtol 1e-5.
- ``ground_truth`` under pursuit at epsilon 0 from an injected start state
  against the JAX env and policy stepped by hand: actions exact,
  observations and rewards within atol 1e-5 (the env tolerance of
  tests/test_torch_env.py).
- ``rollout_accuracy`` under random, pursuit and sticky collection gives
  every metric finite.
- The rollout's CUDA graphs: on the CPU ``_rollout`` runs eagerly and
  counts its steps; with the capture replaced by running the step
  (``_EagerStepGraph``), the graphed path's bookkeeping (capture on a
  key's second request, replays, eviction of the oldest of
  ``GRAPH_KEYS``, a new key for a replaced parameter) and its copies give
  the eager loop's outputs bit for bit, on a bf16 model through its cast
  store (one refresh a graphed request, an update in place read; discrete
  and continuous, two horizons).  The store holds the ``Dense`` and
  ``StackedDense`` kernels and biases of ``examples/world_model.yaml``
  (42) in bf16, and no LayerNorm or embedding parameter; a float32 model
  has none.  The card's own graphs are tested in
  ``tests/test_torch_cuda.py``.
- The agent-index buffers of ``MAVAE``: out of the state dict, and
  ``encode``/``_add_action_delta`` give the values of the ids built from
  host lists, bit for bit.

Float32 on both sides, JAX matmul precision "highest".
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfvae_tpu.config import ModelConfig as JModelConfig
from mfvae_tpu.envs import policies as jpol
from mfvae_tpu.envs.mpe import MPEState as JState
from mfvae_tpu.envs.mpe import SimpleTagEnv as JEnv
from mfvae_tpu.inference import WorldModel as JWorldModel
from mfvae_tpu.models.losses import huber as j_huber
from mfvae_tpu.models.mavae import GroupedBatch as JBatch
from mfvae_tpu.models.mavae import MAVAE as JMAVAE
from mfvae_tpu.rollout_eval import flatten_global_state as j_flatten
from mfvae_tpu.training.experiment import build_spec as j_build_spec
from mfvae_tpu.training.trainer import make_action_sampler as j_make_action_sampler
from mfvae_tpu_torch import inference
from mfvae_tpu_torch.config import ModelConfig, load_config
from mfvae_tpu_torch.envs.mpe import MPEState as TState
from mfvae_tpu_torch.envs.mpe import SimpleTagEnv as TEnv
from mfvae_tpu_torch.inference import WorldModel
from mfvae_tpu_torch.models.convert import params_from_jax
from mfvae_tpu_torch.models.layers import Embedding, LayerNorm, StackedEmbedding
from mfvae_tpu_torch.models.mavae import MAVAE, AgentSpec, GroupedBatch, agent_order_concat
from mfvae_tpu_torch.rollout_eval import flatten_global_state, ground_truth, rollout_accuracy, score
from mfvae_tpu_torch.training.experiment import Experiment, build_spec
from tests.test_torch_experiment import one_torch_thread  # noqa: F401
from mfvae_tpu_torch.utils import profiling
from tests.test_torch_options import EXAMPLES, OPTIONS, tiny
from tests.test_torch_options import build as build_options
from tests.test_torch_unroll import AGENTS, OBS, SMALL, build

B, T = 4, 5


def _batch(jspec, seed, b=B):
    rng = np.random.default_rng(seed)
    obs = [rng.normal(size=(b, len(i), od)).astype(np.float32) for (od, _), i in jspec.groups]
    act = [rng.integers(0, 5, size=(b, len(i))).astype(np.int32) for _, i in jspec.groups]
    return (JBatch(tuple(map(jnp.asarray, obs)), tuple(map(jnp.asarray, act))),
            GroupedBatch(tuple(map(torch.from_numpy, obs)), tuple(map(torch.from_numpy, act))))


def _as_dicts(spec, batch):
    obs, act = {}, {}
    for g, (_, idxs) in enumerate(spec.groups):
        for pos, i in enumerate(idxs):
            obs[spec.agents[i]] = batch.obs[g][:, pos].numpy()
            act[spec.agents[i]] = batch.actions[g][:, pos].numpy()
    return obs, act


def close(t, j, rtol, atol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def test_predict_and_encode_match_jax():
    jspec, tspec, jmodel, variables, tmodel = build()
    jwm, twm = JWorldModel(jmodel, variables), WorldModel(tmodel)
    jb, tb = _batch(jspec, 0)
    for t, j in zip(twm.predict(tb, None), jwm.predict(jb, None)):
        close(t, j, 1e-5, 1e-6)
    for t, j in zip(twm.encode(tb, None), jwm.encode(jb, None)):
        close(t, j, 1e-5, 1e-6)
    obs, act = _as_dicts(tspec, tb)
    for t, j in zip(twm.predict(obs, act), jwm.predict(obs, act)):
        close(t, j, 1e-5, 1e-6)


def test_rollout_matches_jax_from_dict_and_grouped_plans():
    jspec, tspec, jmodel, variables, tmodel = build()
    jwm, twm = JWorldModel(jmodel, variables), WorldModel(tmodel)
    jb, tb = _batch(jspec, 1)
    rng = np.random.default_rng(2)
    plan = {a: rng.integers(0, 5, size=(T, B)).astype(np.int32) for a in tspec.agents}
    want = jwm.rollout(jb, plan)
    got = twm.rollout(tb, plan)
    for t, j in zip(got, want):
        assert tuple(t.shape) == tuple(j.shape)
        close(t, j, 1e-4, 1e-5)
    grouped = tuple(torch.from_numpy(np.stack([plan[tspec.agents[i]] for i in idxs], axis=2))
                    for _, idxs in tspec.groups)
    for t, u in zip(twm.rollout(tb, grouped), got):
        torch.testing.assert_close(t, u, rtol=0, atol=0)
    # an unbatched plan per agent is a batch of one
    one = {a: p[:, 0] for a, p in plan.items()}
    obs, _ = _as_dicts(tspec, tb)
    states, rewards = twm.rollout({a: o[:1] for a, o in obs.items()}, one)
    assert tuple(states.shape) == (T, 1, sum(tspec.obs_dims)) and tuple(rewards.shape) == (T, 1, 3)
    # the same rows, up to the rounding of a one-row GEMM against a four-row one
    torch.testing.assert_close(states[:, 0], got[0][:, 0], rtol=1e-5, atol=1e-5)


def test_sample_with_zero_eps_is_predict():
    jspec, _, _, _, tmodel = build()
    _, tb = _batch(jspec, 3)
    wm = WorldModel(tmodel)
    states, rewards = wm.sample(tb, None, n=2, eps=torch.zeros(2, B, 3, 8))
    pred = wm.predict(tb, None)
    for i in range(2):
        torch.testing.assert_close(states[i], pred[0], rtol=0, atol=0)
        torch.testing.assert_close(rewards[i], pred[1], rtol=0, atol=0)
    drawn, _ = wm.sample(tb, None, torch.Generator().manual_seed(0), n=3)
    assert tuple(drawn.shape) == (3, B, 16) and not torch.equal(drawn[0], drawn[1])


def test_from_checkpoint_is_the_trained_model(tmp_path, monkeypatch):
    cfg = tiny(load_config(str(EXAMPLES / "world_model_control.yaml")), tmp_path)
    cfg.train.unroll_steps = 4
    cfg.train.checkpoint_dir = str(tmp_path / "ckpt")
    exp = Experiment(cfg, device="cpu").setup()
    exp.run()
    wm = WorldModel.from_checkpoint(cfg.train.checkpoint_dir, cfg.model, exp.spec, device="cpu")
    batch = exp.buffer.sample(exp.carry.buffer_state, torch.Generator().manual_seed(0)).experience
    inputs = GroupedBatch(batch.obs, batch.actions)
    with torch.no_grad():
        want = exp.carry.train_state.model.mean_call(inputs)
    for t, u in zip(wm.predict(inputs, None), want):
        torch.testing.assert_close(t, u, rtol=0, atol=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WorldModel.from_checkpoint(cfg.train.checkpoint_dir, cfg.model, exp.spec)


POP = dict(num_good_agents=2, num_adversaries=3, num_obs=2)


def _env_model(seed=0):
    jenv, tenv = JEnv(**POP), TEnv(device="cpu", **POP)
    jspec, tspec = j_build_spec(jenv), build_spec(tenv)
    jmodel = JMAVAE.from_config(JModelConfig(**SMALL), jspec)
    tmodel = MAVAE.from_config(ModelConfig(**SMALL), tspec, device="cpu")
    jb, _ = _batch(jspec, seed)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(seed), jb, None, jax.random.PRNGKey(1)))
    tmodel.load_state_dict(params_from_jax(variables), strict=True)
    return jenv, tenv, jspec, tspec, jmodel, variables, tmodel


def test_flatten_global_state_is_exact():
    _, _, jspec, tspec, *_ = _env_model()
    rng = np.random.default_rng(4)
    groups = [rng.normal(size=(T, B, len(i), od)).astype(np.float32) for (od, _), i in jspec.groups]
    np.testing.assert_array_equal(flatten_global_state(tspec, tuple(map(torch.from_numpy, groups))).numpy(),
                                  np.asarray(j_flatten(jspec, tuple(map(jnp.asarray, groups)))))


def _injected(n, seed):
    rng = np.random.default_rng(seed)
    a = POP["num_good_agents"] + POP["num_adversaries"]
    pos = rng.uniform(-1, 1, (n, a, 2)).astype(np.float32)
    vel = rng.uniform(-0.3, 0.3, (n, a, 2)).astype(np.float32)
    lm = rng.uniform(-0.9, 0.9, (n, POP["num_obs"], 2)).astype(np.float32)
    return pos, vel, lm


def test_score_matches_jax():
    jenv, tenv, jspec, tspec, jmodel, variables, tmodel = _env_model()
    start_obs, actions, rewards, next_obs = ground_truth(tenv, tspec, torch.Generator().manual_seed(5), T,
                                                         n_starts=B, burn_in=3, policy="pursuit")
    horizons = (1, 3, 5)
    got = score(WorldModel(tmodel), tspec, start_obs, actions, rewards, next_obs, horizons)
    jwm = JWorldModel(jmodel, variables)
    obs0 = tuple(jnp.asarray(x.numpy()) for x in start_obs)
    plan = tuple(jnp.asarray(actions[:, :, list(i)].numpy()) for _, i in jspec.groups)
    pred_s, pred_r = jwm._rollout(obs0, plan)
    gt_s = j_flatten(jspec, tuple(jnp.asarray(x.numpy()) for x in next_obs))
    gt_r, s0 = jnp.asarray(rewards.numpy()), j_flatten(jspec, obs0)
    for k in horizons:
        i = k - 1
        want = {
            "state_huber": j_huber(pred_s[i], gt_s[i]), "reward_huber": j_huber(pred_r[i], gt_r[i]),
            "state_huber_frozen": j_huber(s0, gt_s[i]), "reward_huber_zero": j_huber(jnp.zeros_like(gt_r[i]), gt_r[i]),
            "state_huber_persist": j_huber(gt_s[i - 1] if i else s0, gt_s[i]),
        }
        for name, w in want.items():
            np.testing.assert_allclose(float(got[f"{name}/{k}"]), float(w), rtol=1e-5, err_msg=f"{name}/{k}")


def test_ground_truth_under_pursuit_matches_the_jax_env():
    jenv, tenv, jspec, tspec, *_ = _env_model()
    n, burn_in = 3, 4
    pos, vel, lm = _injected(n, 6)
    tstate = TState(torch.from_numpy(pos), torch.from_numpy(vel), torch.from_numpy(lm), torch.zeros(n, dtype=torch.int32))
    start_obs, actions, rewards, next_obs = ground_truth(
        tenv, tspec, torch.Generator().manual_seed(0), T, n_starts=n, burn_in=burn_in, policy="pursuit",
        collect_epsilon=0.0, start=(tenv._observe(tstate), tstate))
    jsample, _ = j_make_action_sampler(jenv, jspec)
    policy = jpol.make_collect_policy(jenv, jspec, "pursuit", 0.0, jsample)
    for e in range(n):
        st = JState(jnp.asarray(pos[e]), jnp.asarray(vel[e]), jnp.asarray(lm[e]), jnp.int32(0))
        for t in range(burn_in + T):
            if t == burn_in:
                for a, b in zip(start_obs, jenv._observe(st)):
                    np.testing.assert_allclose(a[e].numpy(), np.asarray(b), atol=1e-5, rtol=0)
            act = policy(st, jax.random.PRNGKey(t))
            obs, st, rew, _, _ = jenv.step_stacked(None, st, act)
            if t >= burn_in:
                np.testing.assert_array_equal(actions[t - burn_in, e].numpy(), np.asarray(act))
                np.testing.assert_allclose(rewards[t - burn_in, e].numpy(), np.asarray(rew), atol=1e-5, rtol=0)
                for a, b in zip(next_obs, obs):
                    np.testing.assert_allclose(a[t - burn_in, e].numpy(), np.asarray(b), atol=1e-5, rtol=0)


@pytest.mark.parametrize("policy", ["random", "pursuit", "sticky"])
def test_rollout_accuracy_is_finite(policy):
    _, tenv, _, tspec, _, _, tmodel = _env_model()
    out = rollout_accuracy(WorldModel(tmodel), tenv, tspec, torch.Generator().manual_seed(1),
                           horizons=(1, 5, 25), n_starts=8, burn_in=4, policy=policy)
    assert len(out) == 15 and all(math.isfinite(v) for v in out.values())
    assert out["state_huber_persist/1"] == out["state_huber_frozen/1"]


def _grouped_plan(tspec, seed, t=T, b=B):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.integers(0, 5, size=(t, b, len(i))).astype(np.int32)) for _, i in tspec.groups)


def test_rollout_on_the_cpu_runs_eagerly_and_counts_its_steps():
    jspec, tspec, _, _, tmodel = build()
    wm = WorldModel(tmodel)
    _, tb = _batch(jspec, 5)
    plan = _grouped_plan(tspec, 6)
    profiling.reset_counters()
    for _ in range(3):
        wm._rollout(tb.obs, plan)
    assert profiling.counters() == {"rollout.eager_steps": 3 * T}
    assert not wm._graphs and not wm._seen


class _EagerStepGraph(inference._StepGraph):
    """The step graph with its capture replaced by running the step: a
    replay runs it again, so the graphed path runs on the CPU."""

    def _capture(self):
        for buf in self.obs + self.act:
            buf.zero_()
        self.step()
        self.graph = types.SimpleNamespace(replay=self.step)


@pytest.fixture
def eager_graphs(monkeypatch):
    monkeypatch.setattr(WorldModel, "GRAPH_DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(inference, "_StepGraph", _EagerStepGraph)
    profiling.reset_counters()


def _eager(model, obs, plan):
    """The eager loop's rollout (a new WorldModel serves a key's first
    request eagerly)."""
    return WorldModel(model)._rollout(obs, plan)


def _equal(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _bf16(build_out):
    """``build()``'s model computing in bf16, on the same parameters: the
    graphed path then runs on a cast store."""
    jspec, tspec, _, variables, _ = build_out
    tmodel = MAVAE.from_config(ModelConfig(**{**SMALL, "compute_dtype": "bfloat16"}), tspec, device="cpu")
    tmodel.load_state_dict(params_from_jax(variables), strict=True)
    return jspec, tspec, tmodel


CAST = "rollout.cast_refreshes"


def test_graphed_path_replays_the_eager_loop(eager_graphs):
    jspec, tspec, tmodel = _bf16(build())
    wm = WorldModel(tmodel)
    (_, a), (_, b) = _batch(jspec, 7), _batch(jspec, 8)
    # views of other strides, as the planners pass them
    obs_a = tuple(o.transpose(0, 1).contiguous().transpose(0, 1) for o in a.obs)
    plan_a, plan_b = _grouped_plan(tspec, 9), _grouped_plan(tspec, 10)
    plan_a = tuple(torch.cat([p, p], dim=-1)[..., ::2] for p in plan_a)
    first = wm._rollout(obs_a, plan_a)  # eager: the key's first request
    assert profiling.counters() == {"rollout.eager_steps": T}
    second = wm._rollout(obs_a, plan_a)  # captures, then replays
    assert profiling.counters() == {"rollout.eager_steps": T, "rollout.graph_captures": 1, "rollout.graph_replays": T,
                                    CAST: 1}
    _equal(first, second)
    kept = tuple(x.clone() for x in second)
    got_b = wm._rollout(b.obs, plan_b)
    _equal(got_b, _eager(tmodel, b.obs, plan_b))
    _equal(second, kept)  # a request's outputs are its own
    _equal(wm._rollout(obs_a, tuple(p[:2] for p in plan_a)), tuple(x[:2] for x in first))  # another horizon
    assert profiling.counters()["rollout.graph_captures"] == 1 and len(wm._graphs) == 1
    assert profiling.counters()[CAST] == 3  # one a graphed request


def test_graphed_path_reads_updated_and_replaced_parameters(eager_graphs):
    jspec, tspec, tmodel = _bf16(build())
    wm = WorldModel(tmodel)
    _, tb = _batch(jspec, 11)
    plan = _grouped_plan(tspec, 12)
    for _ in range(2):
        wm._rollout(tb.obs, plan)
    with torch.no_grad():
        for p in tmodel.parameters():
            p.mul_(1.01)  # in place, as optimizer.step: the same graph
    _equal(wm._rollout(tb.obs, plan), _eager(tmodel, tb.obs, plan))
    assert profiling.counters()["rollout.graph_captures"] == 1
    tmodel.reward_linear.kernel = torch.nn.Parameter(2 * tmodel.reward_linear.kernel.detach())
    want = _eager(tmodel, tb.obs, plan)
    for captures in (1, 2):  # a new key: served eagerly, then captured
        _equal(wm._rollout(tb.obs, plan), want)
        assert profiling.counters()["rollout.graph_captures"] == captures
    # the key's first request, the new key's first one and the two references
    assert profiling.counters()["rollout.eager_steps"] == 4 * T
    assert profiling.counters()[CAST] == 3  # the two graphed requests of the first key, one of the new key


def test_graphed_path_keeps_the_newest_keys(eager_graphs):
    jspec, tspec, tmodel = _bf16(build())
    wm = WorldModel(tmodel)
    sizes = [1, 2, 3, 4, 5]
    assert len(sizes) == inference.GRAPH_KEYS + 1
    for b in sizes:
        _, tb = _batch(jspec, b, b=b)
        plan = _grouped_plan(tspec, b, t=2, b=b)
        for _ in range(2):
            wm._rollout(tb.obs, plan)
    assert [key[1][0][0][0] for key in wm._graphs] == sizes[1:]  # B of each kept key, oldest first
    assert profiling.counters() == {"rollout.eager_steps": 10, "rollout.graph_captures": 5, "rollout.graph_replays": 10,
                                    CAST: 5}


def _continuous_bf16():
    spec = AgentSpec.from_dicts(AGENTS, OBS, {a: 2 for a in AGENTS})
    cfg = ModelConfig(**{**SMALL, "compute_dtype": "bfloat16", "discrete_act": False})
    return spec, MAVAE.from_config(cfg, spec, device="cpu", generator=torch.Generator().manual_seed(0))


def test_cast_store_replays_the_eager_loop_on_continuous_actions(eager_graphs):
    """The discrete model's cast store is in the three tests above."""
    spec, model = _continuous_bf16()
    g = torch.Generator().manual_seed(13)
    obs = tuple(torch.randn(B, len(i), od, generator=g) for (od, _), i in spec.groups)
    plan = tuple(torch.rand(T, B, len(i), ad, generator=g) * 2 - 1 for (_, ad), i in spec.groups)
    wm = WorldModel(model)
    want = wm._rollout(obs, plan)  # eager
    _equal(wm._rollout(obs, plan), want)  # captured, then replayed on the store
    (graph,) = wm._graphs.values()
    assert graph.casts and all(c.dtype == torch.bfloat16 for c in graph.casts.values())
    short = tuple(p[:2] for p in plan)
    _equal(wm._rollout(obs, short), tuple(x[:2] for x in want))  # another horizon
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.01)  # in place, as optimizer.step: read at the next request
    _equal(wm._rollout(obs, plan), _eager(model, obs, plan))
    counts = profiling.counters()
    assert counts[CAST] == counts["rollout.graph_captures"] + 2 == 3  # one a graphed request
    assert counts["rollout.graph_replays"] == 2 * T + 2


def test_cast_store_holds_the_dense_kernels_and_biases():
    from mfvae_tpu_torch.envs.mpe import make

    cfg = load_config(str(EXAMPLES / "world_model.yaml"))
    m = cfg.model
    assert m.compute_dtype == "bfloat16"
    # the recipe's depth at tiny widths: the store follows the layers
    m.idx_features = m.obs_features = m.action_features = 8
    m.det_features = 4
    m.encoder_hidden, m.decoder_hidden = (8,) * len(m.encoder_hidden), (8,) * len(m.decoder_hidden)
    env = make(cfg.env.name, device="cpu", num_good_agents=1, num_adversaries=2, num_obs=1)
    model = MAVAE.from_config(m, build_spec(env), device="cpu")
    mean = inference._MeanCall(model)
    store = inference._cast_store(mean)
    assert len(store) == 42
    params = dict(mean.named_parameters())
    left = {f"{name}.{leaf}" for name, mod in mean.named_modules()
            if isinstance(mod, (LayerNorm, Embedding, StackedEmbedding)) for leaf, _ in mod.named_parameters()}
    assert left and set(store) == set(params) - left
    for name, (p, cast) in store.items():
        assert name.endswith((".kernel", ".bias")) and p is params[name]
        assert cast.dtype == torch.bfloat16 and cast.shape == p.shape


def test_a_float32_model_has_no_cast_store(eager_graphs):
    jspec, tspec, _, _, tmodel = build()
    wm = WorldModel(tmodel)
    _, tb = _batch(jspec, 15)
    plan = _grouped_plan(tspec, 16)
    want = wm._rollout(tb.obs, plan)
    _equal(wm._rollout(tb.obs, plan), want)
    (graph,) = wm._graphs.values()
    assert graph.casts == {}
    assert profiling.counters() == {"rollout.eager_steps": T, "rollout.graph_captures": 1, "rollout.graph_replays": T}


def test_agent_id_buffers_stay_out_of_the_state_dict():
    _, tspec, _, variables, tmodel = build()
    assert set(tmodel.state_dict()) == {name for name, _ in tmodel.named_parameters()}
    assert [tmodel._group_ids(g).tolist() for g in range(len(tspec.groups))] == [list(i) for _, i in tspec.groups]
    # a checkpoint made without them: the JAX tree's parameters, and the
    # state dict the port saved before the buffers were there
    fresh = MAVAE.from_config(ModelConfig(**SMALL), tspec, device="cpu")
    fresh.load_state_dict(params_from_jax(variables), strict=True)
    fresh.load_state_dict({name: p.detach().clone() for name, p in tmodel.named_parameters()}, strict=True)


@pytest.mark.parametrize("name", ["action_delta_head", "world_model"])
def test_encode_and_action_delta_match_host_built_ids(name, monkeypatch):
    _, _, tmodel, _, tbatch = build_options(OPTIONS[name])
    spec = tmodel.spec
    with torch.no_grad():
        got = tmodel.encode(tbatch), tmodel.mean_call(tbatch)
        if tmodel.action_delta_head:
            recon = torch.randn(tbatch.obs[0].shape[0], sum(spec.obs_dims), generator=torch.Generator().manual_seed(0))
            aemb = tmodel.encode(tbatch)[2]
            old = recon + agent_order_concat(spec, tuple(
                tmodel.action_delta_heads[g](aemb[:, list(idxs), :]) for g, (_, idxs) in enumerate(spec.groups)))
            torch.testing.assert_close(tmodel._add_action_delta(recon, aemb), old, rtol=0, atol=0)
        # the ids as each call built them from the host before
        monkeypatch.setattr(tmodel, "_group_ids", lambda g: torch.tensor(spec.groups[g][1]))
        want = tmodel.encode(tbatch), tmodel.mean_call(tbatch)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            if x is not None:
                torch.testing.assert_close(x, y, rtol=0, atol=0)
