"""The model and loss options of the port against the JAX package.

- The two-hot functions, ``weighted_state_loss`` (each lever alone and
  both), ``elbo_losses`` with a two-hot head and ``build_s_col_weight``:
  rtol 1e-6.  XLA's ``exp`` and torch's differ by up to one float32 ulp,
  so ``symexp`` near 0, where exp(x) − 1 cancels, also takes atol 2^-23.
- ``LayerNorm`` in ``MLP`` and ``StackedMLP`` against flax: rtol 1e-5 in
  float32, 2e-2 in bfloat16.
- ``forward``, ``fused_call`` and ``mean_call`` for each model option
  alone, for the ``examples/world_model.yaml`` combination, for
  ``shared_private`` with the shared eps of JAX's ``fold_in`` draw, and
  for continuous actions: rtol 1e-5 / atol 1e-5.  The two-hot
  ``mean_call`` reward is an expectation over bins up to ±2,981, so its
  rtol 1e-5 is of the sum of the terms' magnitudes.  Gradients of the ELBO for
  the world-model combination and ``shared_private``: rtol 1e-4 / atol
  1e-5, the one-step tolerance of tests/test_torch_trainer.py.
- One train step with both weighted-state levers against JAX.
- The joined eval under ``loss.contact_weight`` equals the mean of the
  per-batch losses.
- ``Experiment(cfg, device="cpu")`` runs every example config and option
  of the port at tiny widths, the collection and unroll configs
  included (unroll_steps 8 over the 16-step collection blocks).

Parameters come from the JAX ``init`` through ``params_from_jax``; inputs
from numpy seeds; float32 on both sides, JAX matmul precision "highest"
(tests/conftest.py), no TF32 on the CPU.
"""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfvae_tpu.config import ExperimentConfig as JExperimentConfig
from mfvae_tpu.config import LossConfig as JLossConfig
from mfvae_tpu.config import ModelConfig as JModelConfig
from mfvae_tpu.config import TrainConfig as JTrainConfig
from mfvae_tpu.data.transitions import VaeBatch as JVaeBatch
from mfvae_tpu.models import layers as jlayers
from mfvae_tpu.models import losses as jl
from mfvae_tpu.models.mavae import AgentSpec as JSpec
from mfvae_tpu.models.mavae import GroupedBatch as JBatch
from mfvae_tpu.models.mavae import MAVAE as JMAVAE
from mfvae_tpu.training.trainer import build_s_col_weight as j_build_s_col_weight
from mfvae_tpu.training.trainer import create_train_state as j_create_train_state
from mfvae_tpu.training.trainer import make_train_step as j_make_train_step
from mfvae_tpu_torch.config import ExperimentConfig, LossConfig, ModelConfig, TrainConfig, load_config
from mfvae_tpu_torch.data.transitions import VaeBatch
from mfvae_tpu_torch.envs.mpe import make as make_env
from mfvae_tpu_torch.models import layers as tlayers
from mfvae_tpu_torch.models import losses as tl
from mfvae_tpu_torch.models.convert import params_from_jax
from mfvae_tpu_torch.models.mavae import MAVAE, AgentSpec, GroupedBatch
from mfvae_tpu_torch.training.experiment import Experiment, build_spec
from mfvae_tpu_torch.training.trainer import (
    build_s_col_weight,
    create_train_state,
    make_action_sampler,
    make_test_step,
    make_train_step,
)
from tests.test_torch_experiment import one_torch_thread  # noqa: F401

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
B, F = 8, 8
# "interleaved": a good agent sits between the adversaries, so grouped
# order is not agent order and det/z/aemb must be permuted
AGENTS = ("adversary_0", "agent_0", "adversary_1")
OBS = {"adversary_0": 10, "adversary_1": 10, "agent_0": 6}
SMALL = dict(idx_features=F, obs_features=F, action_features=F, encoder_hidden=(16,),
             action_encoder_hidden=(8,), decoder_hidden=(32, 16), compute_dtype="float32")
WORLD_MODEL = dict(det_features=4, residual_state=True, state_skip=True,
                   decoder_layernorm=True, fused_decoders=False)


def tt(x):
    return torch.from_numpy(np.array(x))


def assert_close(t, j, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol, err_msg=msg)


# ---------------------------------------------------------------- two-hot
@pytest.mark.parametrize("k", [5, 17, 65])
def test_twohot_functions_match_jax(k):
    rng = np.random.default_rng(k)
    y = np.concatenate([rng.normal(scale=20.0, size=40), [0.0, 1e9, -1e9, 10.0, -10.0]]).astype(np.float32)
    assert_close(tl.symlog(tt(y)), jl.symlog(jnp.asarray(y)), 1e-6)
    # exp(x) − 1 cancels near 0: one float32 ulp of exp's 1 (2^-23) is the atol
    assert_close(tl.symexp(tt(y / 10)), jl.symexp(jnp.asarray(y / 10)), 1e-6, 2.0**-23)
    jb, tb = jl.twohot_bins(k), tl.twohot_bins(k)
    assert_close(tb, jb, 1e-6)
    # on one grid, so the weights compare bin for bin
    assert_close(tl.twohot_targets(tt(y), tt(jb)), jl.twohot_targets(jnp.asarray(y), jb), 1e-6, 1e-7)
    logits = rng.normal(scale=3.0, size=(4, 3, k)).astype(np.float32)
    ys = y[:12].reshape(4, 3)
    assert_close(tl.twohot_expectation(tt(logits), tt(jb)), jl.twohot_expectation(jnp.asarray(logits), jb), 1e-6, 1e-6)
    assert_close(tl.twohot_ce_rows(tt(logits), tt(ys)), jl.twohot_ce_rows(jnp.asarray(logits), jnp.asarray(ys)), 1e-6)


@pytest.mark.parametrize("use_huber", [True, False])
def test_elbo_losses_with_a_twohot_head_match_jax(use_huber):
    rng = np.random.default_rng(0)
    args = [rng.normal(size=s).astype(np.float32) for s in ((B, 26), (B, 3, 17), (B, 26), (B, 3), (B, 24), (B, 24))]
    args[3] = (10.0 * rng.integers(0, 2, size=(B, 3))).astype(np.float32)  # sparse tag-like rewards
    got = tl.elbo_losses(*map(tt, args), LossConfig(use_huber=use_huber))
    want = jl.elbo_losses(*map(jnp.asarray, args), JLossConfig(use_huber=use_huber))
    for name, t, j in zip(want._fields, got, want):
        assert_close(t, j, 1e-6, msg=name)


# ------------------------------------------------------ weighted state loss
LEVERS = {"contact": (dict(contact_weight=2.0), False), "columns": ({}, True),
          "both": (dict(contact_weight=2.0), True)}


@pytest.mark.parametrize("lever", sorted(LEVERS))
@pytest.mark.parametrize("use_huber", [True, False])
def test_weighted_state_loss_matches_jax(lever, use_huber):
    loss_kw, cols = LEVERS[lever]
    rng = np.random.default_rng(1)
    recon, nxt = (rng.normal(scale=2.0, size=(B, 26)).astype(np.float32) for _ in range(2))
    rew = (10.0 * (rng.uniform(size=(B, 3)) < 0.3)).astype(np.float32)
    w = (1.0 + 4.0 * (rng.uniform(size=26) < 0.3)).astype(np.float32) if cols else None
    kw = dict(loss_kw, use_huber=use_huber)
    got = tl.weighted_state_loss(tt(recon), tt(nxt), tt(rew), LossConfig(**kw), None if w is None else tt(w))
    want = jl.weighted_state_loss(jnp.asarray(recon), jnp.asarray(nxt), jnp.asarray(rew), JLossConfig(**kw),
                                  None if w is None else jnp.asarray(w))
    assert_close(got, want, 1e-6)
    # and through elbo_losses, which routes the state branch to it
    mu = rng.normal(size=(B, 24)).astype(np.float32)
    got = tl.elbo_losses(tt(recon), tt(rew), tt(nxt), tt(rew), tt(mu), tt(mu), LossConfig(**kw),
                         s_col_weight=None if w is None else tt(w))
    want = jl.elbo_losses(jnp.asarray(recon), jnp.asarray(rew), jnp.asarray(nxt), jnp.asarray(rew),
                          jnp.asarray(mu), jnp.asarray(mu), JLossConfig(**kw),
                          s_col_weight=None if w is None else jnp.asarray(w))
    for name, t, j in zip(want._fields, got, want):
        assert_close(t, j, 1e-6, msg=name)


@pytest.mark.parametrize("pop", [(1, 2, 1), (10, 30, 20)])
def test_build_s_col_weight_matches_jax(pop):
    good, adv, obstacles = pop
    cfg, jcfg = ExperimentConfig(), JExperimentConfig()
    for c in (cfg, jcfg):
        c.env.num_good_agents, c.env.num_adversaries, c.env.num_obs = good, adv, obstacles
        c.loss.prey_dist_weight = 9.0
    spec = build_spec(make_env(cfg.env.name, device="cpu", num_good_agents=good,
                               num_adversaries=adv, num_obs=obstacles))
    assert_close(build_s_col_weight(spec, cfg), j_build_s_col_weight(spec, jcfg), 1e-6)
    cfg.loss.prey_dist_weight = 0.0
    assert build_s_col_weight(spec, cfg) is None
    cfg.loss.prey_dist_weight, cfg.env.name = 1.0, "MPE_simple_spread_v3"
    with pytest.raises(ValueError, match="simple_tag"):
        build_s_col_weight(spec, cfg)


# -------------------------------------------------------------- LayerNorm
@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("stacked", [False, True])
def test_layernorm_mlp_matches_flax(dtype, rtol, stacked):
    rng = np.random.default_rng(2)
    shape = (B, 2, 12) if stacked else (B, 12)
    x = (3.0 + 2.0 * rng.normal(size=shape)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    if stacked:
        jmlp = jlayers.StackedMLP(stack=2, hidden=(16, 8), out_dim=5, dtype=jdt, layernorm=True)
        tmlp = tlayers.StackedMLP(2, 12, (16, 8), 5, dtype=tdt, layernorm=True)
    else:
        jmlp = jlayers.MLP(hidden=(16, 8), out_dim=5, dtype=jdt, layernorm=True)
        tmlp = tlayers.MLP(12, (16, 8), 5, dtype=tdt, layernorm=True)
    params = jax.device_get(jmlp.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    # LayerNorm params off their init, so scale and bias count
    params = jax.tree.map(lambda p: p + 0.3 * rng.normal(size=p.shape).astype(np.float32), params)
    tmlp.load_state_dict(params_from_jax(params), strict=True)
    # flax: one [D] scale/bias per LayerNorm, shared across the stack
    assert tuple(tmlp.ln0.scale.shape) == (12,)
    want = np.asarray(jmlp.apply(params, jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    got = tmlp(tt(x).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().detach().numpy(), want, rtol=rtol, atol=rtol * np.abs(want).max())


def test_layernorm_variance_is_clamped_at_zero():
    x = torch.full((1, 3), 3734.173828125)
    # in float32, E[x²] − E[x]² rounds to −1 on this constant row
    assert float((x * x).mean() - x.mean() ** 2) < 0
    out = tlayers.LayerNorm(3)(x)
    assert torch.all(torch.isfinite(out))


# ------------------------------------------------------------- the model
OPTIONS = {
    "det_features": dict(det_features=4),
    "shared_private": dict(latent_structure="shared_private", shared_latent=3),
    "residual_state": dict(residual_state=True),
    "state_skip": dict(state_skip=True),
    "decoder_layernorm_fused": dict(decoder_layernorm=True),
    "decoder_layernorm_unfused": dict(decoder_layernorm=True, fused_decoders=False),
    "twohot_fused": dict(reward_head_mode="twohot", reward_bins=9),
    "twohot_unfused": dict(reward_head_mode="twohot", reward_bins=9, fused_decoders=False),
    "pred_state": dict(reward_head_input="pred_state", fused_decoders=False),
    "pred_state_residual": dict(reward_head_input="pred_state", fused_decoders=False, residual_state=True),
    "action_delta_head": dict(action_delta_head=True),
    "continuous": dict(discrete_act=False),
    "world_model": WORLD_MODEL,
}


def build(options, seed=0):
    cont = options.get("discrete_act", True) is False
    acts = {a: (2 if cont else 5) for a in AGENTS}
    jspec, tspec = JSpec.from_dicts(AGENTS, OBS, acts), AgentSpec.from_dicts(AGENTS, OBS, acts)
    jmodel = JMAVAE.from_config(JModelConfig(**SMALL, **options), jspec)
    tmodel = MAVAE.from_config(ModelConfig(**SMALL, **options), tspec, device="cpu")
    rng = np.random.default_rng(seed)
    obs = [rng.normal(size=(B, len(i), od)).astype(np.float32) for (od, _), i in jspec.groups]
    if cont:
        act = [rng.uniform(-1, 1, size=(B, len(i), 2)).astype(np.float32) for _, i in jspec.groups]
    else:
        act = [rng.integers(0, 5, size=(B, len(i))).astype(np.int32) for _, i in jspec.groups]
    jbatch = JBatch(obs=tuple(map(jnp.asarray, obs)), actions=tuple(map(jnp.asarray, act)))
    tbatch = GroupedBatch(obs=tuple(map(torch.from_numpy, obs)), actions=tuple(map(torch.from_numpy, act)))
    variables = jmodel.init(jax.random.PRNGKey(seed), jbatch, None, jax.random.PRNGKey(1))
    if options.get("action_delta_head"):
        # off its zero init, so the pathway shows in the outputs
        variables = jax.tree.map(lambda p: p + 0.1 * rng.normal(size=p.shape).astype(np.float32),
                                 jax.device_get(variables))
    tmodel.load_state_dict(params_from_jax(jax.device_get(variables)), strict=True)
    return jmodel, variables, tmodel, jbatch, tbatch


def noise(key, options):
    """JAX's draws from the call's key: eps [B, A, F] and, under
    shared_private, the shared eps from fold_in(key, 1)."""
    eps = tt(jax.random.normal(key, (B, len(AGENTS), F)))
    s = options.get("shared_latent") if options.get("latent_structure") == "shared_private" else None
    eps_s = tt(jax.random.normal(jax.random.fold_in(key, 1), (B, s))) if s else None
    return eps, eps_s


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_forward_fused_call_mean_call_match_jax(name):
    options = OPTIONS[name]
    jmodel, variables, tmodel, jbatch, tbatch = build(options)
    key = jax.random.PRNGKey(7)
    eps, eps_s = noise(key, options)
    calls = [
        (tmodel(tbatch, eps=eps, eps_shared=eps_s), jmodel.apply(variables, jbatch, None, key)),
        (tmodel.fused_call(tbatch, eps=eps, eps_shared=eps_s),
         jmodel.apply(variables, jbatch, None, key, method="fused_call")),
        (tmodel.mean_call(tbatch), jmodel.apply(variables, jbatch, method="mean_call")),
    ]
    for call, (got, want) in zip(("forward", "fused_call", "mean_call"), calls):
        assert len(got) == len(want)
        for i, (t, j) in enumerate(zip(got, want)):
            assert tuple(t.shape) == tuple(j.shape), (call, i)
            if call == "mean_call" and i == 1 and tmodel.twohot:
                # an expectation over bins up to ±2,981: rtol 1e-5 of the
                # sum of |terms|, where XLA's and torch's exp differ by an ulp
                err = (t - tt(j)).abs()
                assert torch.all(err <= 1e-5 + 1e-5 * _twohot_term_sum(tmodel, tbatch)), err.max()
                continue
            assert_close(t, j, 1e-5, 1e-5, msg=f"{call} output {i}")


def _twohot_term_sum(model, batch):
    """Σ_k p_k·|bin_k| of the two-hot mean_call's expectation."""
    mu_g, _, aemb_g, experts, det = model.encode(batch)
    mu, aemb, det = model._to_agent_order(mu_g, aemb_g, det)
    logits = model.decode(mu, aemb, None, det, model._base(batch))[1]
    bins = tl.twohot_bins(model.reward_bins)
    return (torch.softmax(logits, dim=-1) * bins.abs()).sum(-1).detach()


@pytest.mark.parametrize("name", ["world_model", "shared_private"])
def test_elbo_gradients_match_jax(name):
    options = OPTIONS[name]
    jmodel, variables, tmodel, jbatch, tbatch = build(options)
    key = jax.random.PRNGKey(3)
    eps, eps_s = noise(key, options)
    rng = np.random.default_rng(4)
    nxt, rew = rng.normal(size=(B, 26)).astype(np.float32), rng.normal(size=(B, 3)).astype(np.float32)
    cfg = dict(s_weight=300.0)

    def jloss(p):
        s, r, mu, lv = jmodel.apply(p, jbatch, None, key)
        return jl.elbo_losses(s, r, jnp.asarray(nxt), jnp.asarray(rew), mu, lv, JLossConfig(**cfg)).loss

    want = params_from_jax(jax.device_get(jax.grad(jloss)(variables)))
    s, r, mu, lv = tmodel(tbatch, eps=eps, eps_shared=eps_s)
    tl.elbo_losses(s, r, tt(nxt), tt(rew), mu, lv, LossConfig(**cfg)).loss.backward()
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(grads) == set(want)
    for n, g in grads.items():
        assert_close(g, want[n].numpy(), 1e-4, 1e-5, msg=n)


def test_model_guards_match_jax():
    spec = AgentSpec.from_dicts(("a",), {"a": 3}, {"a": 5})
    for bad in (dict(reward_head_input="pred_state", fused_decoders=True),
                dict(reward_head_mode="bogus"), dict(reward_head_input="bogus"),
                dict(latent_structure="bogus")):
        with pytest.raises(ValueError):
            MAVAE.from_config(ModelConfig(**SMALL, **bad), spec, device="cpu")


# -------------------------------------------------------- train and eval
def _step_batch(rng, n_batches=1):
    b = B * n_batches
    obs = [rng.normal(size=(b, 2, 10)).astype(np.float32), rng.normal(size=(b, 1, 6)).astype(np.float32)]
    act = [rng.integers(0, 5, size=(b, 2)).astype(np.int32), rng.integers(0, 5, size=(b, 1)).astype(np.int32)]
    nxt = rng.normal(size=(b, 26)).astype(np.float32)
    rew = (10.0 * (rng.uniform(size=(b, 3)) < 0.2)).astype(np.float32)
    return obs, act, nxt, rew


@pytest.mark.parametrize("use_cols", [False, True])
def test_one_weighted_step_matches_jax(use_cols):
    """One Adam step with loss.contact_weight (and the prey column weights)."""
    agents = ("adversary_0", "adversary_1", "agent_0")
    acts = {a: 5 for a in agents}
    jspec, tspec = JSpec.from_dicts(agents, OBS, acts), AgentSpec.from_dicts(agents, OBS, acts)
    opts = dict(SMALL, **WORLD_MODEL)
    jmodel = JMAVAE.from_config(JModelConfig(**opts), jspec)
    tmodel = MAVAE.from_config(ModelConfig(**opts), tspec, device="cpu")
    obs, act, nxt, rew = _step_batch(np.random.default_rng(5))
    jbatch = JVaeBatch(JBatch(tuple(map(jnp.asarray, obs)), tuple(map(jnp.asarray, act))),
                       jnp.asarray(nxt), jnp.asarray(rew))
    tbatch = VaeBatch(GroupedBatch(tuple(map(tt, obs)), tuple(map(tt, act))), tt(nxt), tt(rew))
    variables = jmodel.init(jax.random.PRNGKey(0), jbatch.inputs, None, jax.random.PRNGKey(1))
    tmodel.load_state_dict(params_from_jax(jax.device_get(variables)), strict=True)
    cols = (1.0 + 4.0 * (np.arange(26) % 3 == 0)).astype(np.float32) if use_cols else None
    loss_kw = dict(contact_weight=2.0, s_weight=300.0)
    key = jax.random.PRNGKey(6)
    step = j_make_train_step(JLossConfig(**loss_kw), s_col_weight=None if cols is None else jnp.asarray(cols))
    s1, o1 = jax.jit(step)(j_create_train_state(jmodel, variables, JTrainConfig()), jbatch, key)
    state, o2 = make_train_step(LossConfig(**loss_kw), s_col_weight=None if cols is None else tt(cols))(
        create_train_state(tmodel, TrainConfig()), tbatch, eps=tt(jax.random.normal(key, (B, 3, F)))
    )
    for name in ("loss", "s_loss", "r_loss", "kl_loss"):
        np.testing.assert_allclose(float(getattr(o2, name)), float(getattr(o1, name)), rtol=1e-4, atol=1e-5)
    want = params_from_jax(jax.device_get(s1.params))
    for n, p in state.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[n].numpy(), rtol=1e-4, atol=1e-5, err_msg=n)


def test_joined_eval_under_contact_weight_is_the_mean_of_per_batch_losses():
    t = 4
    tspec = AgentSpec.from_dicts(("adversary_0", "adversary_1", "agent_0"), OBS,
                                 {a: 5 for a in ("adversary_0", "adversary_1", "agent_0")})
    model = MAVAE.from_config(ModelConfig(**SMALL), tspec, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, TrainConfig())
    rng = np.random.default_rng(7)
    obs, act, nxt, rew = _step_batch(rng, t)
    rew[:B] = 10.0  # every transition of batch 0 is a contact, so the weight sums differ
    rew[B : 2 * B] = 0.0
    batch = VaeBatch(GroupedBatch(tuple(map(tt, obs)), tuple(map(tt, act))), tt(nxt), tt(rew))
    eps = torch.from_numpy(rng.normal(size=(t * B, 3, F)).astype(np.float32))
    step = make_test_step(LossConfig(contact_weight=3.0))
    joined = step(state, batch, eps=eps, n_batches=t)
    per = []
    for i in range(t):
        sl = slice(i * B, (i + 1) * B)
        chunk = VaeBatch(GroupedBatch(tuple(x[sl] for x in batch.inputs.obs), tuple(x[sl] for x in batch.inputs.actions)),
                         batch.next_state[sl], batch.rewards[sl])
        per.append(step(state, chunk, eps=eps[sl]))
    for name, got, *xs in zip(joined._fields, joined, *per):
        torch.testing.assert_close(got, torch.stack(xs).mean(), rtol=1e-6, atol=0, msg=name)
    # over the joined batch the weighted state loss is another number
    assert not torch.isclose(step(state, batch, eps=eps).s_loss, joined.s_loss, rtol=1e-4)


def test_continuous_sampler_draws_in_the_box():
    env = make_env("MPE_simple_tag_v3", device="cpu", num_good_agents=1, num_adversaries=2,
                   num_obs=1, discrete_actions=False)
    spec = build_spec(env)
    sample, group_actions = make_action_sampler(env, spec)
    a = sample(torch.Generator().manual_seed(0), leading=(5,))
    assert a.shape == (5, 3, 2) and a.dtype == torch.float32
    assert float(a.min()) >= -1.0 and float(a.max()) <= 1.0 and float(a.std()) > 0.3
    groups = group_actions(a)
    assert [tuple(g.shape) for g in groups] == [(5, 2, 2), (5, 1, 2)]
    torch.testing.assert_close(groups[1][:, 0], a[:, 2])


# ------------------------------------------------------------- whole runs
def tiny(cfg: ExperimentConfig, tmp) -> ExperimentConfig:
    """Tiny widths and depth over any config (tests/test_residual.py)."""
    cfg.env.num_good_agents, cfg.env.num_adversaries, cfg.env.num_obs = 1, 2, 1
    cfg.env.max_steps = 12
    cfg.model.idx_features = cfg.model.obs_features = cfg.model.action_features = 8
    cfg.model.encoder_hidden, cfg.model.action_encoder_hidden = (16,), (8,)
    cfg.model.decoder_hidden = (32,)
    cfg.model.compute_dtype = "float32"
    if cfg.model.det_features:
        cfg.model.det_features = 4
    cfg.buffer.max_size, cfg.buffer.min_size, cfg.buffer.batch_size = 64, 8, 8
    cfg.train.batch_size = 8
    cfg.train.epoch_num, cfg.train.sample_num, cfg.train.train_num, cfg.train.test_num = 2, 16, 2, 2
    cfg.train.log_dir = f"{tmp}/results"
    cfg.train.checkpoint_dir = ""
    return cfg


RUNS = {
    "torch_popart.yaml": [],
    "world_model.yaml": [],
    "det_quality.yaml": [],
    "continuous_tag.yaml": [],
    "pursuit_collection.yaml": [],
    "episode_mix_collection.yaml": [],
    "world_model_unroll.yaml": [],
    "world_model_actions.yaml": [],
    "world_model_control.yaml": [],
    "twohot+pred_state+action_delta_head": [
        "model.reward_head_mode=twohot", "model.reward_head_input=pred_state",
        "model.fused_decoders=false", "model.action_delta_head=true"],
    "shared_private": ["model.latent_structure=shared_private"],
    "contact+prey_weight": ["loss.contact_weight=1.0", "loss.prey_dist_weight=1.0"],
    "ART": ["train.mode=ART"],
}


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", sorted(RUNS))
def test_experiment_runs(tmp_path, name, use_pallas):
    yaml = EXAMPLES / (name if name.endswith(".yaml") else "reference_parity.yaml")
    cfg = tiny(load_config(str(yaml), RUNS[name]), tmp_path)
    cfg.model.use_pallas = use_pallas
    exp = Experiment(cfg, device="cpu")
    plain_only = cfg.model.reward_head_mode == "twohot" or cfg.loss.contact_weight > 0 or cfg.loss.prey_dist_weight > 0
    if use_pallas and plain_only:
        # the JAX package's guards: the kernels score scalar, unweighted huber
        with pytest.raises(ValueError):
            exp.setup()
        return
    # the unroll recipes run on the kernel route too (the port's widening)
    result = exp.setup().run()
    assert result["epoch"] == 1
    assert math.isfinite(result["loss_train"]) and math.isfinite(result["loss_test"]), result
    if cfg.train.mode == "POPART":
        assert not torch.equal(exp.carry.train_state.popart.sigma, torch.ones(3))


def test_twohot_refuses_popart_as_in_jax(tmp_path):
    cfg = tiny(load_config(str(EXAMPLES / "torch_popart.yaml"), ["model.reward_head_mode=twohot"]), tmp_path)
    with pytest.raises(ValueError, match="train.mode='Adam'"):
        Experiment(cfg, device="cpu").setup()
