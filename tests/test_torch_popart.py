"""PopArt/ART in the port against ``mfvae_tpu.training.popart`` and the JAX
train step in the ART and POPART modes.

The stats functions must agree with JAX within atol 1e-6.  One train step
from the same parameters, batch and eps (the JAX model's draw from the
step's key) must give the same losses, PopArt stats and updated parameters
within rtol 1e-4 / atol 1e-5, the tolerance of tests/test_torch_trainer.py,
by the plain route and by the ``use_pallas`` route (the kernels' plain
versions on the CPU, Pallas in interpret mode in JAX).  Float32 compute on
both sides; no TF32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfvae_tpu.config import LossConfig as JLossConfig
from mfvae_tpu.config import ModelConfig as JModelConfig
from mfvae_tpu.config import TrainConfig as JTrainConfig
from mfvae_tpu.data.transitions import VaeBatch as JVaeBatch
from mfvae_tpu.models.mavae import AgentSpec as JSpec
from mfvae_tpu.models.mavae import GroupedBatch as JBatch
from mfvae_tpu.models.mavae import MAVAE as JMAVAE
from mfvae_tpu.training import popart as jpop
from mfvae_tpu.training.trainer import create_train_state as j_create_train_state
from mfvae_tpu.training.trainer import make_test_step as j_make_test_step
from mfvae_tpu.training.trainer import make_train_step as j_make_train_step
from mfvae_tpu_torch.config import LossConfig, ModelConfig, TrainConfig
from mfvae_tpu_torch.data.transitions import VaeBatch
from mfvae_tpu_torch.models.convert import params_from_jax
from mfvae_tpu_torch.models.mavae import MAVAE, AgentSpec, GroupedBatch
from mfvae_tpu_torch.training import popart as tpop
from mfvae_tpu_torch.training.trainer import create_train_state, make_test_step, make_train_step
from tests.test_torch_experiment import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
B, F, N = 8, 8, 3
AGENTS = ("adversary_0", "adversary_1", "agent_0")
OBS = {"adversary_0": 10, "adversary_1": 10, "agent_0": 6}
SMALL = dict(idx_features=F, obs_features=F, action_features=F, encoder_hidden=(16,),
             decoder_hidden=(32,), compute_dtype="float32", reward_head_init="popart")
BETA = 0.3  # large, so one update moves the stats far


def stats(rng, n=N):
    mu = rng.normal(size=n).astype(np.float32)
    nu = (mu * mu + rng.uniform(0.5, 2.0, size=n)).astype(np.float32)
    return np.stack([mu, nu, np.sqrt(nu - mu * mu).astype(np.float32)])


def both_states(arr):
    return jpop.PopArtState(*map(jnp.asarray, arr)), tpop.PopArtState(*map(torch.from_numpy, arr))


def close(t, j, atol=1e-6, rtol=0.0, msg=""):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol, err_msg=msg)


@pytest.mark.parametrize("case", ["spread", "constant", "huge"])
def test_art_matches_jax(case):
    rng = np.random.default_rng(0)
    targets = {
        "spread": 3.0 + 2.0 * rng.normal(size=(B, N)),
        "constant": np.full((B, N), 0.25),  # the variance floor SIGMA_MIN**2
        "huge": 1e4 * rng.normal(size=(B, N)),
    }[case].astype(np.float32)
    js, ts = both_states(stats(rng) if case != "constant" else np.stack([np.zeros(N), np.full(N, 0.0625), np.ones(N)]).astype(np.float32))
    for beta in (3e-4, BETA, 1.0):
        jn = jpop.art(js, jnp.asarray(targets), beta)
        tn = tpop.art(ts, torch.from_numpy(targets), beta)
        for name, t, j in zip(jn._fields, tn, jn):
            close(t, j, atol=1e-6, rtol=1e-6 if case == "huge" else 0.0, msg=f"{name} beta={beta}")


def test_normalize_denormalize_match_jax():
    rng = np.random.default_rng(1)
    js, ts = both_states(stats(rng))
    y = rng.normal(size=(B, N)).astype(np.float32)
    close(tpop.normalize(ts, torch.from_numpy(y)), jpop.normalize(js, jnp.asarray(y)))
    close(tpop.denormalize(ts, torch.from_numpy(y)), jpop.denormalize(js, jnp.asarray(y)))
    round_trip = tpop.normalize(ts, tpop.denormalize(ts, torch.from_numpy(y)))
    close(round_trip, y)


def _models(seed=0, **model_kw):
    acts = {a: 5 for a in AGENTS}
    jspec, tspec = JSpec.from_dicts(AGENTS, OBS, acts), AgentSpec.from_dicts(AGENTS, OBS, acts)
    cfg = dict(SMALL, **model_kw)
    jmodel = JMAVAE.from_config(JModelConfig(**cfg), jspec)
    rng = np.random.default_rng(seed)
    obs = [rng.normal(size=(B, 2, 10)).astype(np.float32), rng.normal(size=(B, 1, 6)).astype(np.float32)]
    act = [rng.integers(0, 5, size=(B, 2)).astype(np.int32), rng.integers(0, 5, size=(B, 1)).astype(np.int32)]
    nxt = rng.normal(size=(B, 26)).astype(np.float32)
    rew = (3.0 + 2.0 * rng.normal(size=(B, N))).astype(np.float32)  # off-centre, so ART matters
    jbatch = JVaeBatch(
        inputs=JBatch(obs=tuple(map(jnp.asarray, obs)), actions=tuple(map(jnp.asarray, act))),
        next_state=jnp.asarray(nxt), rewards=jnp.asarray(rew),
    )
    tbatch = VaeBatch(
        inputs=GroupedBatch(obs=tuple(map(torch.from_numpy, obs)), actions=tuple(map(torch.from_numpy, act))),
        next_state=torch.from_numpy(nxt), rewards=torch.from_numpy(rew),
    )
    variables = jmodel.init(jax.random.PRNGKey(0), jbatch.inputs, None, jax.random.PRNGKey(1))
    tmodel = MAVAE.from_config(ModelConfig(**cfg), tspec, device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.device_get(variables)))
    return jmodel, variables, jbatch, tmodel, tbatch


def test_pop_rescale_head_matches_jax_and_keeps_predictions():
    jmodel, variables, jbatch, tmodel, tbatch = _models(reward_head_init="lecun")
    rng = np.random.default_rng(2)
    old, new = stats(rng), stats(rng)
    (jo, to), (jn, tn) = both_states(old), both_states(new)
    before = tpop.denormalize(to, tmodel.mean_call(tbatch.inputs)[1]).detach()
    want = jpop.pop_rescale_head(variables, jo, jn, ("params", "reward_linear"))["params"]["reward_linear"]
    tpop.pop_rescale_head(tmodel, to, tn)
    close(tmodel.reward_linear.kernel, want["kernel"], msg="kernel")
    close(tmodel.reward_linear.bias, want["bias"], msg="bias")
    after = tpop.denormalize(tn, tmodel.mean_call(tbatch.inputs)[1]).detach()
    # the invariant: denormalized predictions do not move
    torch.testing.assert_close(after, before, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("mode", ["ART", "POPART"])
def test_one_step_matches_jax(mode, use_pallas):
    jmodel, variables, jbatch, tmodel, tbatch = _models()
    key = jax.random.PRNGKey(5)
    eps = np.array(jax.random.normal(key, (B, N, F)))
    loss_kw = dict(family="torch")
    jstate = j_create_train_state(jmodel, variables, JTrainConfig())
    step = j_make_train_step(JLossConfig(**loss_kw), mode, BETA, use_pallas=use_pallas)
    s1, o1 = jax.jit(step)(jstate, jbatch, key)

    state = create_train_state(tmodel, TrainConfig())
    state, o2 = make_train_step(LossConfig(**loss_kw), mode, BETA, use_pallas=use_pallas)(
        state, tbatch, eps=torch.from_numpy(eps)
    )
    for name in ("loss", "s_loss", "r_loss", "kl_loss"):
        np.testing.assert_allclose(float(getattr(o2, name)), float(getattr(o1, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    for name, t, j in zip(s1.popart._fields, state.popart, s1.popart):
        close(t, j, atol=1e-6, msg=name)
    assert not torch.equal(state.popart.sigma, torch.ones(N))
    want = params_from_jax(jax.device_get(s1.params))
    got = state.model.state_dict()
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("mode", ["Adam", "ART"])
def test_test_step_normalizes_with_the_state_stats(mode):
    jmodel, variables, jbatch, tmodel, tbatch = _models()
    key = jax.random.PRNGKey(9)
    eps = torch.from_numpy(np.array(jax.random.normal(key, (B, N, F))))
    arr = stats(np.random.default_rng(3))
    jstate = j_create_train_state(jmodel, variables, JTrainConfig()).replace(
        popart=jpop.PopArtState(*map(jnp.asarray, arr))
    )
    o1 = j_make_test_step(JLossConfig(), mode)(jstate, jbatch, key)
    state = create_train_state(tmodel, TrainConfig())
    state.popart = tpop.PopArtState(*map(torch.from_numpy, arr))
    o2 = make_test_step(LossConfig(), mode)(state, tbatch, eps=eps)
    for name in ("loss", "s_loss", "r_loss", "kl_loss"):
        np.testing.assert_allclose(float(getattr(o2, name)), float(getattr(o1, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_adam_step_keeps_the_stats():
    *_, tmodel, tbatch = _models()
    state = create_train_state(tmodel, TrainConfig())
    state, _ = make_train_step(LossConfig())(state, tbatch, torch.Generator().manual_seed(0))
    for x, y in zip(state.popart, tpop.init_popart(N)):
        assert torch.equal(x, y)


def test_art_refuses_contact_weight_as_in_jax():
    with pytest.raises(AssertionError):
        j_make_train_step(JLossConfig(contact_weight=1.0), "ART")
    with pytest.raises(ValueError, match="contact_weight"):
        make_train_step(LossConfig(contact_weight=1.0), "ART")
