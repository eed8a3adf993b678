"""The port's MAVAE against the JAX MAVAE on the same parameters and noise.

Parameters come from the JAX ``model.init`` and cross over through
``params_from_jax``; eps is the draw the JAX model makes from its key.
Both run at compute_dtype float32 (JAX matmul precision "highest",
tests/conftest.py; torch on the CPU has no TF32).  Tolerance: rtol 1e-4 /
atol 1e-5, for float32 products summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfvae_tpu.config import ModelConfig as JModelConfig
from mfvae_tpu.models.mavae import AgentSpec as JSpec
from mfvae_tpu.models.mavae import GroupedBatch as JBatch
from mfvae_tpu.models.mavae import MAVAE as JMAVAE
from mfvae_tpu_torch.config import ModelConfig
from mfvae_tpu_torch.models.convert import params_from_jax
from mfvae_tpu_torch.models.mavae import (
    MAVAE,
    AgentSpec,
    GroupedBatch,
    agent_order_concat,
    state_to_grouped,
)
from tests.test_torch_experiment import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
SMALL = dict(idx_features=8, obs_features=8, action_features=8,
             encoder_hidden=(16,), decoder_hidden=(32, 16), compute_dtype="float32")
# two groups with different obs widths; "interleaved" puts a good agent
# between the adversaries, so grouped order is not agent order
SPECS = {
    "grouped": (("adversary_0", "adversary_1", "agent_0"), {"adversary_0": 10, "adversary_1": 10, "agent_0": 6}),
    "interleaved": (("adversary_0", "agent_0", "adversary_1"), {"adversary_0": 10, "adversary_1": 10, "agent_0": 6}),
}


def build(spec_name, fused=True, B=8, seed=0):
    agents, obs = SPECS[spec_name]
    acts = {a: 5 for a in agents}
    jspec, tspec = JSpec.from_dicts(agents, obs, acts), AgentSpec.from_dicts(agents, obs, acts)
    jmodel = JMAVAE.from_config(JModelConfig(fused_decoders=fused, **SMALL), jspec)
    tmodel = MAVAE.from_config(ModelConfig(fused_decoders=fused, **SMALL), tspec, device="cpu")
    rng = np.random.default_rng(seed)
    obs_np = [rng.normal(size=(B, len(idxs), od)).astype(np.float32) for (od, _), idxs in jspec.groups]
    act_np = [rng.integers(0, 5, size=(B, len(idxs))).astype(np.int32) for _, idxs in jspec.groups]
    jbatch = JBatch(obs=tuple(map(jnp.asarray, obs_np)), actions=tuple(map(jnp.asarray, act_np)))
    tbatch = GroupedBatch(obs=tuple(map(torch.from_numpy, obs_np)), actions=tuple(map(torch.from_numpy, act_np)))
    variables = jmodel.init(jax.random.PRNGKey(seed), jbatch, None, jax.random.PRNGKey(1))
    tmodel.load_state_dict(params_from_jax(jax.device_get(variables)))
    return jmodel, variables, tmodel, jbatch, tbatch, jspec, tspec


def jax_eps(jmodel, variables, key, shape):
    return np.array(jmodel.apply(variables, key, shape, method=lambda m, k, s: m._eps(k, s)))


def close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("spec_name", sorted(SPECS))
@pytest.mark.parametrize("fused", [True, False])
def test_call_fused_call_mean_call_match(spec_name, fused):
    jmodel, variables, tmodel, jbatch, tbatch, jspec, _ = build(spec_name, fused)
    key = jax.random.PRNGKey(7)
    eps = torch.from_numpy(jax_eps(jmodel, variables, key, (8, jspec.n_agents, 8)))

    for t, j in zip(tmodel(tbatch, eps=eps), jmodel.apply(variables, jbatch, None, key)):
        close(t, j)
    jf = jmodel.apply(variables, jbatch, None, key, method="fused_call")
    for t, j in zip(tmodel.fused_call(tbatch, eps=eps), jf):
        close(t, j)
    for t, j in zip(tmodel.mean_call(tbatch), jmodel.apply(variables, jbatch, method="mean_call")):
        close(t, j)


def test_param_names_and_init_statistics():
    jmodel, variables, tmodel, *_ = build("grouped")
    fresh = MAVAE.from_config(ModelConfig(**SMALL), tmodel.spec, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    jparams = params_from_jax(jax.device_get(variables))
    assert set(fresh.state_dict()) == set(jparams)
    for name, p in fresh.state_dict().items():
        assert p.shape == jparams[name].shape, name
        if name.endswith("bias"):
            assert torch.all(p == 0), name
        elif name.endswith("kernel"):
            # lecun normal truncated at 2 sigma: every entry inside
            # 2 / (0.8796 sqrt(fan_in))
            fan_in = p.shape[-2]
            assert p.abs().max() <= 2.0 / (0.87962566 * fan_in ** 0.5) + 1e-6, name


def test_agent_order_concat_round_trip():
    *_, tbatch, _, tspec = build("interleaved")
    state = agent_order_concat(tspec, tbatch.obs)
    assert state.shape == (8, 26)
    for a, b in zip(state_to_grouped(tspec, state), tbatch.obs):
        torch.testing.assert_close(a, b)


# ------------------------------------------------------------- bf16 forward
BF16_AGENTS = tuple(f"adversary_{i}" for i in range(6)) + tuple(f"agent_{i}" for i in range(3))
BF16_OBS = {a: (10 if a.startswith("adversary") else 8) for a in BF16_AGENTS}
BF16_CASES = {
    "fused decoders": dict(fused_decoders=True),
    "unfused decoders": dict(fused_decoders=False),
    "det+residual+skip+layernorm": dict(fused_decoders=False, det_features=8, residual_state=True,
                                        state_skip=True, decoder_layernorm=True),
}


def _bf16_pairs(case, port_dtype):
    """(port, JAX) outputs of the plain, fused and mean calls: JAX in
    bfloat16, the port in ``port_dtype``, on bridged params and JAX's eps."""
    acts = {a: 5 for a in BF16_AGENTS}
    jspec, tspec = JSpec.from_dicts(BF16_AGENTS, BF16_OBS, acts), AgentSpec.from_dicts(BF16_AGENTS, BF16_OBS, acts)
    kw = dict(SMALL, compute_dtype="bfloat16", **BF16_CASES[case])
    jmodel = JMAVAE.from_config(JModelConfig(**kw), jspec)
    tmodel = MAVAE.from_config(ModelConfig(**dict(kw, compute_dtype=port_dtype)), tspec, device="cpu")
    rng = np.random.default_rng(3)
    b = 64
    obs_np = [rng.normal(size=(b, len(idxs), od)).astype(np.float32) for (od, _), idxs in jspec.groups]
    act_np = [rng.integers(0, 5, size=(b, len(idxs))).astype(np.int32) for _, idxs in jspec.groups]
    jbatch = JBatch(obs=tuple(map(jnp.asarray, obs_np)), actions=tuple(map(jnp.asarray, act_np)))
    tbatch = GroupedBatch(obs=tuple(map(torch.from_numpy, obs_np)), actions=tuple(map(torch.from_numpy, act_np)))
    variables = jmodel.init(jax.random.PRNGKey(4), jbatch, None, jax.random.PRNGKey(5))
    tmodel.load_state_dict(params_from_jax(jax.device_get(variables)))
    key = jax.random.PRNGKey(6)
    eps = torch.from_numpy(jax_eps(jmodel, variables, key, (b, jspec.n_agents, SMALL["obs_features"])))
    pairs = [
        (tmodel(tbatch, eps=eps), jmodel.apply(variables, jbatch, None, key)),
        (tmodel.fused_call(tbatch, eps=eps)[:2], jmodel.apply(variables, jbatch, None, key, method="fused_call")[:2]),
        (tmodel.mean_call(tbatch), jmodel.apply(variables, jbatch, method="mean_call")),
    ]
    return [(g, np.asarray(w, dtype=np.float32)) for got, want in pairs for g, w in zip(got, want)]


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bf16_forward_matches_jax(case):
    """The main path's compute dtype: 9 agents in two groups, B = 64, in
    bfloat16, by the plain call, the fused call and the mean call.  Held
    at rtol 2^-7 with no atol (on this CPU the outputs came out
    bit-equal).  The control: the same port computing in float32 misses
    that tolerance on every output, so the test tells the two precisions
    apart."""
    for g, w in _bf16_pairs(case, "bfloat16"):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=2.0 ** -7, atol=0)
    for g, w in _bf16_pairs(case, "float32"):
        assert not np.allclose(g.detach().numpy(), w, rtol=2.0 ** -7, atol=0)
