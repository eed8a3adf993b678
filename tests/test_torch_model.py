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


@pytest.mark.parametrize("field,value", [("rng_mode", "reference"), ("remat", True)])
def test_unported_options_refused(field, value):
    cfg = ModelConfig(**SMALL)
    setattr(cfg, field, value)
    spec = AgentSpec.from_dicts(("a",), {"a": 3}, {"a": 5})
    with pytest.raises(NotImplementedError, match="M20"):
        MAVAE.from_config(cfg, spec, device="cpu")

