"""The train step's matrix-product FLOPs (``mfvae_tpu_torch/bench/common.py``
``step_flops``) against two counts of the same step, and the port's forward
through JAX's parameters, at tiny widths on the CPU.

- ``step_flops`` equals ``FlopCounterMode``'s count of one train step on
  each MPE scenario's spec and over the model options that add or reshape
  a product, and of the unroll step at W = 1, 2 and 8.
- It equals the ``dot_general`` FLOPs of JAX's ``value_and_grad`` of the
  same step, less the one-hot products of its ``StackedEmbedding`` (a
  gather here), on each scenario's spec.
- A forward through JAX's parameters, bridged by ``models/convert.py``,
  matches JAX's ``model.apply`` at float32 within rtol 1e-5 (atol 1e-5 for
  outputs near 0).

The port's spec and model are built as the benchmark's tests build them:
``build_spec(make(...))`` and ``MAVAE.from_config``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from mfvae_tpu.config import LossConfig as JLossConfig
from mfvae_tpu.config import ModelConfig as JModelConfig
from mfvae_tpu.envs.mpe import make as jmake
from mfvae_tpu.models.losses import elbo_losses as jelbo_losses
from mfvae_tpu.models.mavae import MAVAE as JMAVAE
from mfvae_tpu.models.mavae import GroupedBatch as JGroupedBatch
from mfvae_tpu.training.experiment import build_spec as jbuild_spec
from mfvae_tpu_torch.bench.common import step_flops
from mfvae_tpu_torch.config import LossConfig, ModelConfig, TrainConfig
from mfvae_tpu_torch.data.transitions import GroupedTransition, VaeBatch
from mfvae_tpu_torch.envs.mpe import make
from mfvae_tpu_torch.models.convert import params_from_jax
from mfvae_tpu_torch.models.mavae import MAVAE, GroupedBatch
from mfvae_tpu_torch.training.experiment import build_spec
from mfvae_tpu_torch.training.trainer import create_train_state, make_train_step
from mfvae_tpu_torch.training.unroll import make_unroll_train_step
from tests.test_torch_experiment import one_torch_thread  # noqa: F401

# __graft_entry__._flagship's tiny widths
TINY = dict(idx_features=8, obs_features=8, action_features=8, encoder_hidden=(16,), action_encoder_hidden=(8,),
            decoder_hidden=(32, 32), compute_dtype="float32")
TAG = "MPE_simple_tag_v3"  # 30 adversaries, 10 good agents, 20 obstacles
# the other scenarios at their own populations; simple_world_comm's leader
# is a group of its own, with 20 actions
SCENARIOS = {"simple_tag": TAG, "simple_spread": "MPE_simple_spread_v3",
             "simple_adversary": "MPE_simple_adversary_v3", "simple_world_comm": "MPE_simple_world_comm_v3"}
RECIPE = dict(det_features=128, residual_state=True, state_skip=True, decoder_layernorm=True, fused_decoders=False)


def _model(env: str, **options):
    """The port's (spec, MAVAE) of ``env`` at the tiny widths, on the CPU."""
    spec = build_spec(make(env, device="cpu"))
    mc = ModelConfig(**options, **TINY)
    return spec, MAVAE.from_config(mc, spec, device="cpu", generator=torch.Generator().manual_seed(0))


def _grouped(spec, lead: tuple, g: torch.Generator):
    """(obs, actions) of every group, [*lead, A_g, ...], drawn from ``g``."""
    obs = tuple(torch.randn(*lead, len(i), od, generator=g) for (od, _), i in spec.groups)
    act = tuple(torch.randint(0, ad, (*lead, len(i)), generator=g, dtype=torch.int32) for (_, ad), i in spec.groups)
    return obs, act


def _vae_batch(spec, batch: int, g: torch.Generator) -> VaeBatch:
    obs, act = _grouped(spec, (batch,), g)
    next_state = torch.randn(batch, sum(spec.obs_dims), generator=g)
    return VaeBatch(inputs=GroupedBatch(obs=obs, actions=act), next_state=next_state,
                    rewards=torch.randn(batch, spec.n_agents, generator=g))


def _window_batch(spec, batch: int, windows: int, g: torch.Generator) -> GroupedTransition:
    obs, act = _grouped(spec, (batch, windows), g)
    nxt, _ = _grouped(spec, (batch, windows), g)
    return GroupedTransition(obs=obs, actions=act, next_obs=nxt,
                             rewards=torch.randn(batch, windows, spec.n_agents, generator=g),
                             done=torch.zeros(batch, windows))


def _jax_model(env: str, batch: int):
    """JAX's (spec, MAVAE, inputs) of ``env`` at the tiny widths, the inputs
    drawn from ``default_rng(0)`` as ``__graft_entry__._flagship`` draws
    them: every group's obs, then every group's actions."""
    jspec = jbuild_spec(jmake(env))
    rng = np.random.default_rng(0)
    obs = tuple(jnp.asarray(rng.normal(size=(batch, len(i), od)), jnp.float32) for (od, _), i in jspec.groups)
    act = tuple(jnp.asarray(rng.integers(0, ad, size=(batch, len(i)))) for (_, ad), i in jspec.groups)
    return jspec, JMAVAE.from_config(JModelConfig(**TINY), jspec), JGroupedBatch(obs=obs, actions=act)


def test_bridged_forward_matches_jax():
    jspec, jmodel, jin = _jax_model(TAG, 4)
    _, model = _model(TAG)
    tin = GroupedBatch(obs=tuple(torch.from_numpy(np.array(o)) for o in jin.obs),
                       actions=tuple(torch.from_numpy(np.array(a)) for a in jin.actions))
    variables = jmodel.init(jax.random.PRNGKey(0), jin, None, jax.random.PRNGKey(1))
    model.load_state_dict(params_from_jax(jax.device_get(variables)))
    key = jax.random.PRNGKey(7)
    eps = np.array(jmodel.apply(variables, key, (4, jspec.n_agents, 8), method=lambda m, k, s: m._eps(k, s)))
    with torch.no_grad():
        outs = model(tin, None, eps=torch.from_numpy(eps))
    for t, j in zip(outs, jmodel.apply(variables, jin, None, key)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- the FLOPs
def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


STEPS = {  # id: (scenario, model options)
    "default": (TAG, {}),
    "det128": (TAG, {"det_features": 128}),
    "recipe": (TAG, RECIPE),
    "control": (TAG, dict(RECIPE, action_delta_head=True)),
    **{name: (env, {}) for name, env in SCENARIOS.items() if env != TAG},
    "shared_private": (TAG, {"latent_structure": "shared_private"}),
    "twohot": (TAG, {"reward_head_mode": "twohot"}),
    "pred_state_unfused": (TAG, {"reward_head_input": "pred_state", "fused_decoders": False}),
}


@pytest.mark.parametrize("env, options", list(STEPS.values()), ids=list(STEPS))
def test_step_flops_equal_flop_counter(env, options):
    spec, model = _model(env, **options)
    g = torch.Generator().manual_seed(0)
    batch = _vae_batch(spec, 4, g)
    step = make_train_step(LossConfig(s_weight=300.0))
    state = create_train_state(model, TrainConfig())
    assert step_flops(model, 4) == _counted(lambda: step(state, batch, g))


@pytest.mark.parametrize("windows", [1, 2, 8])
def test_unroll_step_flops_equal_flop_counter(windows):
    spec, model = _model(TAG, **RECIPE)
    g = torch.Generator().manual_seed(0)
    wbatch = _window_batch(spec, 2, windows, g)
    step = make_unroll_train_step(spec, LossConfig(s_weight=300.0), windows)
    state = create_train_state(model, TrainConfig())
    assert step_flops(model, 2, windows) == _counted(lambda: step(state, wbatch, g))


def _dot_flops(jaxpr) -> int:
    """2·|out|·|contracted| summed over every dot_general, sub-jaxprs included."""
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lhs_contract, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            total += 2 * math.prod(eqn.outvars[0].aval.shape) * math.prod(lhs[d] for d in lhs_contract)
        for p in eqn.params.values():
            for sub in p if isinstance(p, (tuple, list)) else (p,):
                if hasattr(sub, "eqns"):
                    total += _dot_flops(sub)
                elif hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                    total += _dot_flops(sub.jaxpr)
    return total


@pytest.mark.parametrize("env", list(SCENARIOS.values()), ids=list(SCENARIOS))
def test_step_flops_equal_jax_dot_general_less_one_hot(env):
    b = 4
    jspec, jmodel, jin = _jax_model(env, b)
    spec, model = _model(env)
    assert spec.groups == jspec.groups and spec.obs_dims == jspec.obs_dims
    rng = np.random.default_rng(0)
    next_state = jnp.asarray(rng.normal(size=(b, sum(jspec.obs_dims))), jnp.float32)
    rewards = jnp.asarray(rng.normal(size=(b, jspec.n_agents)), jnp.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), jin, None, jax.random.PRNGKey(1))

    def loss(params):
        outs = jmodel.apply(params, jin, None, jax.random.PRNGKey(2))
        return jelbo_losses(*outs[:2], next_state, rewards, *outs[2:], JLossConfig()).loss

    jax_flops = _dot_flops(jax.make_jaxpr(jax.value_and_grad(loss))(variables).jaxpr)
    # StackedEmbedding's one-hot product [B, A_g, K] x [A_g, K, F], forward
    # and its kernel's gradient: a gather in the port
    af = TINY["action_features"]
    one_hot = sum(2 * (2 * b * len(idxs) * act * af) for (_, act), idxs in jspec.groups)
    assert step_flops(model, b) == jax_flops - one_hot
