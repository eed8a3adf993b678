"""One train step of the port against ``mfvae_tpu.training.trainer``.

Both packages start from the same parameters (JAX ``model.init`` bridged by
``params_from_jax``), the same batch and the same eps (the JAX model's draw
from the step's key), and take one Adam step, by the plain route and by the
``use_pallas`` route (the kernels' plain versions on the CPU, Pallas in
interpret mode in JAX).  Losses and every updated parameter must agree
within rtol 1e-4 / atol 1e-5, the tolerance of tests/test_pallas_path.py.
Float32 compute on both sides; no TF32 on the CPU.
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
from mfvae_tpu.training.trainer import create_train_state as j_create_train_state
from mfvae_tpu.training.trainer import make_train_step as j_make_train_step
from mfvae_tpu_torch.config import LossConfig, ModelConfig, TrainConfig
from mfvae_tpu_torch.data.transitions import VaeBatch
from mfvae_tpu_torch.models.convert import params_from_jax
from mfvae_tpu_torch.models.mavae import MAVAE, AgentSpec, GroupedBatch
from mfvae_tpu_torch.training.trainer import create_train_state, make_lr, make_train_step
from tests.test_torch_experiment import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
B, F = 8, 8
AGENTS = ("adversary_0", "adversary_1", "agent_0")
OBS = {"adversary_0": 10, "adversary_1": 10, "agent_0": 6}
SMALL = dict(idx_features=F, obs_features=F, action_features=F,
             encoder_hidden=(16,), decoder_hidden=(32,), compute_dtype="float32")


def setup(seed=0):
    acts = {a: 5 for a in AGENTS}
    jspec, tspec = JSpec.from_dicts(AGENTS, OBS, acts), AgentSpec.from_dicts(AGENTS, OBS, acts)
    jmodel = JMAVAE.from_config(JModelConfig(**SMALL), jspec)
    rng = np.random.default_rng(seed)
    obs = [rng.normal(size=(B, 2, 10)).astype(np.float32), rng.normal(size=(B, 1, 6)).astype(np.float32)]
    act = [rng.integers(0, 5, size=(B, 2)).astype(np.int32), rng.integers(0, 5, size=(B, 1)).astype(np.int32)]
    nxt = rng.normal(size=(B, 26)).astype(np.float32)
    rew = rng.normal(size=(B, 3)).astype(np.float32)
    jbatch = JVaeBatch(
        inputs=JBatch(obs=tuple(map(jnp.asarray, obs)), actions=tuple(map(jnp.asarray, act))),
        next_state=jnp.asarray(nxt), rewards=jnp.asarray(rew),
    )
    tbatch = VaeBatch(
        inputs=GroupedBatch(obs=tuple(map(torch.from_numpy, obs)), actions=tuple(map(torch.from_numpy, act))),
        next_state=torch.from_numpy(nxt), rewards=torch.from_numpy(rew),
    )
    variables = jmodel.init(jax.random.PRNGKey(0), jbatch.inputs, None, jax.random.PRNGKey(1))
    jstate = j_create_train_state(jmodel, variables, JTrainConfig())
    tmodel = MAVAE.from_config(ModelConfig(**SMALL), tspec, device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.device_get(variables)))
    return jmodel, jstate, jbatch, tmodel, tbatch


@pytest.mark.parametrize("use_pallas", [False, True])
def test_one_step_matches_jax(use_pallas):
    jmodel, jstate, jbatch, tmodel, tbatch = setup()
    key = jax.random.PRNGKey(5)
    eps = np.array(jax.random.normal(key, (B, len(AGENTS), F)))
    s1, o1 = jax.jit(j_make_train_step(JLossConfig(), use_pallas=use_pallas))(jstate, jbatch, key)

    state = create_train_state(tmodel, TrainConfig())
    state, o2 = make_train_step(LossConfig(), use_pallas=use_pallas)(state, tbatch, eps=torch.from_numpy(eps))
    for name in ("loss", "s_loss", "r_loss", "kl_loss"):
        np.testing.assert_allclose(float(getattr(o2, name)), float(getattr(o1, name)), rtol=RTOL, atol=ATOL, err_msg=name)
    want = params_from_jax(jax.device_get(s1.params))
    got = state.model.state_dict()
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=RTOL, atol=ATOL, err_msg=name)
    assert state.step == 1


def test_routes_draw_the_same_eps_from_one_generator_state():
    *_, tmodel, tbatch = setup()
    init = {k: v.clone() for k, v in tmodel.state_dict().items()}
    losses = []
    for use_pallas in (False, True):
        tmodel.load_state_dict(init)
        state = create_train_state(tmodel, TrainConfig())
        g = torch.Generator().manual_seed(3)
        _, out = make_train_step(LossConfig(), use_pallas=use_pallas)(state, tbatch, g)
        losses.append(float(out.loss))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)


def test_pallas_step_trains():
    *_, tmodel, tbatch = setup()
    state = create_train_state(tmodel, TrainConfig())
    step = make_train_step(LossConfig(), use_pallas=True)
    g = torch.Generator().manual_seed(0)
    losses = [float(step(state, tbatch, g)[1].loss) for _ in range(15)]
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("loss_kw,s_col", [
    (dict(free_bits=0.1), False), (dict(use_huber=False), False),
    (dict(contact_weight=1.0), False), ({}, True),
])
def test_use_pallas_guards_raise_as_in_jax(loss_kw, s_col):
    col = np.ones(26, np.float32) if s_col else None
    with pytest.raises(AssertionError):
        j_make_train_step(JLossConfig(**loss_kw), use_pallas=True, s_col_weight=col)
    tcol = None if col is None else torch.from_numpy(col)
    with pytest.raises(ValueError):
        make_train_step(LossConfig(**loss_kw), use_pallas=True, s_col_weight=tcol)
    # the plain route accepts the same loss options, as in JAX
    j_make_train_step(JLossConfig(**loss_kw), use_pallas=False, s_col_weight=col)
    make_train_step(LossConfig(**loss_kw), use_pallas=False, s_col_weight=tcol)


@pytest.mark.parametrize("schedule", ["constant", "cosine", "cosine_periodic", "warmup_cosine"])
def test_lr_schedules_match_optax(schedule):
    from mfvae_tpu.training.trainer import make_lr as j_make_lr

    kw = dict(lr=1e-3, lr_schedule=schedule, lr_t_max=20, lr_warmup_steps=5, lr_min_ratio=0.1)
    jlr, tlr = j_make_lr(JTrainConfig(**kw)), make_lr(TrainConfig(**kw))
    for step in (0, 1, 4, 5, 10, 20, 37):
        want = jlr if isinstance(jlr, float) else float(jlr(step))
        np.testing.assert_allclose(tlr(step), want, rtol=1e-5, atol=1e-9, err_msg=f"step {step}")


def test_grad_clip_matches_optax():
    jmodel, _, jbatch, tmodel, tbatch = setup()
    variables = jmodel.init(jax.random.PRNGKey(0), jbatch.inputs, None, jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(5)
    jstate = j_create_train_state(jmodel, variables, JTrainConfig(grad_clip=0.05))
    s1, _ = jax.jit(j_make_train_step(JLossConfig()))(jstate, jbatch, key)
    state = create_train_state(tmodel, TrainConfig(grad_clip=0.05))
    eps = torch.from_numpy(np.array(jax.random.normal(key, (B, len(AGENTS), F))))
    state, _ = make_train_step(LossConfig())(state, tbatch, eps=eps)
    want = params_from_jax(jax.device_get(s1.params))
    for name, p in state.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=RTOL, atol=ATOL, err_msg=name)
