"""The tooling options of ROADMAP M20 in the port: ``utils/profiling.py``
(``train.profile_epochs``), ``train.debug_nans``, ``model.remat``,
``model.rng_mode='reference'`` and ``train.bug_compat_rng``.

Against the JAX package: the bug_compat test phase (its sums over
train_num) on the same parameters, test buffer, samples and eps, within
rtol 1e-6; the frozen regime's equal actions in epochs 0 and 1 in both
packages; whole runs inside JAX seed bands.  The rest holds the port to
itself: remat's loss and grads within rtol 1e-6 of the plain model's, the
reference mode's draws equal to sequential per-row draws from a cloned
generator.  Float32 on the CPU, where torch has no TF32.
"""

import json
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfvae_tpu.config import ExperimentConfig as JExperimentConfig
from mfvae_tpu.data.buffer import BufferState as JBufferState
from mfvae_tpu.data.buffer import ItemBuffer as JItemBuffer
from mfvae_tpu.data.transitions import GroupedTransition as JTransition
from mfvae_tpu.training.experiment import Experiment as JExperiment
from mfvae_tpu.training.trainer import create_train_state as j_create_train_state
from mfvae_tpu.training.trainer import make_phase_fns as j_make_phase_fns
from mfvae_tpu_torch.config import LossConfig, ModelConfig, load_config
from mfvae_tpu_torch.data.transitions import GroupedTransition
from mfvae_tpu_torch.models import layers
from mfvae_tpu_torch.models.convert import params_from_jax
from mfvae_tpu_torch.models.losses import elbo_losses
from mfvae_tpu_torch.models.mavae import MAVAE, AgentSpec, GroupedBatch
from mfvae_tpu_torch.ops import fused_elbo
from mfvae_tpu_torch.training.experiment import Experiment
from mfvae_tpu_torch.training.trainer import create_train_state, make_phase_fns
from mfvae_tpu_torch.utils.debug_nans import NanGuard
from mfvae_tpu_torch.utils.profiling import span, trace
from tests.test_torch_experiment import (  # noqa: F401
    JAX_TEST_HI,
    JAX_TEST_LO,
    JAX_TRAIN_HI,
    JAX_TRAIN_LO,
    _band,
    _carry_tensors,
    one_torch_thread,
    parity_small,
)
from tests.test_training import tiny_cfg

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
# JAX's parity_small under train.bug_compat_rng, seeds 0-7 on the CPU
# (python scripts/torch_tooling_band.py 8 --config bug_compat_small): its
# loss_test is the sum of the 8 eval batches' means over train_num 5
BUG_COMPAT_TRAIN_LO, BUG_COMPAT_TRAIN_HI = 0.04397958517074585, 0.25477004051208496
BUG_COMPAT_TEST_LO, BUG_COMPAT_TEST_HI = 0.21613457798957825, 1.5864609479904175


def small(tmp, epochs=2, **options):
    cfg = parity_small(tmp)
    cfg.train.epoch_num = epochs
    for key, v in options.items():
        section, name = key.split("__")
        setattr(getattr(cfg, section), name, v)
    return cfg


# ------------------------------------------------------------------ profiling
def test_annotate_names_a_span_in_the_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        with span("phase"):
            torch.ones(4).sum()
    assert any(e.name == "mfvae.phase" for e in prof.events())
    assert list(tmp_path.glob("*.pt.trace.json"))


def test_profile_epochs_writes_a_trace(tmp_path):
    exp = Experiment(small(tmp_path, epochs=2, train__profile_epochs=1), device="cpu").setup()
    exp.run()
    files = list((exp.logger.run_dir / "profile").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    # epoch 1 alone: its train steps' Adam updates, one per step
    steps = [e for e in events if e.get("name", "").startswith("Optimizer.step#Adam.step")]
    assert len(steps) == exp.cfg.train.train_num
    assert [e.get("name") for e in events].count("mfvae.train_phase") == 1


@pytest.mark.parametrize("profile,per_dispatch,start,epochs,want", [
    (1, 1, 0, 4, range(1, 2)),
    (2, 1, 3, 8, range(4, 6)),
    (1, 3, 0, 8, range(0, 3)),  # the first chunk, from the start epoch
    (5, 4, 2, 4, range(2, 4)),  # cut at the last epoch
    (0, 1, 0, 4, None),
    (1, 1, 4, 4, None),  # nothing left to run
])
def test_profile_window(tmp_path, profile, per_dispatch, start, epochs, want):
    exp = Experiment(small(tmp_path, epochs=epochs, train__profile_epochs=profile,
                           train__epochs_per_dispatch=per_dispatch), device="cpu")
    exp.start_epoch = start
    assert exp._profile_window() == want


# ------------------------------------------------------------------ debug_nans
def _guard_is_off():
    return (not torch.is_anomaly_enabled() and fused_elbo._NAN_CHECK is None)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_debug_nans_raises_on_a_poisoned_parameter(tmp_path, use_pallas):
    exp = Experiment(small(tmp_path, epochs=1, train__debug_nans=True, model__use_pallas=use_pallas),
                     device="cpu").setup()
    result = exp.run()
    assert np.isfinite(result["loss_train"]) and _guard_is_off()
    model = exp.carry.train_state.model
    with torch.no_grad():
        model.encoders[0].fc0.kernel[0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match=r"encoders\.0\.fc0"):
        exp.run()
    assert _guard_is_off()
    assert not any(m._forward_hooks for m in model.modules())


def _nan_in_module(model):
    model(torch.tensor([[float("nan"), 0.0]]))


def _nan_in_k1(model):
    x = torch.zeros(2, 4)
    fused_elbo.fused_reparam_kl(x, x, torch.full((2, 4), float("nan")))


def _nan_in_k2(model):
    mu, lv = torch.zeros(2, 4, requires_grad=True), torch.zeros(2, 4)
    z, _ = fused_elbo.fused_reparam_kl(mu, lv, torch.zeros(2, 4))
    z.backward(torch.full((2, 4), float("nan")))


def _nan_in_k3(model):
    fused_elbo.huber_mean(torch.tensor([float("nan"), 1.0]), torch.zeros(2))


def _nan_in_backward(model):
    x = torch.zeros(3, requires_grad=True)
    (torch.sqrt(x) * 0.0).sum().backward()  # forward 0, backward 0 * inf


@pytest.mark.parametrize("poison,where", [
    (_nan_in_module, r"module Linear"), (_nan_in_k1, r"K1 reparam_kl_fwd \(plain version\)"),
    (_nan_in_k2, r"K2 reparam_kl_bwd \(plain version\)"), (_nan_in_k3, r"K3 huber_mean \(plain version\)"),
    (_nan_in_backward, r"backward: .*SqrtBackward"),
])
def test_nan_guard_names_where(poison, where):
    model = torch.nn.Linear(2, 2)
    poison(model)  # no guard, no error
    with pytest.raises(FloatingPointError, match=where):
        with NanGuard(model):
            poison(model)
    assert _guard_is_off()


def test_nan_guard_restores_anomaly_mode():
    torch.autograd.set_detect_anomaly(True, check_nan=False)
    try:
        with NanGuard(torch.nn.Linear(2, 2)):
            assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        assert torch.is_anomaly_enabled() and not torch.is_anomaly_check_nan_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)


# ----------------------------------------------------------------------- remat
AGENTS = ("adversary_0", "agent_0", "adversary_1")  # grouped order is not agent order
OBS = {"adversary_0": 10, "agent_0": 6, "adversary_1": 10}
SMALL = dict(idx_features=8, obs_features=8, action_features=8, encoder_hidden=(16, 16),
             action_encoder_hidden=(8,), decoder_hidden=(32, 16), compute_dtype="float32")
B = 8


def _batch(spec, discrete, seed=0):
    rng = np.random.default_rng(seed)
    obs = tuple(torch.from_numpy(rng.normal(size=(B, len(i), od)).astype(np.float32)) for (od, _), i in spec.groups)
    if discrete:
        act = tuple(torch.from_numpy(rng.integers(0, 5, size=(B, len(i))).astype(np.int32)) for _, i in spec.groups)
    else:
        act = tuple(torch.from_numpy(rng.uniform(-1, 1, size=(B, len(i), 5)).astype(np.float32))
                    for _, i in spec.groups)
    nxt = torch.from_numpy(rng.normal(size=(B, sum(spec.obs_dims))).astype(np.float32))
    rew = torch.from_numpy(rng.normal(size=(B, spec.n_agents)).astype(np.float32))
    return GroupedBatch(obs=obs, actions=act), nxt, rew


def _model(remat, seed=0, **kw):
    spec = AgentSpec.from_dicts(AGENTS, OBS, {a: 5 for a in AGENTS})
    cfg = ModelConfig(remat=remat, **SMALL, **kw)
    return MAVAE.from_config(cfg, spec, device="cpu", generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("kw", [
    dict(fused_decoders=True), dict(fused_decoders=False, decoder_layernorm=True),
    dict(fused_decoders=False, discrete_act=False),
], ids=["fused", "unfused+layernorm", "continuous"])
def test_remat_gives_the_same_loss_and_grads(monkeypatch, kw):
    calls = []
    real = layers.checkpoint
    monkeypatch.setattr(layers, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    plain, remat = _model(False, **kw), _model(True, **kw)
    remat.load_state_dict(plain.state_dict())
    inputs, nxt, rew = _batch(plain.spec, kw.get("discrete_act", True))
    eps = torch.from_numpy(np.random.default_rng(1).normal(size=(B, 3, 8)).astype(np.float32))
    losses = []
    for model in (plain, remat):
        recon_s, recon_r, mu, logvar = model(inputs, eps=eps)
        out = elbo_losses(recon_s, recon_r, nxt, rew, mu, logvar, LossConfig())
        out.loss.backward()
        losses.append(out)
    assert calls, "remat checkpointed nothing"
    n_plain = len(calls)
    for a, b in zip(*losses):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=0)
    for (name, p), q in zip(plain.named_parameters(), remat.parameters()):
        torch.testing.assert_close(q.grad, p.grad, rtol=1e-6, atol=1e-7, msg=name)
    with torch.no_grad():  # no recompute to save for: no checkpoint
        remat.mean_call(inputs)
    assert len(calls) == n_plain


# --------------------------------------------------------- rng_mode=reference
def test_reference_rng_draws_rows_in_sequence_in_grouped_order():
    model = _model(False, rng_mode="reference")
    assert not model.spec.grouped_is_identity
    g = torch.Generator().manual_seed(5)
    clone = torch.Generator().manual_seed(5)
    eps = model._eps(g, (B, 3, 8))
    want = torch.stack([torch.randn((B, 8), generator=clone) for _ in range(3)], dim=1)
    assert torch.equal(eps, want)
    assert torch.equal(g.get_state(), clone.get_state())
    # grouped row i = draw i: the adversaries' rows first, then agent_0's
    inputs, _, _ = _batch(model.spec, True)
    for call in (model.forward, model.fused_call):
        a = call(inputs, generator=torch.Generator().manual_seed(5))
        b = call(inputs, eps=want)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    vectorized = _model(False)._eps(torch.Generator().manual_seed(5), (B, 3, 8))
    assert not torch.equal(vectorized, want)


def test_unknown_rng_mode_is_refused():
    with pytest.raises(ValueError, match="rng_mode"):
        _model(False, rng_mode="sequential")


# ------------------------------------------------------------------ bug_compat
class _Replay:
    """Hands the port's test phase the batches JAX's test phase sampled."""

    class Sample(NamedTuple):
        experience: GroupedTransition

    def __init__(self, experience, batch_size):
        self.experience, self.sample_batch_size = experience, batch_size

    def sample(self, state, generator, batch_size=None):
        return self.Sample(self.experience)


def test_bug_compat_test_phase_matches_jax(tmp_path):
    """Same params, test buffer contents, samples and eps: the port's test
    phase under bug_compat_rng gives JAX's sums over train_num."""
    jcfg = tiny_cfg(tmp_path, bug_compat_rng=True, test_num=4, train_num=3)
    jexp = JExperiment(jcfg)
    spec = jexp.spec
    n, bs, f = 24, jcfg.buffer.batch_size, jcfg.model.obs_features
    rng = np.random.default_rng(0)
    groups = [(len(i), od) for (od, _), i in spec.groups]
    data = JTransition(
        obs=tuple(rng.normal(size=(n, a, od)).astype(np.float32) for a, od in groups),
        actions=tuple(rng.integers(0, 5, size=(n, a)).astype(np.int32) for a, _ in groups),
        next_obs=tuple(rng.normal(size=(n, a, od)).astype(np.float32) for a, od in groups),
        rewards=rng.normal(size=(n, spec.n_agents)).astype(np.float32),
        done=np.zeros(n, np.float32),
    )
    jbuffer = JItemBuffer(max_length=n, min_length=1, sample_batch_size=bs)
    jstate = JBufferState(data=jax.tree.map(jnp.asarray, data), cursor=jnp.int32(0), size=jnp.int32(n))
    variables = jax.jit(lambda k, fb: jexp.model.init(k, fb, None, k))(jax.random.PRNGKey(0), jexp._fake_batch(bs))
    jts = j_create_train_state(jexp.model, variables, jcfg.train)
    key = jax.random.PRNGKey(3)
    jout = jax.jit(j_make_phase_fns(jexp.env, spec, jbuffer, jbuffer, jcfg)[2])(jts, jstate, key)

    # the samples and eps of JAX's test phase, drawn from its keys as it draws them
    @jax.jit
    def draws(k):
        k_sample, k_model = jax.random.split(k)
        eps = jexp.model.apply(variables, k_model, (bs, spec.n_agents, f), method=lambda m, kk, s: m._eps(kk, s))
        return jax.random.randint(k_sample, (bs,), 0, n), eps

    idx, eps = zip(*(jax.device_get(draws(k)) for k in jax.random.split(key, jcfg.train.test_num)))
    idx = np.concatenate(idx)
    joined = GroupedTransition(*(
        tuple(torch.from_numpy(x[idx]) for x in field) if isinstance(field, tuple) else torch.from_numpy(field[idx])
        for field in data
    ))
    tcfg = small(tmp_path, train__bug_compat_rng=True, train__test_num=4, train__train_num=3)
    for section in ("env", "model", "buffer"):
        for name, v in vars(getattr(jcfg, section)).items():
            if hasattr(getattr(tcfg, section), name):
                setattr(getattr(tcfg, section), name, v)
    texp = Experiment(tcfg, device="cpu")
    model = MAVAE.from_config(tcfg.model, texp.spec, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(variables)))
    model._eps = lambda generator, shape, eps_=None: torch.from_numpy(np.concatenate(eps))
    test_phase = make_phase_fns(texp.env, texp.spec, texp.buffer, _Replay(joined, bs), tcfg, texp.streams)[2]
    tout = test_phase(create_train_state(model, tcfg.train), None)
    for name, t, j in zip(tout._fields, tout, jout):
        np.testing.assert_allclose(float(t), float(j), rtol=1e-6, err_msg=name)
    tcfg.train.bug_compat_rng = False  # the mean over test_num instead
    test_phase = make_phase_fns(texp.env, texp.spec, texp.buffer, _Replay(joined, bs), tcfg, texp.streams)[2]
    mean = test_phase(create_train_state(model, tcfg.train), None)
    np.testing.assert_allclose(float(mean.loss) * 4 / 3, float(tout.loss), rtol=1e-6)


def _epoch_actions(actions, sample_num):
    """The actions the train buffer stored in epochs 0 and 1 (group 0;
    each env shard's own, under n_envs > 1)."""
    a = np.asarray(actions[0])
    return a[..., :sample_num, :], a[..., sample_num : 2 * sample_num, :]


@pytest.mark.parametrize("bug_compat", [True, False])
def test_jax_bug_compat_epochs_collect_equal_actions(tmp_path, bug_compat):
    cfg = tiny_cfg(tmp_path, epoch_num=2, bug_compat_rng=bug_compat)
    exp = JExperiment(cfg).setup()
    exp.run()
    e0, e1 = _epoch_actions(jax.device_get(exp.carry.buffer_state.data.actions), cfg.train.sample_num)
    assert np.array_equal(e0, e1) == bug_compat


@pytest.mark.parametrize("n_envs", [1, 2])
@pytest.mark.parametrize("bug_compat", [True, False])
def test_bug_compat_epochs_collect_equal_actions(tmp_path, bug_compat, n_envs):
    cfg = small(tmp_path, train__bug_compat_rng=bug_compat, train__n_envs=n_envs)
    exp = Experiment(cfg, device="cpu").setup()
    exp.run()
    s = cfg.train.sample_num  # each env writes sample_num items to its shard
    e0, e1 = _epoch_actions(exp.carry.buffer_state.data.actions, s)
    assert np.array_equal(e0, e1) == bug_compat
    t0, t1 = _epoch_actions(exp.carry.test_buffer_state.data.actions, s)
    assert np.array_equal(t0, t1) == bug_compat


def test_bug_compat_resumed_run_continues_exactly(tmp_path):
    """Two epochs, then resume for two more == four epochs straight; the
    epoch streams' snapshot is rebuilt from the seed."""
    straight = small(tmp_path / "a", epochs=4, train__bug_compat_rng=True)
    first = Experiment(straight, device="cpu").setup()
    want = first.run()
    split = small(tmp_path / "b", epochs=2, train__bug_compat_rng=True)
    Experiment(split, device="cpu").setup().run()
    split.train.epoch_num = 4
    split.train.resume = True
    second = Experiment(split, device="cpu").setup()
    got = second.run()
    assert got["loss_train"] == want["loss_train"] and got["loss_test"] == want["loss_test"]
    for x, y in zip(_carry_tensors(first), _carry_tensors(second)):
        assert torch.equal(x, y)


# -------------------------------------------------------------- whole runs
def test_bug_compat_replication_lands_in_the_jax_band(tmp_path):
    yaml_cfg = load_config(str(EXAMPLES / "bug_compat_replication.yaml"))
    assert yaml_cfg.train.bug_compat_rng
    cfg = parity_small(tmp_path)
    cfg.train.bug_compat_rng, cfg.loss = True, yaml_cfg.loss
    result = Experiment(cfg, device="cpu").setup().run()
    lo, hi = _band(BUG_COMPAT_TRAIN_LO, BUG_COMPAT_TRAIN_HI)
    assert lo <= result["loss_train"] <= hi, result
    lo, hi = _band(BUG_COMPAT_TEST_LO, BUG_COMPAT_TEST_HI)
    assert lo <= result["loss_test"] <= hi, result


@pytest.mark.parametrize("use_pallas", [False, True])
def test_reference_rng_run_lands_in_the_jax_band(tmp_path, use_pallas):
    cfg = parity_small(tmp_path)
    cfg.model.rng_mode, cfg.model.use_pallas = "reference", use_pallas
    result = Experiment(cfg, device="cpu").setup().run()
    lo, hi = _band(JAX_TRAIN_LO, JAX_TRAIN_HI)
    assert lo <= result["loss_train"] <= hi, result
    lo, hi = _band(JAX_TEST_LO, JAX_TEST_HI)
    assert lo <= result["loss_test"] <= hi, result


def test_default_experiment_config_carries_the_options():
    """Every M20 option of the JAX config exists in the port's, off by
    default as there."""
    j, t = JExperimentConfig(), parity_small("/nonexistent")
    for section, name in (("model", "rng_mode"), ("model", "remat"), ("train", "debug_nans"),
                          ("train", "bug_compat_rng"), ("train", "profile_epochs")):
        assert getattr(getattr(j, section), name) == getattr(getattr(t, section), name), name
