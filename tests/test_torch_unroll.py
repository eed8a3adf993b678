"""Unroll training and window sampling of the port against
``mfvae_tpu/training/unroll.py`` and ``ItemBuffer.sample_window``.

- ``sample_window``: windows are consecutive before the ring wraps, never
  cross the write seam once it is full, and stay inside one block with
  ``block`` (the cases of tests/test_unroll.py).  Given the JAX package's
  own uniform draws, the port's start arithmetic (the seam shift and the
  block clamp into the valid prefix) and its gather, sharded or not, are
  exact against the JAX windows.
- The unroll loss and its gradients for W = 3 against JAX, with JAX's
  per-step eps (``jax.random.split(key, W)``, then the model's normal
  draw per step): BPTT, ``stop_gradient``, ``mean_feedback``, a ``done``
  mask, ``loss.contact_weight`` and ``s_col_weight``, on the
  world-model options (det_features, residual_state, state_skip,
  decoder LayerNorm, unfused decoders).  Losses within rtol 1e-5,
  gradients within rtol 1e-4 / atol 1e-6.
- W = 1 is the one-step ELBO (loss and gradients, rtol 1e-6).
- The POPART guard raises NotImplementedError in both packages; the
  ``use_pallas`` guard in JAX only, because the port runs the kernel route.
- The kernel route (``use_pallas``: ``fused_call``'s K1/K2 and K3w, their
  plain versions on the CPU) against the plain route, at f32 from one
  state: losses within rtol 1e-6, each leaf's gradient within 1e-6 of its
  norm, parameters after one clipped Adam step within rtol 1e-6 / atol
  1e-5 (the atol of the Adam step against JAX below).  K1/K2's plain
  versions round otherwise than autograd of the plain route (``std·std``
  for ``exp(logvar)``, the KL summed over F first), so a gradient element
  that cancels to near 0 differs by a few ulps of its leaf: the gradients
  are held by their norm.  Adam's first step moves each element by about
  lr·sign(g), so such an element moves by a share of lr (1e-3) that the
  ulps decide; a wrong gradient moves it by about lr.  Windows with episode ends,
  ``stop_gradient`` on and off, ``mean_feedback`` on and off, and the
  shared latent.
- One unroll Adam step (with the global-norm clip) against JAX's
  parameters: rtol 1e-4 / atol 1e-5, the one-step tolerance of
  tests/test_torch_trainer.py.

Parameters from the JAX ``init`` through ``params_from_jax``; inputs from
numpy seeds; float32 on both sides, JAX matmul precision "highest".
"""

import copy
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfvae_tpu.config import LossConfig as JLossConfig
from mfvae_tpu.config import ModelConfig as JModelConfig
from mfvae_tpu.config import TrainConfig as JTrainConfig
from mfvae_tpu.data.buffer import ItemBuffer as JBuffer
from mfvae_tpu.data.transitions import GroupedTransition as JTransition
from mfvae_tpu.models.mavae import AgentSpec as JSpec
from mfvae_tpu.models.mavae import GroupedBatch as JBatch
from mfvae_tpu.models.mavae import MAVAE as JMAVAE
from mfvae_tpu.training.trainer import create_train_state as j_create_train_state
from mfvae_tpu.training.unroll import make_unroll_loss_fn as j_make_unroll_loss_fn
from mfvae_tpu.training.unroll import make_unroll_train_step as j_make_unroll_train_step
from mfvae_tpu_torch.config import LossConfig, ModelConfig, TrainConfig
from mfvae_tpu_torch.data.buffer import ItemBuffer, window_starts
from mfvae_tpu_torch.data.transitions import GroupedTransition
from mfvae_tpu_torch.models.convert import params_from_jax
from mfvae_tpu_torch.models.losses import elbo_losses
from mfvae_tpu_torch.models.mavae import MAVAE, AgentSpec, GroupedBatch, agent_order_concat
from mfvae_tpu_torch.training.trainer import create_train_state
from mfvae_tpu_torch.training.unroll import make_unroll_loss_fn, make_unroll_train_step
from tests.test_torch_experiment import one_torch_thread  # noqa: F401


class Item(NamedTuple):
    i: torch.Tensor


# ---------------------------------------------------------------- sampling
def _fill(buf, n, shards=0):
    """Items 0..n-1 (plus 1000 × the shard) added one by one."""
    offset = 1000 * torch.arange(shards, dtype=torch.int32) if shards else torch.tensor(0, dtype=torch.int32)
    st = buf.init(Item(torch.zeros_like(offset)))
    for i in range(n):
        st = buf.add(st, Item(offset + i))
    return st


def test_windows_are_consecutive_before_wrap():
    buf = ItemBuffer(max_length=32, min_length=1, sample_batch_size=64)
    idx = buf.sample_window(_fill(buf, 20), torch.Generator().manual_seed(0), window=4).experience.i
    assert idx.shape == (64, 4)
    assert bool((idx.diff(dim=1) == 1).all()) and int(idx.max()) <= 19


def test_windows_never_cross_the_seam_when_full():
    buf = ItemBuffer(max_length=16, min_length=1, sample_batch_size=256)
    st = _fill(buf, 40)  # cursor = 40 % 16 = 8, oldest item = 24
    idx = buf.sample_window(st, torch.Generator().manual_seed(1), window=5).experience.i
    assert bool((idx.diff(dim=1) == 1).all())
    assert int(idx.min()) >= 24 and int(idx.max()) <= 39


def test_block_restriction():
    buf = ItemBuffer(max_length=32, min_length=1, sample_batch_size=512)
    idx = buf.sample_window(_fill(buf, 32), torch.Generator().manual_seed(2), window=4, block=8).experience.i
    assert bool((idx.diff(dim=1) == 1).all())
    assert bool((idx[:, 0] // 8 == idx[:, -1] // 8).all())


def test_window_arguments_are_checked():
    buf = ItemBuffer(max_length=16, sample_batch_size=4)
    st = _fill(buf, 16)
    with pytest.raises(ValueError):
        buf.sample_window(st, None, window=17)
    with pytest.raises(ValueError):
        buf.sample_window(st, None, window=4, block=6)  # does not divide 16


def _jax_draws(key, n, size, capacity, window, block):
    """The uniform draws inside the JAX package's sample_window."""
    k_a, k_b = jax.random.split(key)
    if block:
        a = jax.random.randint(k_a, (n,), 0, max(size // block, 1))
        b = jax.random.randint(k_b, (n,), 0, block - window + 1)
        return np.array(a), np.array(b)
    full = size >= capacity
    n_starts = capacity - window + 1 if full else max(size - window + 1, 1)
    return np.array(jax.random.randint(k_a, (n,), 0, n_starts)), None


# (capacity, items added, window, block): partly filled, wrapped, block
# aligned, and a block larger than the valid prefix (the clamp)
WINDOW_CASES = [(32, 20, 4, 0), (16, 40, 5, 0), (32, 32, 4, 8), (32, 40, 3, 8), (16, 6, 4, 8)]


@pytest.mark.parametrize("shards", [0, 2])
@pytest.mark.parametrize("case", WINDOW_CASES, ids=str)
def test_window_gather_and_clamp_match_jax(case, shards):
    cap, n_add, window, block = case
    n = 16
    jbuf = JBuffer(max_length=cap, min_length=1, sample_batch_size=n)
    tbuf = ItemBuffer(max_length=cap, min_length=1, sample_batch_size=n, shards=shards)
    tst = _fill(tbuf, n_add, shards)
    want, starts = [], []
    for s in range(max(shards, 1)):
        jst = jbuf.init({"i": jnp.int32(0)})
        for i in range(n_add):
            jst = jbuf.add(jst, {"i": jnp.int32(i + 1000 * s)})
        key = jax.random.PRNGKey(10 + s)
        want.append(np.asarray(jbuf.sample_window(jst, key, window, block=block).experience["i"]))
        a, b = _jax_draws(key, n, int(jst.size), cap, window, block)
        starts.append(window_starts(torch.from_numpy(a), None if b is None else torch.from_numpy(b),
                                    int(jst.size), int(jst.cursor), cap, window, block))
    assert (tst.size, tst.cursor) == (int(jst.size), int(jst.cursor))
    st = torch.stack(starts) if shards else starts[0]
    got = tbuf.gather_windows(tst, st, window).i
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want))
    if block and n_add < block:
        assert int(st.max()) <= n_add - window  # the clamp held the windows in the valid prefix


# ------------------------------------------------------------- loss math
AGENTS = ("adversary_0", "agent_0", "adversary_1")  # grouped order is not agent order
OBS = {"adversary_0": 6, "adversary_1": 6, "agent_0": 4}
F, B, W = 8, 4, 3
SMALL = dict(idx_features=F, obs_features=F, action_features=F, encoder_hidden=(16,),
             decoder_hidden=(32, 16), compute_dtype="float32", det_features=4, residual_state=True,
             state_skip=True, decoder_layernorm=True, fused_decoders=False)


def build(seed=0):
    acts = {a: 5 for a in AGENTS}
    jspec, tspec = JSpec.from_dicts(AGENTS, OBS, acts), AgentSpec.from_dicts(AGENTS, OBS, acts)
    jmodel = JMAVAE.from_config(JModelConfig(**SMALL), jspec)
    tmodel = MAVAE.from_config(ModelConfig(**SMALL), tspec, device="cpu")
    example = JBatch(obs=tuple(jnp.ones((B, len(i), od)) for (od, _), i in jspec.groups),
                     actions=tuple(jnp.zeros((B, len(i)), jnp.int32) for _, i in jspec.groups))
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(seed), example, None, jax.random.PRNGKey(1)))
    tmodel.load_state_dict(params_from_jax(variables), strict=True)
    return jspec, tspec, jmodel, variables, tmodel


def windows(jspec, seed, done=None, contacts=False):
    rng = np.random.default_rng(seed)
    obs = [rng.normal(size=(B, W, len(i), od)).astype(np.float32) for (od, _), i in jspec.groups]
    nxt = [rng.normal(size=(B, W, len(i), od)).astype(np.float32) for (od, _), i in jspec.groups]
    act = [rng.integers(0, 5, size=(B, W, len(i))).astype(np.int32) for _, i in jspec.groups]
    rew = rng.normal(size=(B, W, 3)).astype(np.float32)
    if contacts:
        rew = (10.0 * (rng.uniform(size=(B, W, 3)) < 0.3)).astype(np.float32)
    done = np.zeros((B, W), np.float32) if done is None else done
    jw = JTransition(obs=tuple(map(jnp.asarray, obs)), actions=tuple(map(jnp.asarray, act)),
                     next_obs=tuple(map(jnp.asarray, nxt)), rewards=jnp.asarray(rew), done=jnp.asarray(done))
    tw = GroupedTransition(obs=tuple(map(torch.from_numpy, obs)), actions=tuple(map(torch.from_numpy, act)),
                           next_obs=tuple(map(torch.from_numpy, nxt)), rewards=torch.from_numpy(rew),
                           done=torch.from_numpy(done))
    return jw, tw


def step_eps(key, w=W):
    """JAX's per-step draws: one key per step, then the model's normal draw."""
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(k, (B, 3, F))) for k in jax.random.split(key, w)]))


DONE = np.zeros((B, W), np.float32)
DONE[0, 0] = DONE[1, 1] = DONE[2, 0] = 1.0
UNROLL_CASES = {
    "bptt": ({}, {}, None, False, None),
    "stop_gradient": (dict(stop_gradient=True), {}, None, False, None),
    "mean_feedback": (dict(mean_feedback=True), {}, None, False, None),
    "done_mask": ({}, {}, DONE, False, None),
    "contact_weight": ({}, dict(contact_weight=2.0), DONE, True, None),
    "s_col_weight": ({}, {}, None, True, "cols"),
}


@pytest.mark.parametrize("name", sorted(UNROLL_CASES))
def test_unroll_loss_and_gradients_match_jax(name):
    fn_kw, loss_kw, done, contacts, cols = UNROLL_CASES[name]
    jspec, tspec, jmodel, variables, tmodel = build()
    jw, tw = windows(jspec, 1, done, contacts)
    w = (1.0 + 3.0 * (np.arange(sum(OBS.values())) % 4 == 0)).astype(np.float32) if cols else None
    key = jax.random.PRNGKey(7)
    jfn = j_make_unroll_loss_fn(jspec, JLossConfig(s_weight=3.0, **loss_kw), W,
                                s_col_weight=None if w is None else jnp.asarray(w), **fn_kw)
    tfn = make_unroll_loss_fn(tspec, LossConfig(s_weight=3.0, **loss_kw), W,
                              s_col_weight=None if w is None else torch.from_numpy(w), **fn_kw)
    (_, want), jgrads = jax.value_and_grad(lambda p: jfn(jmodel.apply, p, jw, key), has_aux=True)(variables)
    got = tfn(tmodel, tw, eps=step_eps(key))
    for field, t, j in zip(want._fields, got, want):
        np.testing.assert_allclose(float(t.detach()), float(j), rtol=1e-5, err_msg=field)
    got.loss.backward()
    want_g = params_from_jax(jax.device_get(jgrads))
    for n, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[n].numpy(), rtol=1e-4, atol=1e-6, err_msg=n)


def test_stop_gradient_same_loss_other_gradients():
    jspec, tspec, _, _, tmodel = build()
    _, tw = windows(jspec, 2)
    eps = step_eps(jax.random.PRNGKey(3))
    grads = []
    for sg in (False, True):
        tmodel.zero_grad()
        out = make_unroll_loss_fn(tspec, LossConfig(), W, stop_gradient=sg)(tmodel, tw, eps=eps)
        out.loss.backward()
        grads.append((float(out.loss.detach()), [p.grad.clone() for p in tmodel.parameters()]))
    assert grads[0][0] == grads[1][0]
    assert any(not torch.equal(a, b) for a, b in zip(grads[0][1], grads[1][1]))


def test_w1_is_the_one_step_elbo():
    jspec, tspec, _, _, tmodel = build()
    _, tw = windows(jspec, 3)
    tw1 = GroupedTransition(*(tuple(x[:, :1] for x in f) if isinstance(f, tuple) else f[:, :1] for f in tw))
    eps = step_eps(jax.random.PRNGKey(4), 1)
    cfg = LossConfig(s_weight=3.0)
    out = make_unroll_loss_fn(tspec, cfg, 1)(tmodel, tw1, eps=eps)
    out.loss.backward()
    g_unroll = [p.grad.clone() for p in tmodel.parameters()]
    tmodel.zero_grad()
    batch = GroupedBatch(obs=tuple(o[:, 0] for o in tw.obs), actions=tuple(a[:, 0] for a in tw.actions))
    s, r, mu, lv = tmodel(batch, eps=eps[0])
    want = elbo_losses(s, r, agent_order_concat(tspec, tuple(o[:, 0] for o in tw.next_obs)), tw.rewards[:, 0],
                       mu, lv, cfg)
    want.loss.backward()
    for field, a, b in zip(want._fields, out, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0, msg=field)
    for a, p in zip(g_unroll, tmodel.parameters()):
        torch.testing.assert_close(a, p.grad, rtol=1e-6, atol=1e-9)


def test_popart_and_pallas_refused_as_in_jax():
    jspec, tspec, *_ = build()
    for kw in (dict(mode="POPART"), dict(use_pallas=True)):
        with pytest.raises(NotImplementedError):
            j_make_unroll_train_step(jspec, JLossConfig(), 4, **kw)
    with pytest.raises(NotImplementedError):
        make_unroll_train_step(tspec, LossConfig(), 4, mode="POPART")
    make_unroll_train_step(tspec, LossConfig(), 4, use_pallas=True)  # the port's widening
    with pytest.raises(ValueError, match="use_pallas"):  # the kernel route keeps the one-step guards
        make_unroll_train_step(tspec, LossConfig(free_bits=0.1), 4, use_pallas=True)


# --------------------------------------------------- the kernel route
ROUTE_CASES = {  # name -> (loss-fn options, latent structure)
    "bptt": ({}, "private"),
    "stop_gradient": (dict(stop_gradient=True), "private"),
    "mean_feedback": (dict(mean_feedback=True), "private"),
    "shared_latent": ({}, "shared_private"),
    "shared_latent_mean_feedback_stop_gradient": (dict(mean_feedback=True, stop_gradient=True), "shared_private"),
}


def _route_inputs(latent: str, seed: int = 11):
    """A torch-only model from a seeded init and windows with episode ends
    inside them (``DONE``), with the per-step eps of both latents."""
    tspec = AgentSpec.from_dicts(AGENTS, OBS, {a: 5 for a in AGENTS})
    torch.manual_seed(seed)
    model = MAVAE.from_config(ModelConfig(**SMALL, latent_structure=latent), tspec, device="cpu")
    _, tw = windows(JSpec.from_dicts(AGENTS, OBS, {a: 5 for a in AGENTS}), seed, DONE)
    g = torch.Generator().manual_seed(seed)
    eps = torch.randn(W, B, 3, F, generator=g)
    eps_s = torch.randn(W, B, model.shared_latent, generator=g) if model.shared else None
    return tspec, model, tw, eps, eps_s


@pytest.mark.parametrize("name", sorted(ROUTE_CASES))
def test_kernel_route_equals_the_plain_route(name):
    kw, latent = ROUTE_CASES[name]
    tspec, model, tw, eps, eps_s = _route_inputs(latent)
    cfg = LossConfig(s_weight=3.0)
    got = {}
    for pallas in (False, True):
        m = copy.deepcopy(model)
        out = make_unroll_loss_fn(tspec, cfg, W, use_pallas=pallas, **kw)(m, tw, eps=eps, eps_shared=eps_s)
        out.loss.backward()
        state = create_train_state(copy.deepcopy(model), TrainConfig(grad_clip=0.5))
        state, _ = make_unroll_train_step(tspec, cfg, W, use_pallas=pallas, **kw)(state, tw, eps=eps,
                                                                                  eps_shared=eps_s)
        got[pallas] = ([x.detach() for x in out], {n: p.grad for n, p in m.named_parameters()},
                       state.model.state_dict())
    (plain_l, plain_g, plain_p), (k_l, k_g, k_p) = got[False], got[True]
    for field, a, b in zip(("loss", "s_loss", "r_loss", "kl_loss"), k_l, plain_l):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0, msg=field)
    for n, g in plain_g.items():
        assert float(torch.linalg.vector_norm(k_g[n] - g)) <= 1e-6 * float(torch.linalg.vector_norm(g)), n
    for n, p in plain_p.items():
        torch.testing.assert_close(k_p[n], p, rtol=1e-6, atol=1e-5, msg=n)


def test_one_unroll_adam_step_matches_jax():
    jspec, tspec, jmodel, variables, tmodel = build()
    jw, tw = windows(jspec, 5, DONE)
    key = jax.random.PRNGKey(6)
    jstate = j_create_train_state(jmodel, variables, JTrainConfig(grad_clip=0.5))
    s1, o1 = jax.jit(j_make_unroll_train_step(jspec, JLossConfig(s_weight=3.0), W, mean_feedback=True))(jstate, jw, key)
    state = create_train_state(tmodel, TrainConfig(grad_clip=0.5))
    state, o2 = make_unroll_train_step(tspec, LossConfig(s_weight=3.0), W, mean_feedback=True)(
        state, tw, eps=step_eps(key))
    assert state.step == 1
    for field in ("loss", "s_loss", "r_loss", "kl_loss"):
        np.testing.assert_allclose(float(getattr(o2, field)), float(getattr(o1, field)), rtol=1e-4, atol=1e-5,
                                   err_msg=field)
    want = params_from_jax(jax.device_get(s1.params))
    for n, p in state.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[n].numpy(), rtol=1e-4, atol=1e-5, err_msg=n)
