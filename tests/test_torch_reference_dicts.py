"""The port's MAVAE on the reference's per-agent dicts against the JAX
MAVAE (``mfvae_tpu/models/mavae.py`` ``__call__``'s dict branch and
``group_dict_batch``), the cases of ``tests/test_model.py`` held against
JAX's own outputs.

Parameters come from the JAX ``model.init`` through ``params_from_jax``;
eps (and the shared latent's eps) are the draws the JAX model makes from
its key.  Both run at float32: JAX's matmul precision "highest"
(tests/conftest.py), torch's TF32 off.  Tolerances: rtol 1e-5 / atol 1e-6
for outputs; JAX's own rtol 1e-4 where the fused route's KL sum is held
against ``kl_gaussian`` of the plain call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfvae_tpu.config import LossConfig as JLossConfig
from mfvae_tpu.config import ModelConfig as JModelConfig
from mfvae_tpu.data import transitions as jtr
from mfvae_tpu.models import losses as jlosses
from mfvae_tpu.models.mavae import MAVAE as JMAVAE
from mfvae_tpu.models.mavae import AgentSpec as JSpec
from mfvae_tpu.models.mavae import group_dict_batch as j_group_dict_batch
from mfvae_tpu_torch.config import LossConfig, ModelConfig
from mfvae_tpu_torch.data import compat
from mfvae_tpu_torch.data import transitions as tr
from mfvae_tpu_torch.envs.mpe import SimpleTagEnv
from mfvae_tpu_torch.models import losses
from mfvae_tpu_torch.models.convert import params_from_jax
from mfvae_tpu_torch.models.mavae import MAVAE, AgentSpec, GroupedBatch, group_dict_batch
from tests.test_torch_experiment import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
KL_RTOL = 1e-4
B = 4
SMALL = dict(idx_features=8, obs_features=8, action_features=8, encoder_hidden=(16,),
             decoder_hidden=(32, 16), compute_dtype="float32")
# test_model.py's tiny_spec (grouped order is agent order) and one with a
# good agent between the adversaries (grouped order is not agent order)
SPECS = {
    "grouped": tuple(f"adversary_{i}" for i in range(3)) + ("agent_0", "agent_1"),
    "interleaved": ("adversary_0", "agent_0", "adversary_1", "agent_1", "adversary_2"),
}


@pytest.fixture(autouse=True)
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def specs(agents, obs=None):
    obs = obs or {a: (10 if a.startswith("adv") else 8) for a in agents}
    act = {a: 5 for a in agents}
    return JSpec.from_dicts(agents, obs, act), AgentSpec.from_dicts(agents, obs, act)


def make_dicts(spec, ids=None, seed=0):
    """(JAX dicts, port dicts) of test_model.py's make_dict_batch: column 0
    holds ``ids[i]`` (default: the agent's position)."""
    rng = np.random.default_rng(seed)
    ids = list(range(spec.n_agents)) if ids is None else ids
    idx_np, act_np = {}, {}
    for i, a in enumerate(spec.agents):
        obs = rng.normal(size=(B, spec.obs_dim_map[a])).astype(np.float32)
        idx_np[a] = np.concatenate([np.full((B, 1), ids[i], np.float32), obs], axis=1)
        act_np[a] = rng.integers(0, spec.act_dim_map[a], size=(B,)).astype(np.int32)
    j = ({a: jnp.asarray(v) for a, v in idx_np.items()}, {a: jnp.asarray(v) for a, v in act_np.items()})
    t = ({a: torch.from_numpy(v) for a, v in idx_np.items()}, {a: torch.from_numpy(v) for a, v in act_np.items()})
    return j, t


def build(agents, obs=None, **cfg):
    jspec, tspec = specs(agents, obs)
    jmodel = JMAVAE.from_config(JModelConfig(**SMALL, **cfg), jspec)
    tmodel = MAVAE.from_config(ModelConfig(**SMALL, **cfg), tspec, device="cpu")
    (jidx, jact), _ = make_dicts(jspec)
    variables = jmodel.init(jax.random.PRNGKey(0), jidx, jact, jax.random.PRNGKey(1))
    tmodel.load_state_dict(params_from_jax(jax.device_get(variables)))
    return jmodel, variables, tmodel, jspec, tspec


def draws(jmodel, variables, key, n_agents):
    """(eps [B, A, F], eps_shared [B, S] or None): the JAX call's draws
    from ``key`` (the shared one from fold_in(key, 1))."""
    eps = np.array(jmodel.apply(variables, key, (B, n_agents, jmodel.obs_features),
                                method=lambda m, k, s: m._eps(k, s)))
    shared = None
    if jmodel.latent_structure == "shared_private":
        shared = torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, 1),
                                                             (B, jmodel.shared_latent))))
    return torch.from_numpy(eps), shared


def close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


CASES = {"private": {}, "shared_private": dict(latent_structure="shared_private", shared_latent=8)}


@pytest.mark.parametrize("spec_name", sorted(SPECS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_dict_and_grouped_paths_agree(spec_name, case):
    """test_model.py:97: the dict call equals the grouped call (bit-equal
    in the port), and both equal JAX's dict call."""
    jmodel, variables, tmodel, jspec, tspec = build(SPECS[spec_name], **CASES[case])
    (jidx, jact), (idx, act) = make_dicts(jspec, seed=1)
    key = jax.random.PRNGKey(2)
    eps, eps_s = draws(jmodel, variables, key, jspec.n_agents)
    out_d = tmodel(idx, act, None, eps, eps_s)
    out_g = tmodel(group_dict_batch(tspec, idx, act)[0], None, None, eps, eps_s)
    want = jmodel.apply(variables, jidx, jact, key)
    for d, g, j in zip(out_d, out_g, want):
        torch.testing.assert_close(d, g, rtol=0, atol=0)
        close(d, j)
    if case == "shared_private":
        assert out_d[2].shape == (B, jspec.n_agents * jmodel.obs_features + 8)


def test_group_dict_batch_matches_jax():
    jspec, tspec = specs(SPECS["interleaved"])
    (jidx, jact), (idx, act) = make_dicts(jspec)
    jb, jids = j_group_dict_batch(jspec, jidx, jact)
    tb, tids = group_dict_batch(tspec, idx, act)
    assert isinstance(tb, GroupedBatch)
    for x, y in zip(tb.obs + tb.actions + tids, jb.obs + jb.actions + jids):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert all(i.dtype == torch.int32 for i in tids)
    assert tspec.obs_dim_map == jspec.obs_dim_map and tspec.act_dim_map == jspec.act_dim_map


@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_mu_is_agent_major_order(spec_name):
    """test_model.py:114: mu of the dict call is the agent-order concat of
    the encoder's per-agent mu (jax_ver/model.py:195)."""
    jmodel, variables, tmodel, jspec, tspec = build(SPECS[spec_name])
    (jidx, jact), (idx, act) = make_dicts(jspec, seed=3)
    key = jax.random.PRNGKey(2)
    eps, _ = draws(jmodel, variables, key, jspec.n_agents)
    mu_flat = tmodel(idx, act, None, eps)[2]
    mu_g = tmodel.encode(*group_dict_batch(tspec, idx, act))[0]
    agent_order = mu_g[:, list(tspec.perm_from_grouped)]
    torch.testing.assert_close(mu_flat, agent_order.reshape(B, -1), rtol=0, atol=0)
    close(mu_flat, jmodel.apply(variables, jidx, jact, key)[2])


def test_shared_latent_sees_every_agent():
    """test_model.py:232: bumping any one agent's row moves the shared
    posterior mean, by JAX's amount.  As in that test the bump moves
    column 0 too: the last agent's id then lies past the table, and both
    packages read NaN for it (``Embedding.take``)."""
    jmodel, variables, tmodel, jspec, tspec = build(SPECS["interleaved"], **CASES["shared_private"])
    (jidx, jact), (idx, act) = make_dicts(jspec, seed=4)

    def port_mu(idx_state):
        experts = tmodel.encode(*group_dict_batch(tspec, idx_state, act))[3]
        return MAVAE.poe(experts)[0]

    def jax_mu(idx_state):
        batch, ids = j_group_dict_batch(jspec, idx_state, jact)
        experts = jmodel.apply(variables, batch, ids, method=lambda m, b, i: m.encode(b, i))[3]
        return JMAVAE.poe(experts)[0]

    base = port_mu(idx)
    close(base, jax_mu(jidx))
    for agent in tspec.agents:
        bumped = port_mu({**idx, agent: idx[agent] + 1.0})
        close(bumped, jax_mu({**jidx, agent: jidx[agent] + 1.0}))
        assert not torch.allclose(bumped, base), agent


def test_fused_call_on_group_dict_batch_covers_shared_kl():
    """test_model.py:276: fused_call on group_dict_batch's ids appends the
    shared KL column; its rows equal JAX's, and their mean sum equals
    kl_gaussian over the dict call's extended contract."""
    jmodel, variables, tmodel, jspec, tspec = build(SPECS["grouped"], **CASES["shared_private"])
    (jidx, jact), (idx, act) = make_dicts(jspec, seed=5)
    key = jax.random.PRNGKey(2)
    eps, eps_s = draws(jmodel, variables, key, jspec.n_agents)
    rs, rr, kl_rows = tmodel.fused_call(*group_dict_batch(tspec, idx, act), eps=eps, eps_shared=eps_s)
    assert kl_rows.shape == (B, jspec.n_agents + 1)
    jb, jids = j_group_dict_batch(jspec, jidx, jact)
    for t, j in zip((rs, rr, kl_rows), jmodel.apply(variables, jb, jids, key, method="fused_call")):
        close(t, j)
    _, _, mu, lv = tmodel(idx, act, None, eps, eps_s)
    got = float(torch.mean(torch.sum(kl_rows.detach(), dim=1)))
    np.testing.assert_allclose(got, float(losses.kl_gaussian(mu, lv).detach()), rtol=KL_RTOL)
    _, _, jmu, jlv = jmodel.apply(variables, jidx, jact, key)
    np.testing.assert_allclose(got, float(jlosses.kl_gaussian(jmu, jlv)), rtol=KL_RTOL)


def test_det_path_with_the_fused_route():
    """test_model.py:350: det_features > 0, fused_call on the dict batch's
    ids against JAX's and against the plain dict call."""
    jmodel, variables, tmodel, jspec, tspec = build(SPECS["interleaved"], det_features=16)
    (jidx, jact), (idx, act) = make_dicts(jspec, seed=6)
    key = jax.random.PRNGKey(2)
    eps, _ = draws(jmodel, variables, key, jspec.n_agents)
    rs, rr, kl_rows = tmodel.fused_call(*group_dict_batch(tspec, idx, act), eps=eps)
    jb, jids = j_group_dict_batch(jspec, jidx, jact)
    for t, j in zip((rs, rr, kl_rows), jmodel.apply(variables, jb, jids, key, method="fused_call")):
        close(t, j)
    rs2, rr2, mu, lv = tmodel(idx, act, None, eps)
    for t, j in zip((rs2, rr2, mu, lv), jmodel.apply(variables, jidx, jact, key)):
        close(t, j)
    torch.testing.assert_close(rs, rs2, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(float(torch.mean(torch.sum(kl_rows.detach(), dim=1))),
                               float(losses.kl_gaussian(mu, lv).detach()), rtol=KL_RTOL)


@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_ids_read_from_the_data(spec_name):
    """Column 0 need not be the agent's position: the ids are read by
    floor (2.7 -> 2) and select the embedding rows, as in JAX; the outputs
    then differ from the positional call's."""
    jmodel, variables, tmodel, jspec, tspec = build(SPECS[spec_name])
    n = jspec.n_agents
    ids = [float((n - 1 - i) % n) + 0.7 for i in range(n)]  # reversed, with a fraction
    (jidx, jact), (idx, act) = make_dicts(jspec, ids=ids, seed=7)
    _, tids = group_dict_batch(tspec, idx, act)
    want_ids = [[int(np.floor(ids[i])) for i in idxs] for _, idxs in tspec.groups]
    for got, want in zip(tids, want_ids):
        assert got.tolist() == [want] * B
    key = jax.random.PRNGKey(2)
    eps, _ = draws(jmodel, variables, key, n)
    out = tmodel(idx, act, None, eps)
    for t, j in zip(out, jmodel.apply(variables, jidx, jact, key)):
        close(t, j)
    jb, jids = j_group_dict_batch(jspec, jidx, jact)
    fused = tmodel.fused_call(*group_dict_batch(tspec, idx, act), eps=eps)
    for t, j in zip(fused, jmodel.apply(variables, jb, jids, key, method="fused_call")):
        close(t, j)
    positional = tmodel(group_dict_batch(tspec, idx, act)[0], None, None, eps)
    assert not torch.allclose(out[0], positional[0])


def test_embedding_take_follows_jnp_take():
    """Ids read from data keep jnp.take's rule: a negative id counts from
    the end, an id past the table gives NaN rows."""
    from mfvae_tpu_torch.models.layers import Embedding

    emb = Embedding(5, 3, device="cpu", generator=torch.Generator().manual_seed(0))
    ids = torch.tensor([[0, 4, 5], [-1, 7, -6]], dtype=torch.int32)
    want = jnp.take(jnp.asarray(emb.embedding.detach().numpy()), jnp.asarray(ids.numpy()), axis=0)
    np.testing.assert_array_equal(emb.take(ids).detach().numpy(), np.asarray(want))
    assert torch.isnan(emb.take(ids)[0, 2]).all() and not torch.isnan(emb.take(ids)[1, 0]).any()


POP = dict(num_good_agents=1, num_adversaries=2, num_obs=1, max_steps=50)


def test_reference_style_step():
    """TransitionBuffer -> create_dataset -> model(dicts) -> the reference's
    legacy loss and the jax-family ELBO, against JAX's on the same rows."""
    env = SimpleTagEnv(device="cpu", **POP)
    g = torch.Generator().manual_seed(0)
    obs, state = env.reset(g)
    buf = compat.TransitionBuffer(max_length=64, min_length=8, batch_size=B)
    for t in range(12):
        acts = {a: torch.randint(0, 5, (), generator=g, dtype=torch.int32) for a in env.agents}
        nobs, state, rew, done, _ = env.step(state, acts)
        (buf.add_trans if t else buf.init_buffer)(obs, rew, acts, nobs, done)
        obs = nobs
    rows = buf.sample(torch.Generator().manual_seed(1)).experience
    codebook = {a: i for i, a in enumerate(env.agents)}
    idx, act, rewards, next_states = tr.create_dataset(rows, codebook)
    jidx, jact, jrew, jnext = jtr.create_dataset({k: jnp.asarray(v.numpy()) for k, v in rows.items()}, codebook)

    dims = {a: env.obs_dim(a) for a in env.agents}
    jmodel, variables, tmodel, jspec, tspec = build(tuple(env.agents), dims)
    key = jax.random.PRNGKey(3)
    eps, _ = draws(jmodel, variables, key, jspec.n_agents)
    out = tmodel(idx, act, None, eps)
    want = jmodel.apply(variables, jidx, jact, key)
    for t, j in zip(out, want):
        close(t, j)
    rs, rr, mu, lv = out
    jrs, jrr, jmu, jlv = want
    close(losses.legacy_vae_loss(next_states, rs, mu, lv), jlosses.legacy_vae_loss(jnext, jrs, jmu, jlv))
    got = losses.elbo_losses(rs, rr, next_states, rewards, mu, lv, LossConfig())
    for t, j in zip(got, jlosses.elbo_losses(jrs, jrr, jnext, jrew, jmu, jlv, JLossConfig())):
        close(t, j)
