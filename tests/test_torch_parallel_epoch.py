"""The sharded epoch against the port's unsharded batched epoch, over real
gloo ranks on the CPU (``spawn_ranks``, tests/test_torch_parallel.py).

The rule: with ``mesh.enable`` the run equals the unsharded batched run at
the same ``n_envs``, up to the order of the sums over ranks (the JAX
package's SPMD program behaves so; tests/test_dp_epoch.py holds its TP
epoch to the single-device run at rtol 2e-3).  At float32 and these sizes
the sums over two ranks differ from one rank's by a few ulps, so:

- data parallel, 2 ranks, n_envs 4 (random, pursuit with POPART,
  episode_mix with contact_weight, the kernels' route, sticky with unroll
  4): every epoch's losses within rtol 1e-5 of the unsharded run, the
  parameters bit-equal across the ranks, and within rtol 1e-5 / atol 1e-6
  of the unsharded run's;
- a checkpoint on the mesh resumes at epoch 2 with the parameters it saved
  and continues as the unsharded run does;
- tensor parallel at model_axis 2 (groups 2/2, as tests/test_dp_epoch.py):
  one train step's gradients, gathered whole, within rtol 1e-5 / atol
  1e-7 of the unsharded step's (a gradient doubled by the collectives'
  backward fails this), with and without the clip, fused and unfused
  decoders with LayerNorm, det_features and the shared latent, plain and
  kernel routes, remat; its epochs within rtol 2e-3 (discrete and
  continuous actions) and its resume exact;
- data × tensor parallel on 4 ranks (2 × 2): the epoch within rtol 2e-3.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from mfvae_tpu_torch.parallel import tp
from mfvae_tpu_torch.training.experiment import Experiment
from mfvae_tpu_torch.training.trainer import make_train_step
from tests.test_torch_experiment import one_torch_thread  # noqa: F401
from tests.test_torch_parallel import numpy_batch, small_cfg, spawn_ranks, vae_batch

DP_RUNS = {
    "random": {},
    "pursuit_popart": dict(train__collect_policy="pursuit", train__mode="POPART", train__popart_beta=0.3),
    "episode_mix_contact": dict(train__collect_policy="episode_mix", loss__contact_weight=1.0,
                                loss__contact_threshold=-10.0),
    "kernels": dict(model__use_pallas=True),
    "sticky_unroll": dict(train__collect_policy="sticky", train__unroll_steps=4, buffer__max_size=512),
}
TP_GRADS = {
    "fused": {},
    "fused_kernels": dict(model__use_pallas=True),
    "unfused_layernorm": dict(model__fused_decoders=False, model__decoder_layernorm=True, model__det_features=4,
                              model__latent_structure="shared_private", model__shared_latent=4),
    "remat": dict(model__remat=True),
}


def whole_params(exp) -> dict:
    model = exp.carry.train_state.model
    if tp.is_sharded(model):
        return tp.full_state_dict(model, exp.mesh)
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def epoch_losses(exp) -> list:
    out = []
    for _ in range(exp.cfg.train.epoch_num):
        m = exp.run_epoch()
        out.append([float(x) for x in (*m.train, *m.test)])
    return out


def step_grads(exp, clip: float) -> dict:
    """One train step from a copy of the state after setup on a numpy
    batch, eps given: the loss and the whole gradients after the clip."""
    cfg, spec = exp.cfg, exp.spec
    b = cfg.buffer.batch_size
    nb = numpy_batch(spec, b, seed=4)
    rng = np.random.default_rng(3)
    eps = torch.from_numpy(rng.normal(size=(b, spec.n_agents, cfg.model.obs_features)).astype(np.float32))
    eps_s = torch.from_numpy(rng.normal(size=(b, cfg.model.shared_latent)).astype(np.float32))
    state = copy.deepcopy(exp.carry.train_state)
    state.grad_clip = clip
    step = make_train_step(cfg.loss, cfg.train.mode, use_pallas=cfg.model.use_pallas, mesh=exp.mesh)
    _, out = step(state, vae_batch(nb), None, eps, eps_s if state.model.shared else None)
    return {"loss": float(out.loss), "grads": {
        n: p.grad.clone() if d is None else exp.mesh.all_gather(p.grad, "model", d)
        for (n, p), d in zip(state.model.named_parameters(), tp.split_dims(state.model))}}


def _dp_rank(rank, tmp):
    out = {}
    for name, options in DP_RUNS.items():
        exp = Experiment(small_cfg(f"{tmp}/{name}{rank}", mesh__enable=True, **options), "cpu").setup()
        out[name] = {"losses": epoch_losses(exp), "params": whole_params(exp)}
    # checkpoint every epoch for 2, then resume onto the mesh for a 3rd
    cfg = small_cfg(f"{tmp}/ckpt", epochs=2, mesh__enable=True, train__checkpoint_every=1,
                    train__checkpoint_dir=f"{tmp}/ckpt/model")
    exp = Experiment(cfg, "cpu").setup()
    exp.run()
    saved = whole_params(exp)
    cfg.train.epoch_num, cfg.train.resume = 3, True
    exp = Experiment(cfg, "cpu").setup()
    out["resume"] = {"start_epoch": exp.start_epoch, "saved": saved, "restored": whole_params(exp),
                     "result": exp.run(), "params": whole_params(exp)}
    return out


@pytest.fixture(scope="module")
def dp_ranks(tmp_path_factory):
    return spawn_ranks(_dp_rank, 2, tmp_path_factory.mktemp("dp"), str(tmp_path_factory.mktemp("dp_runs")))


def _close_params(got: dict, want: dict, rtol=1e-5, atol=1e-6):
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), rtol=rtol, atol=atol, err_msg=n)


@pytest.mark.parametrize("run", sorted(DP_RUNS))
def test_dp_epochs_match_the_unsharded_run(tmp_path, dp_ranks, run):
    exp = Experiment(small_cfg(tmp_path, **DP_RUNS[run]), "cpu").setup()
    want = epoch_losses(exp)
    r0, r1 = (r[run] for r in dp_ranks)
    assert r0["losses"] == r1["losses"]
    np.testing.assert_allclose(r0["losses"], want, rtol=1e-5)
    for n, p in r0["params"].items():
        assert torch.equal(p, r1["params"][n]), n
    _close_params(r0["params"], whole_params(exp))


def test_dp_checkpoint_resumes_onto_the_mesh(tmp_path, dp_ranks):
    for r in dp_ranks:
        res = r["resume"]
        assert res["start_epoch"] == 2 and res["result"]["epoch"] == 2
        for n, p in res["saved"].items():
            assert torch.equal(p, res["restored"][n]), n
    assert dp_ranks[0]["resume"]["result"]["loss_train"] == dp_ranks[1]["resume"]["result"]["loss_train"]
    straight = Experiment(small_cfg(tmp_path, epochs=3), "cpu").setup()
    got = straight.run()
    for key in ("loss_train", "loss_test"):
        np.testing.assert_allclose(dp_ranks[0]["resume"]["result"][key], got[key], rtol=1e-5)
    _close_params(dp_ranks[0]["resume"]["params"], whole_params(straight))


# --------------------------------------------------------- tensor parallel
TP = dict(mesh__enable=True, mesh__model_axis=2, mesh__data_axis=1)
CONTINUOUS = dict(env__discrete_actions=False, model__discrete_act=False)


def _tp_rank(rank, tmp):
    out = {"grads": {}}
    for name, options in TP_GRADS.items():
        exp = Experiment(small_cfg(f"{tmp}/g{name}{rank}", **TP, **options), "cpu").setup()
        out["grads"][name] = {clip: step_grads(exp, clip) for clip in (0.0, 0.05)}
        out[f"split {name}"] = sorted(n for n, d in exp.carry.train_state.model.tp_dims.items() if d is not None)
    out["epoch"] = epoch_losses(Experiment(small_cfg(f"{tmp}/epoch{rank}", **TP), "cpu").setup())
    out["continuous"] = epoch_losses(Experiment(small_cfg(f"{tmp}/cont{rank}", **TP, **CONTINUOUS), "cpu").setup())
    cfg = small_cfg(f"{tmp}/ckpt", epochs=1, train__checkpoint_every=1, train__checkpoint_dir=f"{tmp}/ckpt/m", **TP)
    Experiment(cfg, "cpu").setup().run()
    cfg.train.epoch_num, cfg.train.resume = 2, True
    out["resumed"] = Experiment(cfg, "cpu").setup().run()
    out["straight"] = Experiment(small_cfg(f"{tmp}/straight{rank}", **TP), "cpu").setup().run()
    return out


@pytest.fixture(scope="module")
def tp_ranks(tmp_path_factory):
    return spawn_ranks(_tp_rank, 2, tmp_path_factory.mktemp("tp"), str(tmp_path_factory.mktemp("tp_runs")))


@pytest.mark.parametrize("clip", [0.0, 0.05])
@pytest.mark.parametrize("variant", sorted(TP_GRADS))
def test_tp_gradients_equal_the_unsharded_ones(tmp_path, tp_ranks, variant, clip):
    exp = Experiment(small_cfg(tmp_path, **TP_GRADS[variant]), "cpu").setup()
    want = step_grads(exp, clip)
    assert len(tp_ranks[0][f"split {variant}"]) >= 8, tp_ranks[0][f"split {variant}"]
    for r in tp_ranks:
        got = r["grads"][variant][clip]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        assert set(got["grads"]) == set(want["grads"])
        for n, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][n].numpy(), g.numpy(), rtol=1e-5, atol=1e-7, err_msg=n)


@pytest.mark.parametrize("run", ["epoch", "continuous"])
def test_tp_epochs_match_the_unsharded_run(tmp_path, tp_ranks, run):
    want = epoch_losses(Experiment(small_cfg(tmp_path, **(CONTINUOUS if run == "continuous" else {})), "cpu").setup())
    assert tp_ranks[0][run] == tp_ranks[1][run]
    np.testing.assert_allclose(tp_ranks[0][run], want, rtol=2e-3)


def test_tp_checkpoint_resumes_exactly(tp_ranks):
    for r in tp_ranks:
        assert r["resumed"]["epoch"] == 1
        assert (r["resumed"]["loss_train"], r["resumed"]["loss_test"]) == (
            r["straight"]["loss_train"], r["straight"]["loss_test"])


def _dp_tp_rank(rank, tmp):
    exp = Experiment(small_cfg(f"{tmp}/{rank}", mesh__enable=True, mesh__model_axis=2), "cpu").setup()
    return {"mesh": dict(exp.mesh.shape), "losses": epoch_losses(exp), "params": whole_params(exp)}


def test_dp_by_tp_on_four_ranks(tmp_path):
    ranks = spawn_ranks(_dp_tp_rank, 4, tmp_path / "out", str(tmp_path / "runs"))
    exp = Experiment(small_cfg(tmp_path / "ref"), "cpu").setup()
    want = epoch_losses(exp)
    assert ranks[0]["mesh"] == {"data": 2, "model": 2}
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want, rtol=2e-3)
        _close_params(r["params"], ranks[0]["params"], rtol=0, atol=0)
    _close_params(ranks[0]["params"], whole_params(exp), rtol=2e-3, atol=1e-5)
