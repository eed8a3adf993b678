"""The VAE families (``mfvae_tpu_torch/models/vae.py``, ``factorized.py``,
``training/vae_trainer.py``, ``vae_experiment.py``, ``data/synthetic.py``)
against the JAX package's.

Each model gets the JAX package's params through ``models/convert.py`` and
the JAX package's eps (drawn from its keys), so the two compute the same
function:

- forward outputs, the losses and every grad at rtol 1e-5 in float32
  (atol 1e-6 of the leaf's largest: sums that cancel), and at rtol 2^-7
  for ``ConvVAE`` in bf16;
- one Adam step of each family's train step: params at rtol 1e-5;
- ``sprites`` and ``correlated_modalities`` on JAX's draws within 1e-6;
- ``legacy_vae_loss`` and the product of experts at rtol 1e-6.

The seed bands of whole runs are in tests/test_torch_goldens.py.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfvae_tpu.data import synthetic as jsyn
from mfvae_tpu.models import factorized as jfac
from mfvae_tpu.models import vae as jvae
from mfvae_tpu.models.losses import legacy_vae_loss as j_legacy_vae_loss
from mfvae_tpu.training import vae_trainer as jtrainer
from mfvae_tpu_torch.data import synthetic
from mfvae_tpu_torch.models import convert
from mfvae_tpu_torch.models.factorized import FactorizedMultimodalVAE, product_of_experts
from mfvae_tpu_torch.models.losses import legacy_vae_loss
from mfvae_tpu_torch.models.vae import VAE, ConvVAE
from mfvae_tpu_torch.training import vae_experiment
from mfvae_tpu_torch.training.vae_trainer import create_vae_state, make_vae_train_step
from tests.test_torch_experiment import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
BF16_RTOL = 2.0 ** -7


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, rtol=1e-5, atol_frac=1e-6):
    want = np.asarray(want, np.float32)
    atol = atol_frac * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=rtol, atol=atol)


def normal(key, shape):
    return np.asarray(jax.random.normal(key, shape))


# each case -> (JAX model, port model from JAX params, JAX input, port input, eps from a JAX key)
def mlp_case(dtype="float32"):
    jm = jvae.VAE(in_dim=12, latent_dim=4, encoder_hidden=(16,), decoder_hidden=(16, 8))
    x = np.random.default_rng(0).normal(size=(6, 12)).astype(np.float32)

    def port(params):
        m = VAE(12, 4, (16,), (16, 8))
        m.load_state_dict(convert.vae_params_from_jax(params))
        return m

    def eps(key):
        return normal(key, (6, 4))

    return jm, port, jnp.asarray(x), t(x), eps


def conv_case(dtype="float32"):
    jdt = jnp.dtype(dtype)
    jm = jvae.ConvVAE(image_shape=(8, 8, 2), latent_dim=3, channels=(4, 6), dtype=jdt)
    x = np.random.default_rng(1).uniform(size=(3, 8, 8, 2)).astype(np.float32)

    def port(params):
        m = ConvVAE((8, 8, 2), 3, (4, 6), dtype=getattr(torch, dtype))
        m.load_state_dict(convert.conv_vae_params_from_jax(params))
        return m

    def eps(key):
        return normal(key, (3, 3))

    return jm, port, jnp.asarray(x), t(x), eps


def factorized_case(dtype="float32"):
    jm = jfac.FactorizedMultimodalVAE(modality_dims=(6, 4), shared_latent=3, private_latent=2,
                                      encoder_hidden=(8,), decoder_hidden=(8,))
    rng = np.random.default_rng(2)
    xs = (rng.normal(size=(5, 6)).astype(np.float32), rng.normal(size=(5, 4)).astype(np.float32))

    def port(params):
        m = FactorizedMultimodalVAE((6, 4), 3, 2, (8,), (8,))
        m.load_state_dict(convert.factorized_params_from_jax(params))
        return m

    def eps(key):  # JAX's split: the shared latent's key first, then each modality's
        keys = jax.random.split(key, 3)
        return [normal(keys[0], (5, 3)), normal(keys[1], (5, 2)), normal(keys[2], (5, 2))]

    return jm, port, tuple(jnp.asarray(x) for x in xs), tuple(t(x) for x in xs), eps


CASES = {"mlp": mlp_case, "conv": conv_case, "factorized": factorized_case}
BRIDGES = {"mlp": convert.vae_params_from_jax, "conv": convert.conv_vae_params_from_jax,
           "factorized": convert.factorized_params_from_jax}


def _eps_t(e):
    return [t(x) for x in e] if isinstance(e, list) else t(e)


def _outputs(out):
    recon, mu, lv = out
    return (list(recon) if isinstance(recon, (list, tuple)) else [recon]) + [mu, lv]


@pytest.mark.parametrize("family,dtype", [("mlp", "float32"), ("conv", "float32"), ("conv", "bfloat16"),
                                          ("factorized", "float32")])
def test_forward_losses_and_grads_match_jax(family, dtype):
    jm, port, jx, x, eps_fn = CASES[family](dtype)
    key = jax.random.PRNGKey(5)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jx, key)
    model = port(jax.device_get(variables))
    rtol = BF16_RTOL if dtype == "bfloat16" else 1e-5
    multimodal = isinstance(x, tuple)

    jstep = jtrainer.make_vae_train_step(kl_weight=0.5, use_huber=True)

    @jax.jit
    def reference(params):
        def loss(p):
            return jstep.eval_step(jtrainer.create_vae_state(jm, p), jx, key)

        return jm.apply(params, jx, key), loss(params), jax.grad(lambda p: loss(p).loss)(params)

    jout, jl, jgrads = reference(variables)

    eps = _eps_t(eps_fn(key))
    batch = list(x) if multimodal else x
    for got, want in zip(_outputs(model(batch, None, eps)), _outputs(jout)):
        close(got, want, rtol)
    # a step at lr 0 leaves the grads of the training loss on the params
    _, loss = make_vae_train_step(kl_weight=0.5, use_huber=True)(create_vae_state(model, lr=0.0), batch, None, eps)
    for got, want in zip(loss, jl):
        close(got, want, rtol)
    want_grads = BRIDGES[family](jax.device_get(jgrads))
    named = dict(model.named_parameters())
    assert set(named) == set(want_grads)
    for name, want in want_grads.items():
        close(named[name].grad, want.numpy(), rtol, atol_frac=1e-5 if dtype == "float32" else BF16_RTOL)


@pytest.mark.parametrize("family", sorted(CASES))
def test_one_adam_step_matches_jax(family):
    jm, port, jx, x, eps_fn = CASES[family]()
    key = jax.random.PRNGKey(9)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(1), jx, key)
    model = port(jax.device_get(variables))
    jstep = jax.jit(jtrainer.make_vae_train_step(kl_weight=1.0, kl_anneal_steps=4, free_bits=0.05))
    jstate = jtrainer.create_vae_state(jm, variables, lr=1e-2)
    step = make_vae_train_step(kl_weight=1.0, kl_anneal_steps=4, free_bits=0.05)
    state = create_vae_state(model, lr=1e-2)
    batch = list(x) if isinstance(x, tuple) else x
    for i in range(2):  # the second step anneals the KL by 1/4
        k = jax.random.fold_in(key, i)
        jstate, jl = jstep(jstate, jx, k)
        _, loss = step(state, batch, None, _eps_t(eps_fn(k)))
        for got, want in zip(loss, jl):
            close(got, want)
    assert state.step == int(jstate.step) == 2
    for name, want in BRIDGES[family](jax.device_get(jstate.params)).items():
        close(dict(model.named_parameters())[name], want.numpy())


def test_sprites_match_jax_draws():
    key = jax.random.PRNGKey(3)
    k_pos, k_wh, k_col = jax.random.split(key, 3)
    b, size, c = 5, 16, 3
    pos = jax.random.uniform(k_pos, (b, 2, 2), minval=0.0, maxval=1.0)
    wh = jax.random.uniform(k_wh, (b, 2, 2), minval=0.15, maxval=0.45)
    color = jax.random.uniform(k_col, (b, 2, c), minval=0.4, maxval=1.0)
    want = np.asarray(jsyn.sprites(key, b, size, c))
    got = synthetic.sprites(None, b, size, c, pos=t(pos), wh=t(wh), color=t(color))
    assert got.shape == (b, size, size, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    drawn = synthetic.sprites(torch.Generator().manual_seed(0), b, size, c)
    assert float(drawn.min()) >= 0.0 and float(drawn.max()) <= 1.0 and float(drawn.max()) > 0.0


def test_correlated_modalities_match_jax_draws():
    key = jax.random.PRNGKey(4)
    keys = jax.random.split(key, 5)
    b, da, db, s = 7, 32, 16, 8
    draws = dict(src=normal(keys[0], (b, s)), wa=normal(keys[1], (s, da)), wb=normal(keys[2], (s, db)),
                 noise_a=normal(keys[3], (b, da)), noise_b=normal(keys[4], (b, db)))
    xa, xb = jsyn.correlated_modalities(key, b, da, db)
    ga, gb = synthetic.correlated_modalities(None, b, da, db, **{k: t(v) for k, v in draws.items()})
    np.testing.assert_allclose(ga.numpy(), np.asarray(xa), rtol=0, atol=1e-6)
    np.testing.assert_allclose(gb.numpy(), np.asarray(xb), rtol=0, atol=1e-6)


def test_legacy_vae_loss_and_poe_match_jax():
    rng = np.random.default_rng(6)
    y, y_hat, mu, lv = (rng.normal(size=(4, 9)).astype(np.float32) for _ in range(4))
    close(legacy_vae_loss(t(y), t(y_hat), t(mu), t(lv)), j_legacy_vae_loss(y, y_hat, mu, lv), rtol=1e-6)
    close(legacy_vae_loss(t(y), t(y_hat), t(mu), t(lv), 0.3), j_legacy_vae_loss(y, y_hat, mu, lv, 0.3), rtol=1e-6)
    mus = [rng.normal(size=(3, 5)).astype(np.float32) for _ in range(2)]
    lvs = [rng.normal(size=(3, 5)).astype(np.float32) for _ in range(2)]
    jm, jl = jfac.product_of_experts(mus, lvs)
    m, lvv = product_of_experts([t(x) for x in mus], [t(x) for x in lvs])
    close(m, jm, rtol=1e-6)
    close(lvv, jl, rtol=1e-6)


def test_bridges_refuse_unknown_and_missing_leaves():
    jm, port, jx, _, _ = mlp_case()
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jx, jax.random.PRNGKey(1)))
    bad = {"params": dict(params["params"], extra={"kernel": np.zeros((1, 1))})}
    with pytest.raises(ValueError, match="not a VAE leaf"):
        convert.vae_params_from_jax(bad)
    sd = convert.vae_params_from_jax(params)
    sd.pop("decoder.out.bias")
    with pytest.raises(RuntimeError, match="Missing key"):
        VAE(12, 4, (16,), (16, 8)).load_state_dict(sd)
    with pytest.raises(ValueError, match="not a ConvVAE leaf"):
        convert.conv_vae_params_from_jax({"enc0": {"scale": np.zeros(1)}})
    with pytest.raises(ValueError, match="not a FactorizedMultimodalVAE leaf"):
        convert.factorized_params_from_jax({"encoder_0": {"fc0": {"kernel": np.zeros(1)}}})


def test_indivisible_image_and_unknown_family_raise(tmp_path):
    with pytest.raises(ValueError, match="divisible"):
        ConvVAE((10, 10, 1), channels=(4, 8))
    with pytest.raises(ValueError, match="unknown VAE family"):
        vae_experiment.run_vae_experiment(vae_experiment.VaeExperimentConfig(family="nope", log_dir=str(tmp_path)),
                                          "cpu")


def test_run_checkpoints_and_defaults_to_the_card(tmp_path, monkeypatch):
    cfg = vae_experiment.VaeExperimentConfig(family="mlp", steps=4, batch_size=4, log_every=2, latent_dim=2,
                                             kl_anneal_steps=500, free_bits=0.02, log_dir=str(tmp_path),
                                             checkpoint_dir=str(tmp_path / "ckpt"))
    result = vae_experiment.run_vae_experiment(cfg, "cpu")
    assert np.isfinite(result["final_loss"]) and result["steps"] == 4
    assert any((tmp_path / "ckpt").iterdir())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vae_experiment.run_vae_experiment(cfg)


def test_cli_runs_conv_on_the_cpu(tmp_path):
    proc = subprocess.run([sys.executable, "-m", "mfvae_tpu_torch.training.vae_experiment", "conv", "--device", "cpu"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300,
                          env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    result = eval(proc.stdout.strip().splitlines()[-1], {})
    assert result["family"] == "conv" and result["steps"] == 300
    assert result["final_loss"] < result["first_loss"]
