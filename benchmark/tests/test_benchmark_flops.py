"""The frozen FLOPs and bytes of ``benchmark/flops.py`` against the
program's own count and against the shapes they come from."""

import pytest

from benchmark import common, flops


@pytest.mark.parametrize("name", ["tag_ref", "tag_wm"])
@pytest.mark.parametrize("batch", [128, 4096])
def test_train_step_flops_equal_the_programs_count(name, batch):
    from mfvae_tpu_torch.bench.common import step_flops
    from mfvae_tpu_torch.config import load_config
    from mfvae_tpu_torch.envs.mpe import make
    from mfvae_tpu_torch.models.mavae import MAVAE
    from mfvae_tpu_torch.training.experiment import build_spec

    cfg = load_config(str(common.HERE / "configs" / f"{name}.json"))
    model = MAVAE.from_config(cfg.model, build_spec(make(cfg.env.name, device="cpu")), device="meta")
    conf = common.config_dict(name)
    spec = common.ref_spec(conf)
    assert flops.train_step_flops(conf["model"], spec.obs_dims, spec.act_dims, batch) == step_flops(model, batch)


def test_the_numbers_on_record():
    conf = common.config_dict("tag_wm")
    spec = common.ref_spec(conf)
    assert spec.sum_obs == 5660 and spec.n == 40
    assert flops.train_step_flops(conf["model"], spec.obs_dims, spec.act_dims, 4096) == 1068624248832
    ref = common.config_dict("tag_ref")
    assert flops.epoch_flops(ref, spec.obs_dims, spec.act_dims) == pytest.approx(4.8e11, rel=0.05)
    assert flops.rollout_flops(conf["model"], spec.obs_dims, spec.act_dims, 256, 25) == pytest.approx(5.57e11, rel=0.01)


def test_kernel_bytes_match_the_bounds_on_record():
    hbm = 3.35e12
    assert flops.k3_bytes(4096 * 5660) / hbm * 1e6 == pytest.approx(55.36, abs=0.01)
    assert flops.k1_bytes(163840, 64) / hbm * 1e6 == pytest.approx(50.3, abs=0.1)
    assert flops.k2_bytes(163840, 64) / hbm * 1e6 == pytest.approx(75.3, abs=0.1)


def test_forward_flops_count_each_product_once():
    m = dict(idx_features=2, obs_features=3, action_features=4, det_features=0, encoder_hidden=[5],
             decoder_hidden=[6, 7], fused_decoders=False, state_skip=False, residual_state=False,
             reward_head_input="latent", action_delta_head=False)
    obs = (8, 8)
    enc = 2 * ((2 + 8) * 5 + 5 * 6)
    d_in = 2 * (3 + 4)
    dec = 2 * (d_in * 6 + 6 * 7 + 7 * 16) + 2 * (d_in * 6 + 6 * 7 + 7 * 2)
    assert flops.forward_flops_per_row(m, obs, (5, 5)) == 2 * enc + dec + 2 * 2 * 2
