"""The port's config tree equals the JAX package's, field for field."""

import dataclasses
from pathlib import Path

import pytest

import mfvae_tpu.config as jcfg
import mfvae_tpu_torch.config as tcfg

EXAMPLES = sorted((Path(__file__).resolve().parents[1] / "examples").glob("*.yaml"))
CLASSES = ["ModelConfig", "LossConfig", "BufferConfig", "TrainConfig", "EnvConfig",
           "BehaviorConfig", "MeshConfig", "ExperimentConfig"]


@pytest.mark.parametrize("name", CLASSES)
def test_fields_and_defaults_equal(name):
    jc, tc = getattr(jcfg, name), getattr(tcfg, name)
    jf, tf = dataclasses.fields(jc), dataclasses.fields(tc)
    assert [f.name for f in tf] == [f.name for f in jf]
    assert [str(f.type) for f in tf] == [str(f.type) for f in jf]
    assert dataclasses.asdict(tc()) == dataclasses.asdict(jc())


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_examples_load_equal(path):
    assert dataclasses.asdict(tcfg.load_config(str(path))) == dataclasses.asdict(
        jcfg.load_config(str(path))
    )


def test_overrides_save_and_validate_match(tmp_path):
    overrides = ["train.lr=3e-4", "model.encoder_hidden=(32,32)", "loss.kl_weight=0.2",
                 "model.use_pallas=true", "env.num_obs=4"]
    j, t = jcfg.ExperimentConfig(), tcfg.ExperimentConfig()
    jcfg.apply_overrides(j, overrides)
    tcfg.apply_overrides(t, overrides)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    tcfg.save_config(t, str(tmp_path / "c.yaml"))
    assert dataclasses.asdict(jcfg.load_config(str(tmp_path / "c.yaml"))) == dataclasses.asdict(j)
    assert t.loss.resolved_weights() == j.loss.resolved_weights()
    with pytest.raises(ValueError):
        tcfg.apply_overrides(t, ["train.lr"])
    t.loss.family = "bogus"
    with pytest.raises(ValueError):
        t.validate()
