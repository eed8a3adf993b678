"""The port's subpackages export the JAX package's public names, and its
checkpoint managers have the JAX package's surface (``close``,
``restore(like=...)``).

Each ``__all__`` is read from the JAX package's ``__init__.py`` by AST, so
this file imports no JAX.
"""

import ast
import importlib
from pathlib import Path

import pytest
import torch

from mfvae_tpu_torch.training.checkpoint import CheckpointManager, NullCheckpointManager

ROOT = Path(__file__).resolve().parents[1]
SUBPACKAGES = ("training", "data", "models", "envs")


def jax_all(sub: str):
    tree = ast.parse((ROOT / "mfvae_tpu" / sub / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"mfvae_tpu/{sub}/__init__.py has no __all__")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_all_equals_jax(sub):
    mod = importlib.import_module(f"mfvae_tpu_torch.{sub}")
    assert list(mod.__all__) == list(jax_all(sub))


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_star_import_resolves_every_name(sub):
    ns = {}
    exec(f"from mfvae_tpu_torch.{sub} import *", ns)
    missing = [n for n in jax_all(sub) if n not in ns]
    assert not missing
    assert all(ns[n] is not None for n in jax_all(sub))


def test_vae_train_state_is_the_mavae_train_state():
    from mfvae_tpu_torch import training
    from mfvae_tpu_torch.training import trainer, vae_trainer

    assert training.VaeTrainState is trainer.TrainState
    assert training.VaeTrainState is not vae_trainer.VaeTrainState


def test_checkpoint_manager_close_and_like(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    payload = {"w": torch.arange(4.0), "epoch": 3}
    mgr.save(3, payload)
    for got in (mgr.restore(like=payload), mgr.restore(3, like={"anything": 0}), mgr.restore()):
        torch.testing.assert_close(got["w"], payload["w"])
        assert got["epoch"] == 3
    mgr.close()
    mgr.close()  # a second close is harmless
    assert mgr.latest_step() == 3  # the directory stays readable after close


def test_null_checkpoint_manager_close_and_like():
    mgr = NullCheckpointManager()
    mgr.save(1, {"w": torch.zeros(1)})
    assert mgr.restore(like={"w": torch.zeros(1)}) is None
    assert mgr.restore(1, like=None) is None
    mgr.close()
    mgr.close()


def test_experiment_codebook_is_the_agent_order():
    """JAX's ``Experiment.codebook``, the map ``create_dataset`` reads."""
    from mfvae_tpu_torch.config import ExperimentConfig
    from mfvae_tpu_torch.training import Experiment

    cfg = ExperimentConfig()
    cfg.env.num_good_agents, cfg.env.num_adversaries, cfg.env.num_obs = 1, 2, 1
    exp = Experiment(cfg, device="cpu")
    assert exp.codebook == {a: i for i, a in enumerate(exp.env.agents)}
    assert list(exp.codebook) == ["adversary_0", "adversary_1", "agent_0"]
