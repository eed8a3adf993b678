"""Multi-seed training in the port (``training/multiseed.py``), the tests
of tests/test_multiseed.py: each replica must reproduce the port's
single-seed ``Experiment`` bit for bit, depend on its seed's value and not
its position, and return the last chunk's test losses through
``replica_batch``.  The JAX package's ``run_multiseed`` is run beside it on
the same tiny config, for the shape of the result and its refusal of
``n_envs > 1``."""

import numpy as np
import pytest

from mfvae_tpu.training.multiseed import run_multiseed as j_run_multiseed
from mfvae_tpu_torch.training.experiment import Experiment
from mfvae_tpu_torch.training.multiseed import run_multiseed
from tests.test_torch_experiment import one_torch_thread  # noqa: F401
from tests.test_torch_tooling import small as parity_small
from tests.test_training import tiny_cfg


def small(tmp, epochs=2, **options):
    """parity_small's widths, with fewer steps an epoch."""
    cfg = parity_small(tmp, epochs, **options)
    cfg.train.sample_num, cfg.train.train_num, cfg.train.test_num = 16, 2, 2
    return cfg


KEYS = {"seeds", "loss_train", "loss_test", "train_mean", "train_std", "train_min", "train_max",
        "epochs", "n_seeds"}  # JAX's; the port adds epoch_wall_s


@pytest.mark.parametrize("options", [{}, {"model__use_pallas": True}, {"train__bug_compat_rng": True},
                                     {"model__rng_mode": "reference"}],
                         ids=["plain", "use_pallas", "bug_compat", "rng_reference"])
def test_multiseed_matches_single_seed(tmp_path, options):
    base = Experiment(small(tmp_path, epochs=3, **options), device="cpu").setup().run()
    out = run_multiseed(small(tmp_path, epochs=3, **options), seeds=[0, 1], epochs_per_dispatch=2, device="cpu")
    assert set(out) == KEYS | {"epoch_wall_s"} and out["n_seeds"] == 2 and out["epochs"] == 3
    assert len(out["epoch_wall_s"]) == 3
    assert out["loss_train"][0] == base["loss_train"]
    assert out["loss_test"][0] == base["loss_test"]
    # different seeds -> different trajectories
    assert abs(out["loss_train"][0] - out["loss_train"][1]) > 1e-9
    assert out["train_min"] <= out["train_mean"] <= out["train_max"]
    assert out["train_std"] == pytest.approx(float(np.std(np.float32(out["loss_train"]))))


def test_multiseed_seed_relabeling(tmp_path):
    """Replica identity depends only on the seed value, not its position."""
    a = run_multiseed(small(tmp_path), seeds=[3, 5], device="cpu")
    b = run_multiseed(small(tmp_path), seeds=[5, 3], device="cpu")
    assert a["loss_train"] == b["loss_train"][::-1] and a["loss_test"] == b["loss_test"][::-1]
    assert a["seeds"] == [3, 5] and b["seeds"] == [5, 3]


def test_multiseed_tail_metrics(tmp_path):
    """tail_metrics returns the last chunk's per-epoch held-out losses
    ([N, k]), the final column equal to loss_test, through the
    replica_batch partitioning."""
    out = run_multiseed(small(tmp_path, epochs=4), seeds=[0, 1, 2], epochs_per_dispatch=2, replica_batch=2,
                        tail_metrics=True, device="cpu")
    tail = np.asarray(out["test_loss_tail"])
    assert tail.shape == (3, 2) and out["seeds"] == [0, 1, 2] and len(out["epoch_wall_s"]) == 4
    np.testing.assert_array_equal(tail[:, -1], np.float32(out["loss_test"]))
    third = run_multiseed(small(tmp_path, epochs=4), seeds=[2], epochs_per_dispatch=3,
                          tail_metrics=True, device="cpu")
    assert np.asarray(third["test_loss_tail"]).shape == (1, 1)  # epochs [3, 4): the second chunk
    assert third["loss_train"] == out["loss_train"][2:]


def test_jax_result_has_the_same_keys(tmp_path):
    out = j_run_multiseed(tiny_cfg(tmp_path, epoch_num=1), seeds=[0, 1], tail_metrics=True)
    assert set(out) == KEYS | {"test_loss_tail"}
    ours = run_multiseed(small(tmp_path, epochs=1), seeds=[0, 1], tail_metrics=True, device="cpu")
    assert set(ours) == set(out) | {"epoch_wall_s"}
    assert np.asarray(ours["test_loss_tail"]).shape == np.asarray(out["test_loss_tail"]).shape


def test_multiseed_refuses_batched_envs(tmp_path):
    with pytest.raises(AssertionError):
        j_run_multiseed(tiny_cfg(tmp_path, n_envs=2), seeds=[0])
    with pytest.raises(ValueError, match="n_envs must be 1"):
        run_multiseed(small(tmp_path, train__n_envs=2), seeds=[0], device="cpu")
