from mfvae_tpu_torch.training.checkpoint import CheckpointManager
from mfvae_tpu_torch.training.experiment import Experiment, run_experiment, run_resilient
from mfvae_tpu_torch.training.metrics import MetricsLogger
from mfvae_tpu_torch.training.trainer import (
    VaeTrainState,
    create_train_state,
    make_epoch_fn,
    make_test_step,
    make_train_step,
)

__all__ = [
    "CheckpointManager", "Experiment", "run_experiment", "run_resilient",
    "MetricsLogger", "VaeTrainState", "create_train_state",
    "make_epoch_fn", "make_test_step", "make_train_step",
]
