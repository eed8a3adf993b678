from mfvae_tpu_torch.models.layers import MLP, Embedding, StackedMLP
from mfvae_tpu_torch.models.losses import (
    huber,
    mse,
    kl_gaussian,
    elbo_losses,
    LossOutputs,
)
from mfvae_tpu_torch.models.mavae import MAVAE, AgentSpec

__all__ = [
    "MLP",
    "Embedding",
    "StackedMLP",
    "huber",
    "mse",
    "kl_gaussian",
    "elbo_losses",
    "LossOutputs",
    "MAVAE",
    "AgentSpec",
]
