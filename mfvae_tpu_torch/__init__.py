"""mfvae_tpu_torch — the PyTorch/CUDA port of mfvae_tpu for NVIDIA Hopper.

Mirrors ``mfvae_tpu``'s module paths and public names.  Plain tensor code
is PyTorch; the JAX package's Pallas kernels are hand-written CUDA kernels
under ``ops/csrc`` with plain PyTorch versions beside them.  Nothing here
imports JAX or the JAX package.

The top level exports what ``mfvae_tpu`` exports, except ``RngStream``:
the port's named streams are ``torch.Generator``s, which
``make_streams`` returns in a ``Streams`` dict (``rng.py``).
"""

__version__ = "0.1.0"

from mfvae_tpu_torch.config import (
    BufferConfig,
    ExperimentConfig,
    LossConfig,
    MeshConfig,
    ModelConfig,
    TrainConfig,
    load_config,
    save_config,
)
from mfvae_tpu_torch.rng import Streams, make_streams

__all__ = [
    "ExperimentConfig",
    "ModelConfig",
    "LossConfig",
    "BufferConfig",
    "TrainConfig",
    "MeshConfig",
    "load_config",
    "save_config",
    "Streams",
    "make_streams",
]
