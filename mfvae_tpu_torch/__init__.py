"""mfvae_tpu_torch — the PyTorch/CUDA port of mfvae_tpu for NVIDIA Hopper.

Mirrors ``mfvae_tpu``'s module paths and public names.  Plain tensor code
is PyTorch; the JAX package's Pallas kernels are hand-written CUDA kernels
under ``ops/csrc`` with plain PyTorch versions beside them.  Nothing here
imports JAX or the JAX package.
"""

__version__ = "0.1.0"
