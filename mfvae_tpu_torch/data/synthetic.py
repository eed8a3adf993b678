"""Synthetic datasets for the VAE families, made on the device (mirror of
``mfvae_tpu/data/synthetic.py``).

- ``sprites``: images of two axis-aligned bright rectangles on a dark
  background, NHWC; the latent factors are their positions, sizes and
  colours.
- ``correlated_modalities``: two flat modalities driven by one latent
  source plus private noise, the ground truth of a shared/private
  factorization.

Each draws from an explicit ``torch.Generator``, or takes its draws as
given (``pos``/``wh``/``color``; ``src``/``wa``/``wb``/``noise_a``/
``noise_b``, the standard normals before any scaling), so a test can
replay the JAX package's.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from mfvae_tpu_torch.models.losses import _linspace

N_RECTS = 2


def _device(generator: Optional[torch.Generator], device):
    return device if device is not None else (generator.device if generator is not None else "cpu")


def sprites(
    generator: Optional[torch.Generator],
    batch: int,
    size: int = 16,
    channels: int = 3,
    *,
    pos: Optional[torch.Tensor] = None,
    wh: Optional[torch.Tensor] = None,
    color: Optional[torch.Tensor] = None,
    device=None,
) -> torch.Tensor:
    """[batch, size, size, channels] float32 in [0, 1].  Draws, in this
    order: ``pos`` U[0, 1) [B, 2, 2], ``wh`` U[0.15, 0.45) [B, 2, 2],
    ``color`` U[0.4, 1.0) [B, 2, C]."""
    dev = _device(generator, device)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator, device=dev) * (hi - lo) + lo

    pos = uniform((batch, N_RECTS, 2), 0.0, 1.0) if pos is None else pos
    wh = uniform((batch, N_RECTS, 2), 0.15, 0.45) if wh is None else wh
    color = uniform((batch, N_RECTS, channels), 0.4, 1.0) if color is None else color
    grid = _linspace(0.0, 1.0, size, pos.device)
    yy = grid[None, None, :, None]  # [1, 1, H, 1]
    xx = grid[None, None, None, :]  # [1, 1, 1, W]
    p0, p1 = pos[..., 0, None, None], pos[..., 1, None, None]  # [B, R, 1, 1]
    inside = (yy >= p0) & (yy <= p0 + wh[..., 0, None, None]) & (xx >= p1) & (xx <= p1 + wh[..., 1, None, None])
    layers = inside[..., None].to(torch.float32) * color[:, :, None, None, :]  # [B, R, H, W, C]
    return torch.clamp(torch.sum(layers, dim=1), 0.0, 1.0)


def correlated_modalities(
    generator: Optional[torch.Generator],
    batch: int,
    dim_a: int = 32,
    dim_b: int = 16,
    source_dim: int = 8,
    noise: float = 0.1,
    *,
    src: Optional[torch.Tensor] = None,
    wa: Optional[torch.Tensor] = None,
    wb: Optional[torch.Tensor] = None,
    noise_a: Optional[torch.Tensor] = None,
    noise_b: Optional[torch.Tensor] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xa [B, dim_a], xb [B, dim_b]): xa = src @ wa / √source_dim +
    noise · noise_a, likewise xb.  Standard normal draws, in this order:
    ``src`` [B, S], ``wa`` [S, dim_a], ``wb`` [S, dim_b], ``noise_a``,
    ``noise_b``."""
    dev = _device(generator, device)

    def normal(shape, given):
        return torch.randn(shape, generator=generator, device=dev) if given is None else given

    src = normal((batch, source_dim), src)
    wa = normal((source_dim, dim_a), wa) / math.sqrt(source_dim)
    wb = normal((source_dim, dim_b), wb) / math.sqrt(source_dim)
    xa = src @ wa + noise * normal((batch, dim_a), noise_a)
    xb = src @ wb + noise * normal((batch, dim_b), noise_b)
    return xa, xb
