"""Minimal action/observation spaces (mirror of ``mfvae_tpu/envs/spaces.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class Discrete:
    n: int
    dtype: torch.dtype = torch.int32

    def sample(
        self, generator: Optional[torch.Generator] = None, shape: Tuple[int, ...] = ()
    ) -> torch.Tensor:
        device = generator.device if generator is not None else "cpu"
        return torch.randint(
            0, self.n, shape, generator=generator, device=device, dtype=self.dtype
        )

    def contains(self, x) -> torch.Tensor:
        return (x >= 0) & (x < self.n)


@dataclass(frozen=True)
class Box:
    low: float
    high: float
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        device = generator.device if generator is not None else "cpu"
        u = torch.rand(self.shape, generator=generator, device=device, dtype=self.dtype)
        return u * (self.high - self.low) + self.low

    def contains(self, x) -> torch.Tensor:
        return torch.all((x >= self.low) & (x <= self.high))


def get_space_size(space) -> int:
    """Flat size of a space: ``n`` for Discrete, the flat shape for Box."""
    if isinstance(space, Discrete):
        return space.n
    if isinstance(space, Box):
        return int(space.shape[0])
    raise NotImplementedError(f"unknown space {type(space)!r}")
