"""Building-block layers (mirror of ``mfvae_tpu/models/layers.py``).

Parameters keep flax's layouts and names — a dense kernel is [in, out], a
stacked kernel [A, in, out], an embedding table ``embedding`` — so the
JAX parameter tree maps onto these modules by name alone
(``models/convert.py``).  Initialization is set explicitly to flax's:
kernels are lecun-normal (a normal truncated at ±2σ, scaled by 1/fan_in
with fan_in per agent slice for stacked kernels), biases zero, embeddings
N(0, 1).  torch's own ``nn.Linear`` default is neither.

``dtype`` is the compute dtype: inputs and kernels are cast to it before
each product, and parameters stay float32.

``layernorm=True`` puts a flax ``nn.LayerNorm`` before every Dense of an
MLP (``ln0..``, ``ln_out``): epsilon 1e-6, statistics in float32 as
``E[x²] − E[x]²`` clamped at 0 (flax's fast variance), output in the
compute dtype.  torch's own ``nn.LayerNorm`` differs in epsilon and in how
it computes the variance.

``remat=True`` recomputes each Dense of an MLP (the hidden ``fc{i}`` and
``out``, as flax's ``nn.remat(nn.Dense)`` does) in the backward instead of
keeping its activations, through ``torch.utils.checkpoint`` (non-reentrant,
the RNG state preserved, though nothing random runs inside): memory for
FLOPs, with the same values and gradients.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

# the stddev of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator] = None):
    """flax ``lecun_normal``: variance_scaling(1, fan_in, truncated_normal)."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _apply(layer: nn.Module, x, remat: bool):
    """``layer(x)``, recomputed in the backward under ``remat``."""
    if remat and torch.is_grad_enabled():
        return checkpoint(layer, x, use_reentrant=False)
    return layer(x)


def _param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device))


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` in the compute dtype
    (``use_bias=False``: no bias leaf, as flax's)."""

    def __init__(self, in_dim: int, features: int, dtype=torch.float32, device=None,
                 generator=None, kernel_init: str = "lecun", use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param((in_dim, features), device)
        self.bias = _param((features,), device) if use_bias else None
        with torch.no_grad():
            if kernel_init in ("ones", "zeros"):
                self.kernel.fill_(1.0 if kernel_init == "ones" else 0.0)
            else:
                lecun_normal_(self.kernel, in_dim, generator)
            if use_bias:
                self.bias.zero_()

    def forward(self, x):
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis, params ``scale`` (ones) and
    ``bias`` (zeros) of shape [features]."""

    EPSILON = 1e-6

    def __init__(self, features: int, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=torch.float32, device=device))

    def forward(self, x):
        x = x.to(torch.float32)
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.clamp(torch.mean(x * x, dim=-1, keepdim=True) - mean * mean, min=0.0)
        y = (x - mean) * (torch.rsqrt(var + self.EPSILON) * self.scale)
        return (y + self.bias).to(self.dtype)


class MLP(nn.Module):
    """ReLU MLP: hidden widths ``fc0..``, then a linear head ``out``; with
    ``layernorm``, a LayerNorm before each of them."""

    def __init__(self, in_dim: int, hidden: Sequence[int], out_dim: int,
                 dtype=torch.float32, device=None, generator=None, layernorm: bool = False,
                 remat: bool = False):
        super().__init__()
        self.n_hidden = len(hidden)
        self.layernorm = layernorm
        self.remat = remat
        widths = [in_dim, *hidden]
        for i, h in enumerate(hidden):
            if layernorm:
                setattr(self, f"ln{i}", LayerNorm(widths[i], dtype, device))
            setattr(self, f"fc{i}", Dense(widths[i], h, dtype, device, generator))
        if layernorm:
            self.ln_out = LayerNorm(widths[-1], dtype, device)
        self.out = Dense(widths[-1], out_dim, dtype, device, generator)

    def forward(self, x):
        for i in range(self.n_hidden):
            if self.layernorm:
                x = getattr(self, f"ln{i}")(x)
            x = torch.relu(_apply(getattr(self, f"fc{i}"), x, self.remat))
        if self.layernorm:
            x = self.ln_out(x)
        return _apply(self.out, x, self.remat)


class Embedding(nn.Module):
    """N(0, 1)-initialized embedding table."""

    def __init__(self, num_embeddings: int, features: int, dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = _param((num_embeddings, features), device)
        with torch.no_grad():
            nn.init.normal_(self.embedding, 0.0, 1.0, generator=generator)

    def forward(self, indices):
        return self.embedding[indices.long()].to(self.dtype)

    def take(self, indices):
        """The lookup with ``jnp.take``'s rule, as the JAX package's
        ``Embedding`` reads indices from data: a negative index counts from
        the end, and a row out of range is NaN (not an error on the host
        or an assert on the card)."""
        n = self.embedding.shape[0]
        idx = indices.long()
        idx = torch.where(idx < 0, idx + n, idx)
        inside = (idx >= 0) & (idx < n)
        rows = self.embedding[idx.clamp(0, n - 1)]
        return torch.where(inside[..., None], rows, torch.full_like(rows, float("nan"))).to(self.dtype)


class StackedDense(nn.Module):
    """A dense layer with a leading stack (agent) axis on its parameters:
    [B, A, in] -> [B, A, out] as one batched product
    (``einsum bai,aio->bao``)."""

    def __init__(self, stack: int, in_dim: int, features: int, dtype=torch.float32,
                 device=None, generator=None, use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param((stack, in_dim, features), device)
        self.bias = _param((stack, features), device) if use_bias else None
        with torch.no_grad():
            for a in range(stack):
                lecun_normal_(self.kernel[a], in_dim, generator)
            if use_bias:
                self.bias.zero_()

    def forward(self, x):
        y = torch.einsum("bai,aio->bao", x.to(self.dtype), self.kernel.to(self.dtype))
        return y if self.bias is None else y + self.bias.to(self.dtype)[None, :, :]


class StackedMLP(nn.Module):
    """ReLU MLP over [B, A, in] with independent per-A parameters.  Its
    LayerNorms (``layernorm``) normalize the last axis with one [D] scale
    and bias shared by every stack entry, as flax's do."""

    def __init__(self, stack: int, in_dim: int, hidden: Sequence[int], out_dim: int,
                 dtype=torch.float32, device=None, generator=None, layernorm: bool = False,
                 remat: bool = False):
        super().__init__()
        self.n_hidden = len(hidden)
        self.layernorm = layernorm
        self.remat = remat
        widths = [in_dim, *hidden]
        for i, h in enumerate(hidden):
            if layernorm:
                setattr(self, f"ln{i}", LayerNorm(widths[i], dtype, device))
            setattr(self, f"fc{i}", StackedDense(stack, widths[i], h, dtype, device, generator))
        if layernorm:
            self.ln_out = LayerNorm(widths[-1], dtype, device)
        self.out = StackedDense(stack, widths[-1], out_dim, dtype, device, generator)

    def forward(self, x):
        for i in range(self.n_hidden):
            if self.layernorm:
                x = getattr(self, f"ln{i}")(x)
            x = torch.relu(_apply(getattr(self, f"fc{i}"), x, self.remat))
        if self.layernorm:
            x = self.ln_out(x)
        return _apply(self.out, x, self.remat)


class StackedEmbedding(nn.Module):
    """Per-stack embedding tables [A, num_embeddings, features]: index i of
    stack a returns table[a, i].  The JAX layer computes it as a one-hot
    product; a gather returns the same values."""

    def __init__(self, stack: int, num_embeddings: int, features: int,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = _param((stack, num_embeddings, features), device)
        with torch.no_grad():
            nn.init.normal_(self.embedding, 0.0, 1.0, generator=generator)

    def forward(self, indices):
        # indices: [B, A] integer
        stack = torch.arange(self.embedding.shape[0], device=indices.device)
        return self.embedding[stack[None, :], indices.long()].to(self.dtype)
