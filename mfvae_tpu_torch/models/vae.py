"""Single-modality VAE families (mirror of ``mfvae_tpu/models/vae.py``).

- ``VAE``: MLP encoder and decoder over a flat modality.
- ``ConvVAE``: stride-2 3×3 convolutions down, a dense latent head, and
  stride-2 3×3 transposed convolutions back up, over images.

Both return ``(recon, mu, logvar)`` in float32 from ``forward(x,
generator=None, eps=None)``.  ``dtype`` is the compute dtype, as flax's
``dtype=``: inputs and weights are cast to it, the parameters stay
float32.  The dense layers keep flax's layout (``layers.py``); the
convolutions hold torch's (``weight`` [out, in, kH, kW] and, transposed,
[in, out, kH, kW]), and ``models/convert.py`` turns flax's HWIO kernels
into them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mfvae_tpu_torch.models.layers import MLP, Dense, lecun_normal_


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor, generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """z = mu + eps · exp(½ logvar) in float32; ``eps`` standard normal,
    drawn from ``generator`` unless given."""
    mu32 = mu.to(torch.float32)
    std = torch.exp(0.5 * logvar.to(torch.float32))
    if eps is None:
        eps = torch.randn(std.shape, generator=generator, device=std.device)
    return mu32 + eps * std


class VAE(nn.Module):
    """MLP VAE over [B, in_dim]: ``encoder`` -> (mu, logvar) of
    ``latent_dim`` each, ``decoder`` back to in_dim."""

    def __init__(self, in_dim: int, latent_dim: int = 64, encoder_hidden: Sequence[int] = (256, 256),
                 decoder_hidden: Sequence[int] = (256, 256), dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.latent_dim = latent_dim
        self.dtype = dtype
        self.encoder = MLP(in_dim, encoder_hidden, 2 * latent_dim, dtype, device, generator)
        self.decoder = MLP(latent_dim, decoder_hidden, in_dim, dtype, device, generator)

    def encode(self, x):
        h = self.encoder(x)
        return h[..., : self.latent_dim], h[..., self.latent_dim:]

    def decode(self, z):
        return self.decoder(z).to(torch.float32)

    def forward(self, x, generator: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None):
        mu, logvar = self.encode(x)
        recon = self.decode(reparameterize(mu, logvar, generator, eps))
        return recon, mu.to(torch.float32), logvar.to(torch.float32)


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA 'SAME' padding of one spatial axis: (low, high)."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


KERNEL, STRIDE = 3, 2  # every ConvVAE convolution: 3×3, stride 2


class Conv(nn.Module):
    """flax ``nn.Conv(features, (3, 3), strides=2)`` with 'SAME' padding,
    on NCHW.  At an even input, 'SAME' pads (0, 1), not torch's (1, 1)."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, KERNEL, KERNEL, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device))
        lecun_normal_(self.weight, in_ch * KERNEL * KERNEL, generator)

    def forward(self, x):
        ph, pw = (_same_pads(n, KERNEL, STRIDE) for n in x.shape[-2:])
        x = F.pad(x.to(self.dtype), (*pw, *ph))
        # the bias added after the product is rounded, as flax adds it
        return F.conv2d(x, self.weight.to(self.dtype), stride=STRIDE) + self.bias.to(self.dtype)[:, None, None]


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(features, (3, 3), strides=2)`` with 'SAME'
    padding, on NCHW: the full transposed convolution cropped to
    [2H, 2W] from the start (the weight holds flax's kernel flipped in
    both spatial axes)."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, KERNEL, KERNEL, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device))
        lecun_normal_(self.weight, in_ch * KERNEL * KERNEL, generator)

    def forward(self, x):
        h, w = x.shape[-2:]
        y = F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype), stride=STRIDE)
        return y[..., : STRIDE * h, : STRIDE * w] + self.bias.to(self.dtype)[:, None, None]


class ConvVAE(nn.Module):
    """Conv encoder / ConvTranspose decoder VAE over NHWC images
    [B, H, W, C] (the JAX package's layout at the module's edges; inside,
    the convolutions run on NCHW, and the flatten before the latent head
    and the reshape after ``dec_head`` keep flax's HWC order).

    ``len(channels)`` stride-2 convolutions (``enc0..``), the latent head
    ``enc_head``, ``dec_head`` back to [H/f, W/f, channels[-1]], then
    transposed convolutions (``dec0..``) up to [H, W, C]; H and W must be
    divisible by f = 2^len(channels)."""

    def __init__(self, image_shape: Tuple[int, int, int], latent_dim: int = 64,
                 channels: Sequence[int] = (32, 64, 128), dtype=torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h, w, c = image_shape
        f = 2 ** len(channels)
        if h % f or w % f:
            raise ValueError(f"image {image_shape} is not divisible by 2^{len(channels)}")
        self.image_shape, self.latent_dim = tuple(image_shape), latent_dim
        self.channels, self.dtype = tuple(channels), dtype
        self.spatial = (h // f, w // f)
        ins = (c,) + self.channels[:-1]
        for i, (ci, co) in enumerate(zip(ins, self.channels)):
            setattr(self, f"enc{i}", Conv(ci, co, dtype, device, generator))
        flat = self.spatial[0] * self.spatial[1] * self.channels[-1]
        self.enc_head = Dense(flat, 2 * latent_dim, dtype, device, generator)
        self.dec_head = Dense(latent_dim, flat, dtype, device, generator)
        rev = tuple(reversed(self.channels[:-1])) + (c,)
        for i, (ci, co) in enumerate(zip((self.channels[-1],) + rev[:-1], rev)):
            setattr(self, f"dec{i}", ConvTranspose(ci, co, dtype, device, generator))

    def encode(self, x):
        h = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        for i in range(len(self.channels)):
            h = torch.relu(getattr(self, f"enc{i}")(h))
        out = self.enc_head(h.permute(0, 2, 3, 1).reshape(h.shape[0], -1))  # flatten in HWC order
        return out[..., : self.latent_dim], out[..., self.latent_dim:]

    def decode(self, z):
        hs, ws = self.spatial
        h = torch.relu(self.dec_head(z)).reshape(-1, hs, ws, self.channels[-1]).permute(0, 3, 1, 2)
        n = len(self.channels)
        for i in range(n):
            h = getattr(self, f"dec{i}")(h)
            if i < n - 1:
                h = torch.relu(h)
        return h.permute(0, 2, 3, 1).to(torch.float32)  # NCHW -> NHWC

    def forward(self, x, generator: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None):
        mu, logvar = self.encode(x)
        recon = self.decode(reparameterize(mu, logvar, generator, eps))
        return recon, mu.to(torch.float32), logvar.to(torch.float32)
