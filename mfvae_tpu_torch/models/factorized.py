"""Factorized multimodal VAE: shared plus modality-private latents (mirror
of ``mfvae_tpu/models/factorized.py``).

Each modality m has a private posterior q(z_m | x_m) and contributes a
Gaussian expert to the shared posterior, combined with a unit-Gaussian
prior expert by product-of-experts:

    precision T = 1 + Σ_m 1/σ_m²,  μ_shared = (Σ_m μ_m/σ_m²) / T

Each decoder reconstructs its modality from (z_shared ‖ z_m_private).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from mfvae_tpu_torch.models.layers import MLP
from mfvae_tpu_torch.models.vae import reparameterize


def product_of_experts(mus: Sequence[torch.Tensor], logvars: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """PoE over Gaussian experts and the N(0, I) prior expert; every input
    [B, D] -> (mu, logvar) of the product."""
    precisions = [torch.ones_like(mus[0])] + [torch.exp(-lv) for lv in logvars]
    weighted = [torch.zeros_like(mus[0])] + [m * torch.exp(-lv) for m, lv in zip(mus, logvars)]
    total_prec = sum(precisions)
    return sum(weighted) / total_prec, -torch.log(total_prec)


class FactorizedMultimodalVAE(nn.Module):
    """``modality_dims``: the flat input width of each modality.  Encoder m
    (``encoders.m``) emits private mu/logvar then the shared expert's
    mu/logvar; decoder m (``decoders.m``) reads [z_shared, z_m]."""

    def __init__(self, modality_dims: Sequence[int], shared_latent: int = 32, private_latent: int = 32,
                 encoder_hidden: Sequence[int] = (256, 256), decoder_hidden: Sequence[int] = (256, 256),
                 dtype=torch.float32, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.modality_dims = tuple(modality_dims)
        self.shared_latent, self.private_latent = shared_latent, private_latent
        out = 2 * private_latent + 2 * shared_latent
        self.encoders = nn.ModuleList(
            MLP(d, encoder_hidden, out, dtype, device, generator) for d in self.modality_dims
        )
        self.decoders = nn.ModuleList(
            MLP(shared_latent + private_latent, decoder_hidden, d, dtype, device, generator)
            for d in self.modality_dims
        )

    def encode(self, xs: Sequence[torch.Tensor]):
        priv_mu, priv_lv, shared_mus, shared_lvs = [], [], [], []
        p, s = self.private_latent, self.shared_latent
        for enc, x in zip(self.encoders, xs):
            h = enc(x).to(torch.float32)
            priv_mu.append(h[..., :p])
            priv_lv.append(h[..., p: 2 * p])
            shared_mus.append(h[..., 2 * p: 2 * p + s])
            shared_lvs.append(h[..., 2 * p + s:])
        sh_mu, sh_lv = product_of_experts(shared_mus, shared_lvs)
        return priv_mu, priv_lv, sh_mu, sh_lv

    def decode(self, z_shared, z_privates):
        return [dec(torch.cat([z_shared, zp], dim=-1)).to(torch.float32)
                for dec, zp in zip(self.decoders, z_privates)]

    def forward(self, xs: Sequence[torch.Tensor], generator: Optional[torch.Generator] = None,
                eps: Optional[Sequence[torch.Tensor]] = None):
        """-> (recons per modality, mu, logvar), mu and logvar the shared
        then the private latents concatenated.  ``eps``: the shared draw,
        then each modality's, in the order the JAX package splits its key;
        drawn from ``generator`` in that order unless given."""
        priv_mu, priv_lv, sh_mu, sh_lv = self.encode(xs)
        eps = [None] * (len(xs) + 1) if eps is None else list(eps)
        z_sh = reparameterize(sh_mu, sh_lv, generator, eps[0])
        z_priv = [reparameterize(m, lv, generator, e) for m, lv, e in zip(priv_mu, priv_lv, eps[1:])]
        recons = self.decode(z_sh, z_priv)
        return recons, torch.cat([sh_mu] + priv_mu, dim=-1), torch.cat([sh_lv] + priv_lv, dim=-1)
