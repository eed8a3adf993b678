"""ELBO loss families (mirror of ``mfvae_tpu/models/losses.py``).

- 'jax':   ``s*(1-rw) + r*rw + kl*kw`` with rw=0.5, kw=0.1.
- 'torch': ``s + r*rw + kl*kw`` with rw=0.005, kw=0.0025.

KL is the batch mean of the KL summed over every latent dim.  All
reductions are float32.  The weighted state branch (``contact_weight``,
``prey_dist_weight``) and the two-hot reward head are not ported yet
(ROADMAP M10).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mfvae_tpu_torch.config import LossConfig


def mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    d = (x - y).to(torch.float32)
    return torch.mean(d * d)


def huber(x: torch.Tensor, y: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """mean huber(x - y) (the semantics of F.huber_loss)."""
    abs_err = torch.abs((x - y).to(torch.float32))
    quadratic = torch.clamp(abs_err, max=delta)
    linear = abs_err - quadratic
    return torch.mean(0.5 * quadratic * quadratic + delta * linear)


def kl_gaussian(mu: torch.Tensor, logvar: torch.Tensor, free_bits: float = 0.0) -> torch.Tensor:
    """KL(q(z|x) || N(0, I)): mean over the batch of the sum over every
    non-batch axis; ``free_bits`` floors the per-dim KL."""
    mu = mu.to(torch.float32)
    logvar = logvar.to(torch.float32)
    per_dim = -0.5 * (1.0 + logvar - mu * mu - torch.exp(logvar))
    if free_bits > 0.0:
        per_dim = torch.clamp(per_dim, min=free_bits)
    return torch.mean(torch.sum(per_dim.reshape(per_dim.shape[0], -1), dim=1))


def refuse_unported(cfg: LossConfig) -> None:
    if cfg.contact_weight > 0.0 or cfg.prey_dist_weight > 0.0:
        raise NotImplementedError(
            "loss.contact_weight / loss.prey_dist_weight are not ported yet (ROADMAP M10)"
        )


class LossOutputs(NamedTuple):
    loss: torch.Tensor
    s_loss: torch.Tensor
    r_loss: torch.Tensor
    kl_loss: torch.Tensor


def combine_losses(
    s_loss, r_loss, kl_loss, cfg: LossConfig, kl_scale: Optional[torch.Tensor] = None
) -> LossOutputs:
    """Apply the family weighting to already-computed components."""
    kw, rw = cfg.resolved_weights()
    sw = cfg.s_weight
    if cfg.family == "jax":
        recons = sw * s_loss * (1.0 - rw) + r_loss * rw
    else:
        recons = sw * s_loss + r_loss * rw
    kl_term = kl_loss * kw
    if kl_scale is not None:
        kl_term = kl_term * kl_scale
    return LossOutputs(loss=recons + kl_term, s_loss=s_loss, r_loss=r_loss, kl_loss=kl_loss)


def elbo_losses(
    recon_state, recon_reward, next_state, rewards, mu, logvar,
    cfg: LossConfig, kl_scale: Optional[torch.Tensor] = None,
) -> LossOutputs:
    """Total training loss on the reference objective."""
    refuse_unported(cfg)
    if recon_reward.dim() == rewards.dim() + 1:
        raise NotImplementedError("the two-hot reward loss is not ported yet (ROADMAP M10)")
    if cfg.use_huber:
        s_loss = huber(next_state, recon_state, cfg.huber_delta)
        r_loss = huber(rewards, recon_reward, cfg.huber_delta)
    else:
        s_loss = mse(next_state, recon_state)
        r_loss = mse(rewards, recon_reward)
    kl_loss = kl_gaussian(mu, logvar, cfg.free_bits)
    return combine_losses(s_loss, r_loss, kl_loss, cfg, kl_scale)
