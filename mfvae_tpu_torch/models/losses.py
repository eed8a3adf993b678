"""ELBO loss families (mirror of ``mfvae_tpu/models/losses.py``).

- 'jax':   ``s*(1-rw) + r*rw + kl*kw`` with rw=0.5, kw=0.1.
- 'torch': ``s + r*rw + kl*kw`` with rw=0.005, kw=0.0025.

KL is the batch mean of the KL summed over every latent dim.  All
reductions are float32.  The two-hot reward head (``recon_reward`` as
logits [B, A, K]) is scored by two-hot cross-entropy, detected by rank;
the weighted state branch (``contact_weight``, ``s_col_weight``) is
``weighted_state_loss``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mfvae_tpu_torch.config import LossConfig
from mfvae_tpu_torch.parallel.mesh import DATA_AXIS

# Symlog half-range of the two-hot reward grid: bins are
# symexp(linspace(-R, R, K)), so the grid follows from K alone
TWOHOT_SYMLOG_RANGE = 8.0


def symlog(x: torch.Tensor) -> torch.Tensor:
    """sign(x) * log(1 + |x|)."""
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    """Inverse of symlog."""
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def _linspace(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """float32 ``jnp.linspace``: start·(1 − t) + stop·t with t = i/(num−1),
    and the end point exact (torch.linspace rounds some points otherwise)."""
    div = num - 1
    t = torch.arange(div, dtype=torch.float32, device=device) / div
    head = start * (1 - t) + stop * t
    return torch.cat([head, torch.full((1,), stop, device=device)])


def twohot_bins(n_bins: int, device=None) -> torch.Tensor:
    """The [K] raw-space bin centres, uniform in symlog space."""
    return symexp(_linspace(-TWOHOT_SYMLOG_RANGE, TWOHOT_SYMLOG_RANGE, n_bins, device))


def twohot_targets(y: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """Two-hot encoding [..., K] of raw targets ``y`` [...] on ``bins``,
    split between the two neighbouring bins linearly in raw space, so
    ``twohot(y) @ bins == clip(y, bins[0], bins[-1])``."""
    k = bins.shape[0]
    y = torch.clamp(y.to(torch.float32), bins[0], bins[-1])
    lo_idx = torch.clamp(torch.searchsorted(bins, y, right=True) - 1, 0, k - 2)
    lo, hi = bins[lo_idx], bins[lo_idx + 1]
    w_hi = torch.clamp((y - lo) / (hi - lo), 0.0, 1.0)
    one_lo = torch.nn.functional.one_hot(lo_idx, k).to(torch.float32)
    one_hi = torch.nn.functional.one_hot(lo_idx + 1, k).to(torch.float32)
    return one_lo * (1.0 - w_hi)[..., None] + one_hi * w_hi[..., None]


def twohot_expectation(logits: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """Expected raw-space value of categorical reward logits [..., K]."""
    return torch.sum(torch.softmax(logits.to(torch.float32), dim=-1) * bins, dim=-1)


def twohot_ce_rows(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-element cross-entropy of two-hot targets ``y`` [...] against
    ``logits`` [..., K] (the grid follows from K)."""
    bins = twohot_bins(logits.shape[-1], logits.device)
    tgt = twohot_targets(y, bins)
    return -torch.sum(tgt * torch.log_softmax(logits.to(torch.float32), dim=-1), dim=-1)


def mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    d = (x - y).to(torch.float32)
    return torch.mean(d * d)


def huber(x: torch.Tensor, y: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """mean huber(x - y) (the semantics of F.huber_loss)."""
    abs_err = torch.abs((x - y).to(torch.float32))
    quadratic = torch.clamp(abs_err, max=delta)
    linear = abs_err - quadratic
    return torch.mean(0.5 * quadratic * quadratic + delta * linear)


def _elem_loss(x: torch.Tensor, y: torch.Tensor, cfg: LossConfig) -> torch.Tensor:
    """Per-element huber/mse, unreduced."""
    d = (x - y).to(torch.float32)
    if not cfg.use_huber:
        return d * d
    abs_err = torch.abs(d)
    quadratic = torch.clamp(abs_err, max=cfg.huber_delta)
    linear = abs_err - quadratic
    return 0.5 * quadratic * quadratic + cfg.huber_delta * linear


def weighted_state_loss(
    recon_state: torch.Tensor,
    next_state: torch.Tensor,
    rewards: torch.Tensor,
    cfg: LossConfig,
    s_col_weight: Optional[torch.Tensor] = None,
    mesh=None,
) -> torch.Tensor:
    """State-branch loss with the contact-sharpness levers: a weighted mean
    over columns per sample (``s_col_weight`` [D]), and transitions whose
    max agent reward exceeds ``cfg.contact_threshold`` counted
    (1 + contact_weight)x, normalized by this batch's weight sum.  With
    both levers off it is mean(elem), the reference objective.

    With a ``mesh`` of n > 1 data ranks the rows are this rank's and the
    weight sum is the global batch's: the rank's share times n, so the
    mean of the ranks' losses (and of their gradients) is the global
    batch's."""
    elem = _elem_loss(next_state, recon_state, cfg)  # [B, D]
    if s_col_weight is not None:
        rows = torch.sum(elem * s_col_weight, dim=-1) / torch.sum(s_col_weight)
    else:
        rows = torch.mean(elem, dim=-1)
    if cfg.contact_weight > 0.0:
        contact = (torch.amax(rewards, dim=-1) > cfg.contact_threshold).to(torch.float32)
        w = 1.0 + cfg.contact_weight * contact
        w_sum = torch.sum(w)
        if mesh is not None and mesh.shape[DATA_AXIS] > 1:
            n = mesh.shape[DATA_AXIS]
            return n * torch.sum(rows * w) / torch.clamp(mesh.all_reduce(w_sum, DATA_AXIS), min=1e-9)
        return torch.sum(rows * w) / torch.clamp(w_sum, min=1e-9)
    return torch.mean(rows)


def kl_gaussian(mu: torch.Tensor, logvar: torch.Tensor, free_bits: float = 0.0) -> torch.Tensor:
    """KL(q(z|x) || N(0, I)): mean over the batch of the sum over every
    non-batch axis; ``free_bits`` floors the per-dim KL."""
    mu = mu.to(torch.float32)
    logvar = logvar.to(torch.float32)
    per_dim = -0.5 * (1.0 + logvar - mu * mu - torch.exp(logvar))
    if free_bits > 0.0:
        per_dim = torch.clamp(per_dim, min=free_bits)
    return torch.mean(torch.sum(per_dim.reshape(per_dim.shape[0], -1), dim=1))


def legacy_vae_loss(y: torch.Tensor, y_hat: torch.Tensor, mu: torch.Tensor, logvar: torch.Tensor,
                    kl_weight: float = 0.0025) -> torch.Tensor:
    """The reference's single-joint-decoder ELBO: MSE + weighted KL
    (torch_ver/model.py:8-16 loss_vae_fn)."""
    return mse(y, y_hat) + kl_gaussian(mu, logvar) * kl_weight


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
    s_col_weight: Optional[torch.Tensor] = None,
    mesh=None,
) -> LossOutputs:
    """Total training loss on the reference objective, with the two-hot
    reward term where ``recon_reward`` has one more axis than ``rewards``
    and the weighted state branch where ``s_col_weight`` or
    ``cfg.contact_weight`` is set (``mesh``: see ``weighted_state_loss``)."""
    if s_col_weight is not None or cfg.contact_weight > 0.0:
        s_loss = weighted_state_loss(recon_state, next_state, rewards, cfg, s_col_weight, mesh)
    elif cfg.use_huber:
        s_loss = huber(next_state, recon_state, cfg.huber_delta)
    else:
        s_loss = mse(next_state, recon_state)
    if recon_reward.dim() == rewards.dim() + 1:
        r_loss = torch.mean(twohot_ce_rows(recon_reward, rewards))
    elif cfg.use_huber:
        r_loss = huber(rewards, recon_reward, cfg.huber_delta)
    else:
        r_loss = mse(rewards, recon_reward)
    kl_loss = kl_gaussian(mu, logvar, cfg.free_bits)
    return combine_losses(s_loss, r_loss, kl_loss, cfg, kl_scale)
