"""PopArt reward-target normalization (mirror of
``mfvae_tpu/training/popart.py``).

Per-output (per-agent) statistics in a ``PopArtState`` of float32 tensors
on the run's device.  ``art`` updates them from a batch of targets;
``pop_rescale_head`` rescales the model's ``reward_linear`` head in place
so its denormalized predictions do not move under the update.  For a head
``y_j = w_j·x + b_j`` and stats (μ, σ) -> (μ', σ'):

    w'_j = w_j σ_j / σ'_j,   b'_j = (σ_j b_j + μ_j − μ'_j) / σ'_j

Nothing here reads a tensor back to the host, so a train step that calls
these functions queues its work without a sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mfvae_tpu_torch.parallel.mesh import DATA_AXIS

SIGMA_MIN, SIGMA_MAX = 1e-4, 1e6


class PopArtState(NamedTuple):
    mu: torch.Tensor  # [n_outputs]
    nu: torch.Tensor  # [n_outputs] second moment
    sigma: torch.Tensor  # [n_outputs]


def init_popart(n_outputs: int, device=None) -> PopArtState:
    return PopArtState(
        mu=torch.zeros(n_outputs, device=device),
        nu=torch.ones(n_outputs, device=device),
        sigma=torch.ones(n_outputs, device=device),
    )


def art(state: PopArtState, targets: torch.Tensor, beta: float, mesh=None) -> PopArtState:
    """EMA stats update from a batch of targets [B, n_outputs].  With a
    ``mesh`` of more than one data rank, ``targets`` are this rank's rows
    and the batch moments come from sums and sums of squares summed over
    'data' (``parallel/dp.py``)."""
    t = targets.to(torch.float32)
    if mesh is None or mesh.shape[DATA_AXIS] == 1:
        m1, m2 = torch.mean(t, dim=0), torch.mean(t * t, dim=0)
    else:
        sums = mesh.all_reduce(torch.stack([torch.sum(t, dim=0), torch.sum(t * t, dim=0)]), DATA_AXIS)
        m1, m2 = sums / (t.shape[0] * mesh.shape[DATA_AXIS])
    mu_new = (1.0 - beta) * state.mu + beta * m1
    nu_new = (1.0 - beta) * state.nu + beta * m2
    sigma_new = torch.sqrt(torch.clamp(nu_new - mu_new * mu_new, min=SIGMA_MIN**2))
    sigma_new = torch.clamp(sigma_new, SIGMA_MIN, SIGMA_MAX)
    return PopArtState(mu=mu_new, nu=nu_new, sigma=sigma_new)


@torch.no_grad()
def pop_rescale_head(model: torch.nn.Module, old: PopArtState, new: PopArtState) -> None:
    """Rescale ``model.reward_linear`` (kernel [in, out], bias [out]) in
    place so denormalized predictions are invariant under old -> new."""
    head = model.reward_linear
    scale = old.sigma / new.sigma  # [n_out]
    head.kernel.mul_(scale[None, :])
    head.bias.copy_((old.sigma * head.bias + old.mu - new.mu) / new.sigma)


def normalize(state: PopArtState, y: torch.Tensor) -> torch.Tensor:
    return (y - state.mu) / state.sigma


def denormalize(state: PopArtState, y: torch.Tensor) -> torch.Tensor:
    return state.sigma * y + state.mu
