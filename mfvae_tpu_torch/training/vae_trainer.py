"""Train step of the single and multimodal VAE families (mirror of
``mfvae_tpu/training/vae_trainer.py``).

Forward, ELBO, backward and one Adam update, with huber or mse
reconstruction, beta-VAE KL weighting, linear KL annealing and free bits:
the MAVAE path's loss pieces (``models/losses.py``) without the reward
head.  The anneal reads the count of updates applied before this one, as
``state.step`` does in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from mfvae_tpu_torch.models.losses import huber, kl_gaussian, mse


class VaeLoss(NamedTuple):
    loss: torch.Tensor
    recon_loss: torch.Tensor
    kl_loss: torch.Tensor


@dataclass
class VaeTrainState:
    """The model, its Adam optimizer and the count of updates applied."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_vae_state(model: nn.Module, lr: float = 1e-3) -> VaeTrainState:
    # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8
    return VaeTrainState(model, torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8))


def make_vae_train_step(kl_weight: float = 1.0, use_huber: bool = False, kl_anneal_steps: int = 0,
                        free_bits: float = 0.0) -> Callable:
    """-> ``train_step(state, batch, generator=None, eps=None)`` ->
    (state, VaeLoss), the state updated in place; ``train_step.eval_step``
    is the same loss without the update.

    batch: one tensor (single modality) or a tuple/list of them (the
    multimodal reconstruction losses are summed).  ``eps`` is handed to
    the model's forward."""
    recon_fn = huber if use_huber else mse

    def losses(out, batch, step: int) -> VaeLoss:
        if isinstance(batch, (tuple, list)):
            recons, mu, logvar = out
            recon = sum(recon_fn(r, x) for r, x in zip(recons, batch))
        else:
            recon_, mu, logvar = out
            recon = recon_fn(recon_, batch)
        kl = kl_gaussian(mu, logvar, free_bits)
        scale = kl_weight
        if kl_anneal_steps > 0:
            scale = scale * min(1.0, step / kl_anneal_steps)
        return VaeLoss(loss=recon + scale * kl, recon_loss=recon, kl_loss=kl)

    def train_step(state: VaeTrainState, batch, generator: Optional[torch.Generator] = None, eps=None):
        out = losses(state.model(batch, generator, eps), batch, state.step)
        state.optimizer.zero_grad(set_to_none=True)
        out.loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, VaeLoss(*(x.detach() for x in out))

    @torch.no_grad()
    def eval_step(state: VaeTrainState, batch, generator: Optional[torch.Generator] = None, eps=None):
        return losses(state.model(batch, generator, eps), batch, state.step)

    train_step.eval_step = eval_step
    return train_step
