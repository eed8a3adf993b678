"""Multi-step open-loop (unroll) training of the world model (mirror of
``mfvae_tpu/training/unroll.py``).

Windows of W consecutive transitions are rolled forward with the model's
own predicted state fed back as the next observation, and the ELBO is
applied at every horizon, by default back-propagating through the
feedback (BPTT).  The feedback is the sampled reconstruction, or with
``mean_feedback`` the posterior-mean prediction (``MAVAE.mean_call``, the
serving path of ``inference.WorldModel``); the per-step loss scores the
sampled reconstruction either way.  ``stop_gradient`` detaches the
feedback at every step boundary.

The per-step, per-sample losses are masked after the first stored
``done`` of a window and pooled over the valid (sample, step) slots, so
W = 1 with every slot valid is the one-step ELBO.  The JAX scan over W is
a Python loop here.  Each step's eps is drawn from the generator (private,
then shared, as ``MAVAE.forward`` draws) or given: ``eps`` [W, B, A, F] in
grouped agent order and ``eps_shared`` [W, B, S].

Only train.mode='Adam' is supported (PopArt targets are not defined over
W steps), as in the JAX package.  Unlike the JAX package, whose fused
kernel is a one-step program, the port also runs the kernel route
(``use_pallas``): each window step's forward is ``MAVAE.fused_call`` (K1
in the forward, K2 in the backward), the KL pools its ``kl_rows``, and the
state and reward terms of all W steps are one launch each of K3w
(``ops.fused_elbo.huber_rows_wsum``) over the W·B stacked rows, with the
slots' weights; the pool's divisions stay here, so the data-parallel
pooling is the same on both routes.  The kernel route keeps
``make_train_step``'s guards (huber family, no free bits, no column or
contact weight).
"""

from __future__ import annotations

from typing import Callable

import torch

from mfvae_tpu_torch.config import LossConfig
from mfvae_tpu_torch.data.transitions import GroupedTransition
from mfvae_tpu_torch.models.losses import LossOutputs, _elem_loss, combine_losses, twohot_ce_rows
from mfvae_tpu_torch.models.mavae import AgentSpec, GroupedBatch, agent_order_concat, state_to_grouped
from mfvae_tpu_torch.ops.fused_elbo import huber_rows_wsum
from mfvae_tpu_torch.parallel.dp import mean_over_data
from mfvae_tpu_torch.parallel.mesh import DATA_AXIS
from mfvae_tpu_torch.training.trainer import _kl_scale, apply_update, check_pallas_loss
from mfvae_tpu_torch.utils.profiling import span


def _huber_rows(x: torch.Tensor, y: torch.Tensor, delta: float) -> torch.Tensor:
    """Per-sample huber, the mean over trailing dims -> [B]."""
    abs_err = torch.abs((x - y).to(torch.float32))
    quadratic = torch.clamp(abs_err, max=delta)
    linear = abs_err - quadratic
    per_el = 0.5 * quadratic * quadratic + delta * linear
    return torch.mean(per_el.reshape(per_el.shape[0], -1), dim=-1)


def _mse_rows(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    d = (x - y).to(torch.float32)
    return torch.mean((d * d).reshape(d.shape[0], -1), dim=-1)


def _kl_rows(mu: torch.Tensor, logvar: torch.Tensor, free_bits: float) -> torch.Tensor:
    """Per-sample KL summed over the latent dims -> [B]."""
    mu = mu.to(torch.float32)
    logvar = logvar.to(torch.float32)
    per_dim = -0.5 * (1.0 + logvar - mu * mu - torch.exp(logvar))
    if free_bits > 0.0:
        per_dim = torch.clamp(per_dim, min=free_bits)
    return torch.sum(per_dim.reshape(per_dim.shape[0], -1), dim=-1)


def make_unroll_loss_fn(
    spec: AgentSpec,
    loss_cfg: LossConfig,
    unroll_steps: int,
    stop_gradient: bool = False,
    mean_feedback: bool = False,
    s_col_weight=None,
    mesh=None,
    use_pallas: bool = False,
) -> Callable:
    """``loss_fn(model, wbatch, generator=None, kl_scale=None, eps=None,
    eps_shared=None) -> LossOutputs`` over a window batch (a
    GroupedTransition with leaves [B, W, ...]).

    With a ``mesh`` of n > 1 data ranks the windows are this rank's and the
    pools are the global batch's: the valid-slot counts are summed over
    'data' and the rank's sums scaled by n, so the mean of the ranks'
    losses (and of their gradients) is the global pooled loss.
    ``use_pallas`` takes the kernel route (the module docstring)."""
    W = int(unroll_steps)
    if W < 1:
        raise ValueError(f"unroll_steps must be >= 1, got {unroll_steps}")
    if use_pallas:
        check_pallas_loss(loss_cfg, s_col_weight)

    def loss_fn(model, wbatch: GroupedTransition, generator=None, kl_scale=None, eps=None, eps_shared=None):
        obs = tuple(o[:, 0] for o in wbatch.obs)
        done = wbatch.done.to(torch.float32)  # [B, W]
        mask = torch.ones_like(done[:, 0])
        sums = []
        rows = []  # the kernel route's (target, recon) of both branches and the slot weights, per step
        # the W forwards with their per-row loss terms and the feedback
        with span("train.forward"):
            for t in range(W):
                with span("train.unroll.step"):
                    batch = GroupedBatch(obs=obs, actions=tuple(a[:, t] for a in wbatch.actions))
                    tgt_s = agent_order_concat(spec, tuple(o[:, t] for o in wbatch.next_obs))
                    tgt_r = wbatch.rewards[:, t]
                    step_eps = None if eps is None else eps[t]
                    step_eps_shared = None if eps_shared is None else eps_shared[t]
                    if use_pallas:
                        recon_s, recon_r, kl_rows = model.fused_call(batch, None, generator, step_eps,
                                                                     step_eps_shared)
                        rows.append((tgt_s, recon_s, tgt_r, recon_r, mask))
                        sums.append(torch.stack([torch.sum(torch.sum(kl_rows, dim=1) * mask), torch.sum(mask)]))
                    else:
                        recon_s, recon_r, mu, logvar = model(batch, None, generator, step_eps, step_eps_shared)
                        sums.append(_plain_row_sums(loss_cfg, s_col_weight, mask, recon_s, recon_r, tgt_s, tgt_r,
                                                    mu, logvar))
                    if t + 1 == W:
                        break
                    # windows die at episode boundaries; the prediction feeds back
                    mask = mask * (1.0 - done[:, t])
                    fb = model.mean_call(batch)[0] if mean_feedback else recon_s
                    if stop_gradient:
                        fb = fb.detach()
                    obs = state_to_grouped(spec, fb)
        with span("train.loss"):  # the pooled means
            if use_pallas:
                tgt_s, recon_s, tgt_r, recon_r, w = (torch.cat(x) for x in zip(*rows))
                kl_sum, w_sum = torch.stack(sums).sum(dim=0)
                s_sum = huber_rows_wsum(tgt_s, recon_s, w, loss_cfg.huber_delta)
                r_sum = huber_rows_wsum(tgt_r, recon_r, w, loss_cfg.huber_delta)
                sw_sum = w_sum
            else:
                s_sum, r_sum, kl_sum, w_sum, sw_sum = torch.stack(sums).sum(dim=0)
            if mesh is not None and mesh.shape[DATA_AXIS] > 1:
                n = mesh.shape[DATA_AXIS]
                w_sum, sw_sum = mesh.all_reduce(torch.stack([w_sum, sw_sum]).detach(), DATA_AXIS)
                s_sum, r_sum, kl_sum = n * s_sum, n * r_sum, n * kl_sum
            total_w = torch.clamp(w_sum, min=1.0)
            return combine_losses(
                s_sum / torch.clamp(sw_sum, min=1.0), r_sum / total_w, kl_sum / total_w, loss_cfg, kl_scale
            )

    return loss_fn


def _plain_row_sums(loss_cfg: LossConfig, s_col_weight, mask, recon_s, recon_r, tgt_s, tgt_r, mu, logvar):
    """One window step's masked sums on the plain route: (state, reward,
    KL, valid slots, state-branch weight)."""
    if s_col_weight is not None:
        # the column lever: a weighted column mean per sample
        elem = _elem_loss(recon_s, tgt_s, loss_cfg)
        s_rows = torch.sum(elem * s_col_weight, dim=-1) / torch.sum(s_col_weight)
    elif loss_cfg.use_huber:
        s_rows = _huber_rows(recon_s, tgt_s, loss_cfg.huber_delta)
    else:
        s_rows = _mse_rows(recon_s, tgt_s)
    if recon_r.dim() == tgt_r.dim() + 1:
        # two-hot reward head: logits [B, A, K], cross-entropy per sample
        r_rows = torch.mean(twohot_ce_rows(recon_r, tgt_r), dim=-1)
    elif loss_cfg.use_huber:
        r_rows = _huber_rows(recon_r, tgt_r, loss_cfg.huber_delta)
    else:
        r_rows = _mse_rows(recon_r, tgt_r)
    kl_rows = _kl_rows(mu, logvar, loss_cfg.free_bits)
    if loss_cfg.contact_weight > 0.0:
        # contact transitions count (1 + contact_weight)x in the state branch
        contact = (torch.amax(tgt_r, dim=-1) > loss_cfg.contact_threshold).to(torch.float32)
        s_w = mask * (1.0 + loss_cfg.contact_weight * contact)
    else:
        s_w = mask
    return torch.stack([
        torch.sum(s_rows * s_w), torch.sum(r_rows * mask), torch.sum(kl_rows * mask), torch.sum(mask), torch.sum(s_w),
    ])


def make_unroll_train_step(
    spec: AgentSpec,
    loss_cfg: LossConfig,
    unroll_steps: int,
    mode: str = "Adam",
    use_pallas: bool = False,
    stop_gradient: bool = False,
    mean_feedback: bool = False,
    s_col_weight=None,
    mesh=None,
) -> Callable:
    """``(state, wbatch, generator=None, eps=None, eps_shared=None) ->
    (state, LossOutputs)``: one Adam update on the multi-step objective
    (with the global-norm clip and KL annealing of the one-step step), by
    the plain route or, with ``use_pallas``, the kernel route.
    ``wbatch`` comes from ``ItemBuffer.sample_window``; with a ``mesh`` it
    holds this data rank's windows (``make_train_step`` says the rest)."""
    if mode != "Adam":
        raise NotImplementedError(
            "unroll_steps > 1 supports train.mode='Adam' only (PopArt reward "
            "normalization is undefined for the multi-step objective)"
        )
    loss_fn = make_unroll_loss_fn(spec, loss_cfg, unroll_steps, stop_gradient, mean_feedback, s_col_weight, mesh,
                                  use_pallas)
    dp = mesh is not None and mesh.shape[DATA_AXIS] > 1

    def train_step(state, wbatch: GroupedTransition, generator=None, eps=None, eps_shared=None):
        out = loss_fn(state.model, wbatch, generator, _kl_scale(loss_cfg, state.step), eps, eps_shared)
        apply_update(state, out.loss, mesh)
        out = LossOutputs(*(x.detach() for x in out))
        return state, mean_over_data(out, mesh) if dp else out

    return train_step
