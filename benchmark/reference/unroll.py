"""The open-loop unroll objective in plain PyTorch, in float32: the window
draw, the masks after the first ``done``, the feedback of the model's own
prediction, the pooled ELBO, back-propagation through all W forwards, the
global-norm clip and Adam.  Built on ``model.py``'s ``forward``,
``mean_forward`` and ``split_state`` and on ``train.py``'s ``Adam`` and
``Follow``; it imports nothing of the program.

A train step draws, in this order, the windows from the sample stream
(``randint(0, size // block, (B,))`` for the block, then
``randint(0, block - W + 1, (B,))`` for the offset in it, the start
clamped to ``size - W``) and W eps ``randn(B, A, F)`` from the train
stream, one a window step.  Slot (b, t) counts while no ``done`` lies in
steps 0 .. t-1 of window b.  Step t's forward reads the observation fed
back from step t - 1 (the sampled reconstruction, or with
``unroll_mean_feedback`` the posterior-mean prediction; detached under
``unroll_stop_gradient``), the stored actions of step t, and is scored
against the stored next state and rewards of step t.  The loss is the jax
family's ``s_weight·(1 - rw)·s + rw·r + kw·kl`` of the pools
s = Σ_slots mask·mean_d huber(state), r alike for the reward, kl =
Σ_slots mask·KL, each over Σ_slots mask.

Departures from ``mfvae_tpu_torch/training/unroll.py``'s arithmetic:

- float32 throughout, TF32 off, where the program computes in its
  ``compute_dtype`` (bfloat16) with float32 parameters;
- the windows run in blocks of ``BLOCK`` windows, each block's W forwards
  and its backward at once.  The pool's denominators come from the
  ``done`` flags alone, so the loss is the sum of the blocks' sums, each
  over the global denominators, and its gradient the sum of theirs; the
  program takes all B windows at once;
- the pooled huber terms are each block's per-row means, weighted and
  summed, where the program's kernel K3w sums ``w·huber`` over the W·B
  stacked rows and divides by D at the end;
- the KL of a slot is summed over agents and latent dims at once, where
  the program's K1 sums over the latent dims of each agent, then over the
  agents;
- the clip scales the summed gradient once, as the program's does, from a
  norm of the leaves' norms taken in float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from benchmark.reference import model as M
from benchmark.reference import train as R

BLOCK = 512  # windows a block: 8 forwards' float32 activations of 512 windows fit a card easily


def draw_starts(size: int, block: int, window: int, n: int, gen: torch.Generator) -> torch.Tensor:
    """The program's ``sample_window`` draw with ``block``: n window starts."""
    a = torch.randint(0, max(size // block, 1), (n,), generator=gen, device=gen.device)
    b = torch.randint(0, block - window + 1, (n,), generator=gen, device=gen.device)
    return torch.clamp(a * block + b, max=max(size - window, 0))


def slot_masks(done: torch.Tensor) -> torch.Tensor:
    """done [B, W] -> mask [B, W]: 1 until the step after the first done."""
    alive = torch.cumprod(1.0 - done[:, :-1], dim=1)
    return torch.cat([torch.ones_like(done[:, :1]), alive], dim=1)


def huber_rows(x: torch.Tensor, y: torch.Tensor, delta: float) -> torch.Tensor:
    """Per-row mean of huber(x - y) over the last axis -> [rows]."""
    d = torch.abs(x - y)
    q = torch.clamp(d, max=delta)
    return torch.mean(0.5 * q * q + delta * (d - q), dim=-1)


def huber_rows_wsum64(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, delta: float, chunk: int = 4096) -> float:
    """Σ_r w_r · mean_d huber(x_rd - y_rd) in float64, a chunk of rows at a time."""
    total = 0.0
    for lo in range(0, x.shape[0], chunk):
        a = torch.abs(x[lo:lo + chunk].double() - y[lo:lo + chunk].double())
        q = torch.clamp(a, max=delta)
        total += float(torch.sum(torch.mean(0.5 * q * q + delta * (a - q), dim=-1) * w[lo:lo + chunk].double()))
    return total


def loss_weights(loss_cfg: dict):
    """(s_weight·(1 - rw), rw, kw) of the jax family's huber ELBO; any
    other loss raises."""
    if loss_cfg.get("family", "jax") != "jax" or not loss_cfg.get("use_huber", True):
        raise NotImplementedError("the reference implements the jax family's huber ELBO")
    for key in ("kl_anneal_steps", "free_bits", "contact_weight", "prey_dist_weight"):
        if loss_cfg.get(key):
            raise NotImplementedError(f"the reference has no loss.{key}")
    kw = 0.1 if loss_cfg.get("kl_weight") is None else loss_cfg["kl_weight"]
    rw = 0.5 if loss_cfg.get("r_weight") is None else loss_cfg["r_weight"]
    return loss_cfg.get("s_weight", 1.0) * (1.0 - rw), rw, kw


class StepRecord:
    """What a followed step 1 showed: the first and the W-th forward's
    state output (the delta under ``residual_state``) and the first's
    reward, and the two pooled huber sums beside their float64 values on
    the same inputs."""

    def __init__(self):
        self.first: List[tuple] = []
        self.last: List[torch.Tensor] = []
        self.k3w: List[float] = [0.0, 0.0]
        self.k3w64: List[float] = [0.0, 0.0]


def unroll_step(params: Dict[str, torch.Tensor], opt: R.Adam, conf: dict, spec: M.Spec, ring: dict,
                starts: torch.Tensor, eps: torch.Tensor, pr: M.Precision, record: Optional[StepRecord] = None,
                half_batch: bool = False):
    """One clipped Adam step on the windows at ``starts`` [B] with eps [W,
    B, A, F] -> ((loss, s, r, kl), the clipped gradient by leaf).
    ``half_batch`` (a fault the checks must catch) runs every window's
    forwards but takes the loss over the first half of the windows only:
    the second half's slots weigh 0, in the pools and in their
    denominators, so the outputs are the sound step's and only the
    gradient and the update move."""
    m, t_cfg = conf["model"], conf["train"]
    window, clip = t_cfg["unroll_steps"], t_cfg["grad_clip"]
    delta = conf["loss"].get("huber_delta", 1.0)
    ws, rw, kw = loss_weights(conf["loss"])
    cap = ring["rewards"].shape[0]
    idx = (starts[:, None] + torch.arange(window, device=starts.device)) % cap  # [B, W]
    mask = slot_masks(ring["done"][idx].to(torch.float32))
    if half_batch:
        mask[starts.shape[0] // 2:] = 0.0
    den = torch.clamp(mask.sum(), min=1.0)
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    totals = torch.zeros(3, device=starts.device)
    for v in params.values():
        v.requires_grad_(True)
    for lo in range(0, starts.shape[0], BLOCK):
        rows = idx[lo:lo + BLOCK]
        obs = [o[rows[:, 0]] for o in ring["obs"]]
        sums = []
        for t in range(window):
            actions = [a[rows[:, t]] for a in ring["actions"]]
            tgt_s = M.global_state([o[rows[:, t]] for o in ring["next_obs"]])
            tgt_r = ring["rewards"][rows[:, t]]
            state, reward, mu, logvar = M.forward(params, m, spec, obs, actions, eps[t, lo:lo + BLOCK], pr)
            w = mask[lo:lo + BLOCK, t]
            if record is not None:
                raw = state - M.global_state(obs) if m["residual_state"] else state
                if t == 0:
                    record.first.append((raw.detach().clone(), reward.detach().clone()))
                if t == window - 1:
                    record.last.append(raw.detach().clone())
                for i, (x, y) in enumerate(((tgt_s, state), (tgt_r, reward))):
                    record.k3w64[i] += huber_rows_wsum64(x.detach(), y.detach(), w, delta)
            kl = torch.sum((-0.5 * (1.0 + logvar - mu * mu - torch.exp(logvar))).reshape(mu.shape[0], -1), dim=1)
            sums.append(torch.stack([torch.sum(huber_rows(state, tgt_s, delta) * w),
                                     torch.sum(huber_rows(reward, tgt_r, delta) * w), torch.sum(kl * w)]))
            if t + 1 < window:
                fb = M.mean_forward(params, m, spec, obs, actions, pr)[0] if t_cfg["unroll_mean_feedback"] else state
                obs = M.split_state(spec, fb.detach() if t_cfg["unroll_stop_gradient"] else fb)
        s, r, kl = torch.stack(sums).sum(dim=0)
        loss = (ws * s + rw * r + kw * kl) / den
        for k, g in zip(params, torch.autograd.grad(loss, list(params.values()))):
            grads[k] += g
        totals += torch.stack([s, r, kl]).detach()
        if record is not None:
            record.k3w[0] += float(s.detach())
            record.k3w[1] += float(r.detach())
    for v in params.values():
        v.requires_grad_(False)
    if clip > 0:
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads.values()]))
        factor = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
        for g in grads.values():
            g.mul_(factor)
    opt.step(params, grads)
    s, r, kl = totals / den
    return torch.stack([ws * s + rw * r + kw * kl, s, r, kl]), grads


def follow_steps(params: Dict[str, torch.Tensor], conf: dict, spec: M.Spec, ring: dict, gens, pr: M.Precision,
                 steps: int = 3, half_batch: bool = False):
    """The first ``steps`` train steps of a run from ``params`` (changed in
    place), drawing as the program's unroll train phase draws ->
    (``R.Follow`` of them, step 1's ``StepRecord``)."""
    m, t_cfg = conf["model"], conf["train"]
    b, window = conf["buffer"]["batch_size"], t_cfg["unroll_steps"]
    size = ring["rewards"].shape[0]
    opt = R.Adam(params, t_cfg["lr"])
    follow = R.Follow(params, steps)
    record = StepRecord()
    for i in range(steps):
        starts = draw_starts(size, t_cfg["sample_num"], window, b, gens["sample"])
        g = gens["train"]
        eps = torch.stack([torch.randn((b, spec.n, m["obs_features"]), generator=g, device=g.device)
                           for _ in range(window)])
        out, grads = unroll_step(params, opt, conf, spec, ring, starts, eps, pr, record if i == 0 else None,
                                 half_batch)
        follow.losses.append(out)
        if i == 0:
            follow.first_grad = {k: v.clone() for k, v in grads.items()}
            follow.first_out = tuple(torch.cat(x) for x in zip(*record.first))
    follow.params_after = {k: v.detach().clone() for k, v in params.items()}
    record.last = torch.cat(record.last)
    return follow, record
