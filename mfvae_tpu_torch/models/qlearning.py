"""Recurrent Q-learning building blocks for the baselines (mirror of
``mfvae_tpu/models/qlearning.py``).

A GRU stepped over the leading time axis with its hidden state reset at
episode boundaries, the obs -> Dense -> ReLU -> GRU -> Dense agent network,
a linearly annealed epsilon and the epsilon-greedy explorer.

The GRU keeps flax's ``nn.GRUCell`` layout, so a JAX parameter tree maps
onto it by name (``models/convert.py``): leaves ``ir``/``iz``/``in`` (input
kernels with a bias), ``hr``/``hz`` (recurrent kernels, no bias) and ``hn``
(recurrent kernel with a bias), every kernel [in, out]; flax computes
n = tanh(W_in x + b_in + r * (W_hn h + b_hn)).  ``torch.nn.GRUCell`` is the
same function, but its packed weights and gate order would turn the bridge
into a re-packing.  Initialization follows flax's: lecun-normal input and
head kernels, orthogonal recurrent kernels, zero biases.

With ``stack`` = N > 0 every leaf has a leading [N] axis and agent n runs
on slice n, which is what the JAX package's ``nn.vmap`` over the agent axis
gives the independent-parameter network.

The random draws are inputs: ``eps_greedy`` takes an ``EpsNoise`` or draws
one from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from mfvae_tpu_torch.models.layers import Dense, StackedDense


def _lin(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ kernel (+ bias); a stacked kernel [N, in, out] maps x [..., N, in]
    agent by agent."""
    y = x @ kernel if kernel.dim() == 2 else torch.einsum("...ni,nio->...no", x, kernel)
    return y if bias is None else y + bias


def _dense(in_dim: int, features: int, stack: int, device, generator, use_bias: bool = True) -> nn.Module:
    if stack:
        return StackedDense(stack, in_dim, features, device=device, generator=generator, use_bias=use_bias)
    return Dense(in_dim, features, device=device, generator=generator, use_bias=use_bias)


class GRUCell(nn.Module):
    """The parameters of flax's ``GRUCell`` (``ScannedGRU`` steps them)."""

    def __init__(self, in_dim: int, hidden_dim: int, stack: int = 0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, _dense(in_dim, hidden_dim, stack, device, generator))
        for name in ("hr", "hz", "hn"):
            layer = _dense(hidden_dim, hidden_dim, stack, device, generator, use_bias=name == "hn")
            with torch.no_grad():
                for k in layer.kernel.reshape(-1, hidden_dim, hidden_dim):
                    nn.init.orthogonal_(k, generator=generator)
            self.add_module(name, layer)


class ScannedGRU(nn.Module):
    """A GRU cell stepped over the leading time axis; the carry is zeroed
    before step t where ``done[t]`` (a new episode starts there)."""

    def __init__(self, in_dim: int, hidden_dim: int, stack: int = 0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.cell = GRUCell(in_dim, hidden_dim, stack, device, generator)

    @staticmethod
    def initialize_carry(batch_size: int, hidden_dim: int, device=None) -> torch.Tensor:
        return torch.zeros((batch_size, hidden_dim), device=device)

    def forward(self, carry: torch.Tensor, inputs):
        """carry [B, H] (stacked: [B, N, H]); inputs = (x [T, B, D]
        (stacked: [T, B, N, D]), done [T, B]) -> (carry, ys [T, B(, N), H])."""
        x, done = inputs
        c, h = self.cell, self.hidden_dim
        cell_in = getattr(c, "in")
        # the input projections of every step at once; flax sums each gate
        # as (W_i x + b_i) + W_h h, in that order, as here
        gi = _lin(x, torch.cat([c.ir.kernel, c.iz.kernel, cell_in.kernel], -1),
                  torch.cat([c.ir.bias, c.iz.bias, cell_in.bias], -1))
        w_h = torch.cat([c.hr.kernel, c.hz.kernel, c.hn.kernel], -1)
        ys = []
        for t in range(x.shape[0]):
            d = done[t]
            carry = torch.where(d.reshape(d.shape + (1,) * (carry.dim() - d.dim())), 0.0, carry)
            gh = _lin(carry, w_h)
            r = torch.sigmoid(gi[t, ..., :h] + gh[..., :h])
            z = torch.sigmoid(gi[t, ..., h:2 * h] + gh[..., h:2 * h])
            n = torch.tanh(gi[t, ..., 2 * h:] + r * (gh[..., 2 * h:] + c.hn.bias))
            carry = (1.0 - z) * n + z * carry
            ys.append(carry)
        return carry, torch.stack(ys)


class AgentRNN(nn.Module):
    """obs -> Dense -> ReLU -> GRU -> Dense Q-head (``dense0``, ``gru``,
    ``dense1``; flax's ``Dense_0``, ``ScannedGRU_0``, ``Dense_1``)."""

    def __init__(self, in_dim: int, action_dim: int, hidden_dim: int = 64, stack: int = 0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.action_dim, self.hidden_dim = action_dim, hidden_dim
        self.dense0 = _dense(in_dim, hidden_dim, stack, device, generator)
        self.gru = ScannedGRU(hidden_dim, hidden_dim, stack, device, generator)
        self.dense1 = _dense(hidden_dim, action_dim, stack, device, generator)

    def forward(self, hidden, obs, done):
        """hidden [B, H]; obs [T, B, D]; done [T, B] -> (hidden [B, H],
        q [T, B, action_dim]); stacked, an [N] axis before the features."""
        x = torch.relu(_lin(obs, self.dense0.kernel, self.dense0.bias))
        hidden, x = self.gru(hidden, (x, done))
        return hidden, _lin(x, self.dense1.kernel, self.dense1.bias)


def epsilon_by_step(step: int, eps_start: float, eps_finish: float, eps_decay_steps: float) -> float:
    """Linear anneal, computed in float32 as the JAX package does."""
    f32 = np.float32
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.clip(f32(step) / f32(eps_decay_steps), f32(0.0), f32(1.0))
    return float(f32(eps_start) + frac * f32(eps_finish - eps_start))


class EpsNoise(NamedTuple):
    """The draws of one epsilon-greedy call over actions of shape L."""

    uniform: torch.Tensor  # [*L] float: < eps -> explore
    random: torch.Tensor  # [*L] int32 uniform action


def draw_eps_noise(generator: Optional[torch.Generator], shape, n_actions: int, device) -> EpsNoise:
    random_a = torch.randint(0, n_actions, tuple(shape), generator=generator, device=device, dtype=torch.int32)
    return EpsNoise(torch.rand(tuple(shape), generator=generator, device=device), random_a)


def eps_greedy(q_vals: torch.Tensor, eps: float, generator: Optional[torch.Generator] = None,
               noise: Optional[EpsNoise] = None) -> torch.Tensor:
    """q_vals [..., n_actions] -> int32 actions [...]: the argmax (the
    first maximum), or a uniform action with probability ``eps``."""
    greedy = torch.argmax(q_vals, dim=-1).to(torch.int32)
    if noise is None:
        noise = draw_eps_noise(generator, greedy.shape, q_vals.shape[-1], q_vals.device)
    return torch.where(noise.uniform < eps, noise.random, greedy)
