"""Operations of the distill cell, frozen here beside ``benchmark/flops.py``
(which this file builds on and leaves as it is).

A distillation update runs the world model's posterior-mean forward on
S·V rows in the visitation (V steps of S starts) and on S·(1+V)·M·K rows
for each of the teacher's H steps, and the policy (an MLP of the
observation row, hidden widths, K logits, one row a plan agent) forward
on the S·V·P rows the visitation acts on and forward and backward (three
times the forward) on the S·(1+V)·P rows it is fitted to.  FLOPs count
the matrix products, 2·rows·in·out each, as ``flops.py`` counts them;
``benchmark/tests/test_benchmark_distill.py`` holds the count equal to
``torch.utils.flop_counter``'s count of one small update.
"""

from __future__ import annotations

from typing import Sequence

from benchmark.flops import rollout_flops
from benchmark.reference import distill as D
from benchmark.reference import model as M


def policy_flops_per_row(obs_dim: int, hidden: Sequence[int], arms: int) -> int:
    widths = [obs_dim, *hidden, arms]
    return sum(2 * a * b for a, b in zip(widths[:-1], widths[1:]))


def update_flops(conf: dict, spec: M.Spec) -> int:
    """An update's FLOPs at the sizes the reference reads off the
    configuration (``reference.distill.shape``, which refuses what it does
    not implement)."""
    sh = D.shape(conf, spec)
    labelled = sh.starts * (1 + sh.visit_steps)
    m = conf["model"]
    world = rollout_flops(m, spec.obs_dims, spec.act_dims, labelled * sh.m_rollouts * sh.arms, sh.horizon) \
        + rollout_flops(m, spec.obs_dims, spec.act_dims, sh.starts, sh.visit_steps)
    per_row = policy_flops_per_row(spec.obs_dims[0], conf["behavior"]["hidden"], sh.arms)
    return world + per_row * sh.plan * (sh.starts * sh.visit_steps + 3 * labelled)
