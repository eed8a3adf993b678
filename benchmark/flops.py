"""Operations and bytes from the configuration's widths, frozen here so
that no change to the program moves the yardstick.

FLOPs count the matrix products, 2·rows·in·out each, as
``mfvae_tpu_torch/bench/common.py`` ``step_flops`` counts them from the
model's modules (``benchmark/tests/test_benchmark_flops.py`` holds the two
equal): every encoder layer (per agent), every decoder layer and head, the
[A, A] reward layer; the action embeddings are gathers, with no product.
A train step is three times its forward (the forward, the input's
gradient and the weight's gradient).

Bytes are those of K1-K3 (``mfvae_tpu_torch/ops/csrc/fused_elbo.cu``) as
``chip_smoke.py`` bounds them: each input read once and each output
written once.
"""

from __future__ import annotations

from typing import Sequence

F32 = 4


def _mlp(widths: Sequence[int]) -> int:
    return sum(2 * a * b for a, b in zip(widths[:-1], widths[1:]))


def forward_flops_per_row(m: dict, obs_dims: Sequence[int], act_dims: Sequence[int]) -> int:
    """Matrix-product FLOPs of one forward of one row (all agents)."""
    n, f, af, det = len(obs_dims), m["obs_features"], m["action_features"], m["det_features"]
    sum_obs = sum(obs_dims)
    total = 0
    for od in obs_dims:  # per-agent encoders (stacked per group)
        total += _mlp([m["idx_features"] + od, *m["encoder_hidden"], 2 * f + det])
        if m["action_delta_head"]:
            total += 2 * af * od
    d_in = n * (f + af + det) + (sum_obs if m["state_skip"] else 0)
    hidden = list(m["decoder_hidden"])
    if m["fused_decoders"]:
        total += 2 * _mlp([d_in, *hidden]) + 2 * hidden[-1] * (sum_obs + n)
    else:
        r_in = sum_obs + n * af + (sum_obs if (m["residual_state"] or m["state_skip"]) else 0) \
            if m["reward_head_input"] == "pred_state" else d_in
        total += _mlp([d_in, *hidden, sum_obs]) + _mlp([r_in, *hidden, n])
    return total + 2 * n * n


def train_step_flops(m: dict, obs_dims, act_dims, batch: int) -> int:
    return 3 * batch * forward_flops_per_row(m, obs_dims, act_dims)


def epoch_flops(cfg: dict, obs_dims, act_dims) -> int:
    """train_num train steps and the test phase's test_num forwards."""
    b, t = cfg["buffer"]["batch_size"], cfg["train"]
    fwd = forward_flops_per_row(cfg["model"], obs_dims, act_dims)
    return t["train_num"] * 3 * b * fwd + t["test_num"] * b * fwd


def rollout_flops(m: dict, obs_dims, act_dims, batch: int, horizon: int) -> int:
    return horizon * batch * forward_flops_per_row(m, obs_dims, act_dims)


def k1_bytes(rows: int, f: int) -> int:
    """K1 reads mu, logvar, eps [rows, F] and writes z [rows, F] and the
    KL [rows], all float32."""
    return (4 * rows * f + rows) * F32


def k2_bytes(rows: int, f: int) -> int:
    """K2 reads mu, logvar, eps, dz [rows, F] and dkl [rows], and writes
    dmu and dlogvar [rows, F]."""
    return (6 * rows * f + rows) * F32


def k3_bytes(n: int, itemsize: int = F32) -> int:
    """K3 reads x and y [n] and writes one float32."""
    return 2 * n * itemsize + F32
