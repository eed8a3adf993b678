"""Operations and bytes of the unroll cell, frozen here beside
``benchmark/flops.py`` (which this file builds on and leaves as it is).

An unroll train step runs W forwards of its B windows' rows and one
backward through all of them, so its FLOPs are W times a one-step train
step's at batch B (``mfvae_tpu_torch/bench/common.py`` ``step_flops(model,
B, W)`` counts the same; ``benchmark/tests/test_benchmark_unroll.py``
holds the two equal).  Kernel K3w (``huber_rows_wsum``) reads x and y
[R, D] and the weights [R] once and writes one float32.
"""

from __future__ import annotations

from benchmark.flops import F32, forward_flops_per_row


def unroll_step_flops(m: dict, obs_dims, act_dims, batch: int, window: int) -> int:
    return window * 3 * batch * forward_flops_per_row(m, obs_dims, act_dims)


def k3w_bytes(rows: int, d: int, itemsize: int = F32) -> int:
    """K3w reads x and y [rows, d] of ``itemsize`` bytes and the float32
    weights [rows], and writes one float32."""
    return 2 * rows * d * itemsize + F32 * rows + F32
