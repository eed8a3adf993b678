"""K3w's share of its roofline in the unroll train step: the least time of
each call (its bytes, ``benchmark/flops_unroll.py`` ``k3w_bytes``, at the
HBM rate) summed over the calls, over the device time of the kernels so
named.

A step calls K3w twice, over the W·B stacked rows: on the state branch
(D = Σobs) and on the reward branch (D = agents), both in float32; the
reader counts those two per step and reads nothing where the trace holds
another number of calls (the kernel is off the path, or renamed)."""

from benchmark.flops_unroll import k3w_bytes
from benchmark.peaks import HBM_BYTES_PER_S

KERNELS = ("huber_rows_wsum_kernel",)


def read(data):
    calls = data["prof"].kernels(KERNELS)
    steps, s = data["profiled"]["steps"], data["shapes"]
    if not calls or len(calls) != 2 * steps:
        return None
    rows = s["window"] * s["batch"]
    least = steps * (k3w_bytes(rows, s["sum_obs"]) + k3w_bytes(rows, s["agents"])) / HBM_BYTES_PER_S
    return 100.0 * least / (sum(hi - lo for _, lo, hi, _ in calls) * 1e-6)
