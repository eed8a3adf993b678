"""K3's share of its roofline in the train step: the least time of each
call (its bytes, ``benchmark/flops.py`` ``k3_bytes``, at the HBM rate)
summed over the calls, over the device time of the kernels so named.

A step calls K3 twice, on the state branch (n = batch × Σobs) and on the
reward branch (n = batch × agents), both in float32; the reader counts
those two per step and reads nothing where the trace holds another
number of calls (the kernel is off the path, or renamed)."""

from benchmark.flops import k3_bytes
from benchmark.peaks import HBM_BYTES_PER_S

KERNELS = ("huber_mean_kernel",)


def read(data):
    calls = data["prof"].kernels(KERNELS)
    steps, s = data["profiled"]["steps"], data["shapes"]
    if not calls or len(calls) != 2 * steps:
        return None
    least = steps * (k3_bytes(s["batch"] * s["sum_obs"]) + k3_bytes(s["batch"] * s["agents"])) / HBM_BYTES_PER_S
    return 100.0 * least / (sum(hi - lo for _, lo, hi, _ in calls) * 1e-6)
