"""K1's and K2's share of their roofline in the train step: the least
time of each call (``benchmark/flops.py`` ``k1_bytes``/``k2_bytes`` over
the [batch × agents, latent] rows a step hands them, at the HBM rate)
summed over the calls, over the device time of the kernels so named.  A
step calls each once; the reader reads nothing where the trace holds
another number of calls."""

from benchmark.flops import k1_bytes, k2_bytes
from benchmark.peaks import HBM_BYTES_PER_S

KERNELS = ("reparam_kl_fwd_kernel", "reparam_kl_bwd_kernel")


def read(data):
    prof, steps, s = data["prof"], data["profiled"]["steps"], data["shapes"]
    fwd, bwd = prof.kernels(KERNELS[:1]), prof.kernels(KERNELS[1:])
    if not fwd or len(fwd) != steps or len(bwd) != steps:
        return None
    rows = s["batch"] * s["agents"]
    least = steps * (k1_bytes(rows, s["latent"]) + k2_bytes(rows, s["latent"])) / HBM_BYTES_PER_S
    return 100.0 * least / (sum(hi - lo for _, lo, hi, _ in fwd + bwd) * 1e-6)
