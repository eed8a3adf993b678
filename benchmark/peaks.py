"""The card's published peaks, the yardstick of every share of a peak.

One NVIDIA H100 SXM (80 GB HBM3) at its 700 W limit, dense, from NVIDIA's
data sheet; copied from ``mfvae_tpu_torch/bench/common.py`` ``PEAK_FLOPS``
and the HBM rate that ``chip_smoke.py`` holds K1-K3 against.  TF32 is off
in every run, so float32 products count against the float32 rate.
"""

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
