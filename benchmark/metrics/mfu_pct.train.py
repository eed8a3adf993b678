"""The train step's share of the card's peak: the frozen FLOPs of a step
(``benchmark/flops.py``) times the steps of a stretch timed on the host
clock, over its wall time (ending in a device sync), against the peak of
the compute dtype (``benchmark/peaks.py``)."""

from benchmark.peaks import PEAK_FLOPS


def read(data):
    plain = data["plain"]
    return 100.0 * data["flops"]["train_step"] * plain["steps"] / plain["wall_s"] / PEAK_FLOPS[data["compute_dtype"]]
