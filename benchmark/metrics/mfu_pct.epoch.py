"""The epoch's share of the card's peak: the frozen FLOPs of an epoch
(train steps and the test phase's forwards, ``benchmark/flops.py``) times
the epochs of a stretch timed on the host clock, over its wall time,
against the peak of the compute dtype (``benchmark/peaks.py``)."""

from benchmark.peaks import PEAK_FLOPS


def read(data):
    plain = data["plain"]
    return 100.0 * data["flops"]["epoch"] * plain["epochs"] / plain["wall_s"] / PEAK_FLOPS[data["compute_dtype"]]
