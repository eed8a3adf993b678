"""A request's share of the card's peak: the frozen FLOPs of a request
(``horizon`` forwards of ``batch`` rows, ``benchmark/flops.py``) times the
requests of a stretch timed on the host clock, over its wall time,
against the peak of the compute dtype (``benchmark/peaks.py``)."""

from benchmark.peaks import PEAK_FLOPS


def read(data):
    plain = data["plain"]
    return 100.0 * data["flops"]["request"] * plain["requests"] / plain["wall_s"] / PEAK_FLOPS[data["compute_dtype"]]
