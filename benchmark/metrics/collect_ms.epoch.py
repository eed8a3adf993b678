"""Both collect phases of an epoch (train and test ring), each timed on
the host clock between device syncs, summed per epoch and averaged over
the phase-timed epochs."""


def read(data):
    ms = data["phases"]["collect_ms"]
    return sum(ms) / len(ms)
