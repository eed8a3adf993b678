"""The epoch's train phase (buffer samples and train steps), timed on
the host clock between device syncs, averaged over the phase-timed
epochs."""


def read(data):
    ms = data["phases"]["train_ms"]
    return sum(ms) / len(ms)
