"""Host milliseconds of one window step of the unroll train step: the mean
duration of the program's ``mfvae.train.unroll.step`` spans (each holding
a window step's forward, its row terms and its feedback, in
``training/unroll.py``) in the profiled stretch.  The profiler slows the
host, so this is the traced time.

The reader reads nothing unless the trace holds W such spans a profiled
step (none: the program has no such span)."""

SPAN = "mfvae.train.unroll.step"


def read(data):
    spans = [(lo, hi) for lo, hi, name in data["prof"].host if name == SPAN]
    if not spans or len(spans) != data["shapes"]["window"] * data["profiled"]["steps"]:
        return None
    return sum(hi - lo for lo, hi in spans) * 1e-3 / len(spans)
