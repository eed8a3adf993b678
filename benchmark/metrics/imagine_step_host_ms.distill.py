"""Host milliseconds of one imagined world-model step of a distillation
update: the mean duration of the program's ``mfvae.imagine.step`` spans
(each a ``WorldModel._predict`` and the refeed of its state, in
``imagination.py``'s visitation rollout and teacher loop) in the profiled
stretch.  The profiler slows the host, so this is the traced time.  Set
beside a teacher step's device time, it tells whether the eager step's
dispatch or the device sets the update's pace.

The reader reads nothing unless the trace holds H + V such spans a
profiled update (none: the program has no such span)."""

SPAN = "mfvae.imagine.step"


def read(data):
    spans = [(lo, hi) for lo, hi, name in data["prof"].host if name == SPAN]
    shapes = data["shapes"]
    if not spans or len(spans) != (shapes["horizon"] + shapes["visit_steps"]) * data["profiled"]["steps"]:
        return None
    return sum(hi - lo for lo, hi in spans) * 1e-3 / len(spans)
