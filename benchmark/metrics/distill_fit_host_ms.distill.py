"""Host milliseconds of the policy's fit in a distillation update: the
mean duration of the program's ``mfvae.distill.fit`` spans (the policy's
forward on the labelled states, the cross-entropy to the teacher's
targets and the Adam step, in ``imagination.py``'s
``make_distillation_trainer``) in the profiled stretch.  The profiler
slows the host, so this is the traced time.

The reader reads nothing unless the trace holds one such span a profiled
update (none: the program has no such span)."""

SPAN = "mfvae.distill.fit"


def read(data):
    spans = [(lo, hi) for lo, hi, name in data["prof"].host if name == SPAN]
    if not spans or len(spans) != data["profiled"]["steps"]:
        return None
    return sum(hi - lo for lo, hi in spans) * 1e-3 / len(spans)
