"""Host milliseconds a train step spends drawing its batch: the summed
durations of the program's ``mfvae.train.sample`` spans (``ItemBuffer.sample``
and ``vae_batch_from_grouped``, in ``make_phase_fns``' ``train_phase``) in
the profiled stretch, over its steps.  The profiler slows the host, so
this is the traced time.

A step draws once; the reader reads nothing where the trace holds another
number of such spans (none: the program has no such span)."""

SPAN = "mfvae.train.sample"


def read(data):
    spans = [(lo, hi) for lo, hi, name in data["prof"].host if name == SPAN]
    steps = data["profiled"]["steps"]
    if not spans or len(spans) != steps:
        return None
    return sum(hi - lo for lo, hi in spans) * 1e-3 / steps
