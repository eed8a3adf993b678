"""Host milliseconds of one step of a rollout request: the mean duration
of the program's ``mfvae.rollout.step`` spans (each ``MAVAE.mean_call`` of
``WorldModel._rollout``) in the profiled stretch.  The profiler slows the
host, so this is the traced time.

The reader reads nothing unless the trace holds one ``mfvae.rollout``
span a profiled request, each holding the same number of steps, and no
step outside them: the profiled requests times the horizon (none: the
program has no such span)."""

REQUEST, STEP = "mfvae.rollout", "mfvae.rollout.step"


def read(data):
    host = data["prof"].host
    requests = [(lo, hi) for lo, hi, name in host if name == REQUEST]
    steps = [(lo, hi) for lo, hi, name in host if name == STEP]
    if not steps or len(requests) != data["profiled"]["requests"]:
        return None
    held = {sum(rlo <= lo and hi <= rhi for lo, hi in steps) for rlo, rhi in requests}
    if len(held) != 1 or held.pop() * len(requests) != len(steps):
        return None
    return sum(hi - lo for lo, hi in steps) * 1e-3 / len(steps)
