"""The share of a request's steps served by a replayed CUDA graph: of the
program's ``mfvae.rollout.step`` spans in the profiled stretch, the
percentage that hold a ``mfvae.rollout.replay`` span (``WorldModel``
replays one a step served by its graph, and none a step run eagerly).
None where the program has no step span."""

import bisect

STEP, REPLAY = "mfvae.rollout.step", "mfvae.rollout.replay"


def read(data):
    host = data["prof"].host
    steps = [(lo, hi) for lo, hi, name in host if name == STEP]
    if not steps:
        return None
    replays = sorted(lo for lo, _, name in host if name == REPLAY)
    held = 0
    for lo, hi in steps:
        i = bisect.bisect_left(replays, lo)
        held += i < len(replays) and replays[i] <= hi
    return 100.0 * held / len(steps)
