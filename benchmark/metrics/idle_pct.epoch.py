"""The device's idle share of the cell's own loop: one less the device's
busy time a epoch (the union of its operations' intervals in the
profiled stretch, over its epochs) over the wall time a epoch of the
stretch timed without the profiler, which slows the host."""


def read(data):
    prof, plain = data["prof"], data["plain"]
    if not prof.device_ops:
        return None
    busy = prof.busy_s() / data["profiled"]["epochs"]
    return 100.0 * (1.0 - busy / (plain["wall_s"] / plain["epochs"]))
