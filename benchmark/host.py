"""The host side of a run: one process with one compute thread on a fixed
pair of cores, and what the rest of the machine did while the window ran.

The cells are bound by the host's dispatch of eager PyTorch, so a run's
numbers move with the core it runs on.  ``steady`` (called before torch is
imported) limits the CPU thread pools to one thread and pins the process
to two cores on different physical cores, the highest-numbered ones the
process may use, so that no run migrates between cores or shares one with
a spinning pool thread.  ``Load`` reads ``/proc/stat`` and the process's
own counters around the window: the share of the machine's time the
hypervisor stole, how busy the cores outside the pinned pair were, and how
often the process was switched out against its will.  Imports no torch.
"""

from __future__ import annotations

import os
import resource
import time
from typing import Dict, List, Set

THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def siblings(cpu: int) -> Set[int]:
    """The logical CPUs that share ``cpu``'s physical core (itself at least)."""
    path = f"/sys/devices/system/cpu/cpu{cpu}/topology/thread_siblings_list"
    try:
        text = open(path).read().strip()
    except OSError:
        return {cpu}
    out: Set[int] = set()
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.update(range(int(lo), int(hi or lo) + 1))
    return out | {cpu}


def choose(allowed: Set[int], siblings_of=siblings) -> List[int]:
    """The highest allowed CPU and the highest one on another physical
    core (or the next highest, where every allowed CPU shares one core)."""
    order = sorted(allowed, reverse=True)
    if len(order) <= 2:
        return sorted(order)
    first = order[0]
    other = next((c for c in order[1:] if c not in siblings_of(first)), order[1])
    return sorted([first, other])


def steady() -> List[int]:
    """One CPU thread a pool, the process pinned; -> the pinned CPUs."""
    for var in THREAD_VARS:
        os.environ[var] = "1"
    cpus = choose(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cpus)
    return cpus


def _cpu_times() -> Dict[str, List[int]]:
    out = {}
    with open("/proc/stat") as f:
        for line in f:
            if line.startswith("cpu"):
                name, *ticks = line.split()
                out[name] = [int(t) for t in ticks[:8]]
    return out


class Load:
    """What the machine did between ``Load()`` and ``read()``."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.stat0 = _cpu_times()
        self.usage0 = resource.getrusage(resource.RUSAGE_SELF)

    def read(self) -> dict:
        wall = time.perf_counter() - self.t0
        stat1, usage1 = _cpu_times(), resource.getrusage(resource.RUSAGE_SELF)
        mine = {f"cpu{c}" for c in os.sched_getaffinity(0)}

        def delta(name):
            return [b - a for a, b in zip(self.stat0[name], stat1[name])]

        total = delta("cpu")
        others = [delta(n) for n in stat1 if n != "cpu" and n not in mine and n in self.stat0]
        busy = sum(sum(d) - d[3] - d[4] for d in others)
        return {
            "pinned": sorted(os.sched_getaffinity(0)),
            "steal_pct": 100.0 * total[7] / max(sum(total), 1),
            "others_busy_pct": 100.0 * busy / max(sum(sum(d) for d in others), 1),
            "process_cpu_per_wall": (usage1.ru_utime + usage1.ru_stime - self.usage0.ru_utime - self.usage0.ru_stime)
            / max(wall, 1e-9),
            "involuntary_switches": usage1.ru_nivcsw - self.usage0.ru_nivcsw,
        }
