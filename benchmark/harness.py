"""One run of one cell: set-up, the measured window (or, with ``trace``,
the traced stretches), the device's numbers, then the comparison with the
plain reference that decides ``correct``.

Everything of a cell is found by name: its workload file names the
configuration and the driver, ``BENCHMARK.json`` names the metrics the
cell reports, and each per-layer metric is read by its own reader.  The
driver (``drivers/<name>.py``) has four functions: ``setup(run)``,
``window(run, seconds)`` -> (end-to-end values, attempted, failed),
``trace(run)`` -> (what the readers read, the profiled stretch),
``release(run)`` and ``check(run)`` -> {number: reading}; ``verdict``
holds the readings against the cell's limits.
"""

from __future__ import annotations

import gc
import json
import math
import time
from typing import Dict, Optional, Sequence

import torch

from benchmark import common, host


def parse_overrides(cfg: dict, overrides: Sequence[str]) -> dict:
    """``a.b=<json>`` overrides applied to a configuration dict."""
    for ov in overrides:
        path, raw = ov.split("=", 1)
        *head, key = path.split(".")
        node = cfg
        for part in head:
            node = node[part]
        try:
            node[key] = json.loads(raw)
        except json.JSONDecodeError:
            node[key] = raw
    return cfg


class Run:
    """What a driver reads and keeps: the cell, its configuration for the
    program (``cfg``) and for the reference (``conf``, the same file as a
    dict), the seed, the device and the traffic parameters."""

    def __init__(self, cell: str, seed: int, dev: torch.device, overrides: Sequence[str] = ()):
        from mfvae_tpu_torch.config import load_config

        self.cell = cell
        self.work = common.workload(cell)
        self.traffic = self.work["traffic"]
        every = list(self.work.get("overrides", [])) + list(overrides)
        path = common.HERE / "configs" / f"{self.work['config']}.json"
        self.cfg = load_config(str(path), every)
        self.cfg.train.seed = int(seed)
        self.conf = parse_overrides(common.config_dict(self.work["config"]), every)
        self.seed = int(seed)
        self.dev = dev
        self.state: dict = {}
        self.marks: list = []  # (what, host clock) along the set-up

    def mark(self, what: str) -> None:
        self.marks.append((what, time.perf_counter()))


def _listed(entry: dict, cell: str) -> bool:
    return cell in entry.get("workloads", [cell])


def cell_metrics(bench: dict, cell: str):
    """(end-to-end entries, per-layer entries) that the cell reports."""
    e2e = [m for m in bench["end_to_end"] if _listed(m, cell)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def verdict(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True where every number the cell compares was read, is finite and
    lies at or under its limit."""
    return all(readings.get(k) is not None and math.isfinite(readings[k]) and readings[k] <= v
               for k, v in limits.items())


def run_cell(cell: str, seed: int, seconds: float, trace: bool, t0: float,
             dev: Optional[torch.device] = None, overrides: Sequence[str] = ()) -> dict:
    bench = common.load_json(common.ROOT / "BENCHMARK.json")
    # a workload file not (yet) listed in BENCHMARK.json runs on one card
    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == cell), 1)
    if dev is None:
        dev = common.cuda_device(chips)
    run = Run(cell, seed, dev, overrides)
    run.mark("imports")
    driver = common.load_module("drivers", run.work["driver"])
    e2e, layer = cell_metrics(bench, cell)
    driver.setup(run)
    common.sync(dev)
    setup_s = time.perf_counter() - t0
    out = {"correct": False, "attempted": 0, "failed": 0, "metrics": {},
           "setup_marks": [[what, t - t0] for what, t in run.marks] + [["setup", setup_s]]}
    load = host.Load()
    if not trace:
        values, out["attempted"], out["failed"] = driver.window(run, seconds)
        values["setup_s"] = setup_s
        out["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in e2e}
    else:
        data, prof = driver.trace(run)
        out["attempted"], out["failed"] = data["attempted"], 0
        for m in layer:
            value = common.load_module("metrics", m["name"]).read(data)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    out["host"] = load.read()
    out["device"] = common.device_info(dev, chips)
    if trace:
        out["device"].update(busy_s=prof.busy_s(), window_s=prof.wall_s)
        out["breakdown"] = prof.breakdown()
    driver.release(run)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = driver.check(run)
    limits = run.work["limits"]
    out["checks"] = {k: {"value": readings.get(k), "limit": v} for k, v in limits.items()}
    out["correct"] = verdict(readings, limits)
    return out
