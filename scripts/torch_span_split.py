"""Where a benchmark cell's device idle falls in the program, and what the
program's spans cost under the profiler, on a CUDA card.

    python scripts/torch_span_split.py split --out split.json --workload <cell> --seed <n> --seconds <s>
    python scripts/torch_span_split.py oncost --workload <cell> [--rounds 6]

``split`` runs one traced benchmark run (``benchmark/run.py``'s own main,
``--trace 1``), prints its result line, and splits every idle gap of its
profiled stretch by the innermost program span (``mfvae.*``) over the
gap's midpoint.  Gaps in no program span are named, as
``Profiled.host_at`` names them, by the harness span and the innermost
host event over the midpoint.  The split goes to ``--out`` as JSON and,
shortened, to standard error.

``oncost`` builds the cell as the benchmark does and runs its profiled
stretch (the profiled train phases or requests of ``benchmark/drivers/``) under the
profiler, with the spans on and with every span site handed the no-op,
in turns (on, off, off, on, ...).  It prints the wall a train step or a
request of each round, in ms.
"""

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def split(prof) -> dict:
    """The idle seconds of ``prof`` (a ``benchmark.common.Profiled``) by the
    innermost program span over each gap's midpoint."""
    spans = [(s, e, n) for s, e, n in prof.host if n.startswith("mfvae.")]
    gaps = prof.gaps()
    by_span, outside, total = {}, {}, 0.0
    for lo, hi in gaps:
        t, d = 0.5 * (lo + hi), (hi - lo) * 1e-6
        total += d
        cover = [(e - s, n) for s, e, n in spans if s <= t <= e]
        key = min(cover)[1] if cover else "(no program span)"
        by_span[key] = by_span.get(key, 0.0) + d
        if not cover:
            ops = [(e - s, n) for s, e, n in prof.host if s <= t <= e]
            bench = [(e - s, n) for s, e, n in prof.spans if s <= t <= e]
            op = f"{min(bench)[1] if bench else 'bench'}:{min(ops)[1] if ops else 'python'}"
            outside[op] = outside.get(op, 0.0) + d

    def rank(d):
        return sorted(([k, v, v / total if total else 0.0] for k, v in d.items()), key=lambda kv: -kv[1])

    counts = {}
    for _, _, n in spans:
        counts[n] = counts.get(n, 0) + 1
    return {"idle_s": total, "gaps": len(gaps), "busy_s": prof.busy_s(), "wall_s": prof.wall_s,
            "by_span": rank(by_span), "outside": rank(outside)[:15], "span_counts": counts}


def run_split(out: Path, argv) -> int:
    from benchmark import common, run

    caught = []
    breakdown = common.Profiled.breakdown

    def keep(self, top=10):
        caught.append(self)
        return breakdown(self, top)

    common.Profiled.breakdown = keep
    rc = run.main(list(argv) + ["--trace", "1"])
    if caught:
        res = split(caught[0])
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(res))
        print(f"SPLIT {json.dumps({k: res[k] for k in ('idle_s', 'gaps', 'busy_s', 'wall_s')})}", file=sys.stderr)
        print(f"SPLIT by_span {json.dumps(res['by_span'][:12])}", file=sys.stderr)
        print(f"SPLIT outside {json.dumps(res['outside'][:8])}", file=sys.stderr)
    return rc


def run_oncost(cell: str, seed: int, rounds: int) -> None:
    from benchmark import common, harness, host

    host.steady()
    for key, value in common.cache_dirs().items():
        os.environ[key] = value
    from mfvae_tpu_torch import inference
    from mfvae_tpu_torch.training import trainer, unroll
    from mfvae_tpu_torch.utils import profiling

    dev = common.cuda_device(1)
    run = harness.Run(cell, seed, dev)
    driver = common.load_module("drivers", run.work["driver"])
    driver.setup(run)
    on = profiling.span

    def off(name):
        return profiling._OFF

    def set_spans(fn):
        for mod in (trainer, unroll, inference, profiling):
            mod.span = fn

    if hasattr(driver, "PROFILED_PHASES"):
        units, unit = driver.PROFILED_PHASES * run.cfg.train.train_num, "step"

        def stretch():
            for _ in range(driver.PROFILED_PHASES):
                with common.span("train_phase"):
                    driver._phase(run)
    else:
        units, unit = driver.PROFILED_REQUESTS, "request"

        def stretch():
            for _ in range(driver.PROFILED_REQUESTS):
                with common.span("request"):
                    driver.serve(run)

    common.Profiled(dev).run(stretch)  # the profiler's first-use cost lands here
    walls = {"on": [], "off": []}
    try:
        for i in range(rounds):
            for mode in (("on", "off") if i % 2 == 0 else ("off", "on")):
                set_spans(on if mode == "on" else off)
                walls[mode].append(1e3 * common.Profiled(dev).run(stretch).wall_s / units)
    finally:
        set_spans(on)
    print("ONCOST", cell, f"ms a {unit}", json.dumps(walls), flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="what", required=True)
    s = sub.add_parser("split")
    s.add_argument("--out", type=Path, required=True)
    o = sub.add_parser("oncost")
    o.add_argument("--workload", required=True)
    o.add_argument("--seed", type=int, default=2300777001)
    o.add_argument("--rounds", type=int, default=6)
    args, rest = p.parse_known_args()
    if args.what == "split":
        return run_split(args.out, rest)
    run_oncost(args.workload, args.seed, args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
