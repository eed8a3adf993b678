"""The benchmark of mfvae_tpu_torch on one card, one cell a run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as its last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; then ``checks``, each number compared with its limit, which
are also the last lines of standard error.  Without the card, or with JAX
or the JAX package loaded, it prints no result and exits non-zero.  The
process keeps to one CPU thread a pool on two fixed cores
(``benchmark/host.py``); ``host`` says what the rest of the machine did
during the window.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import host

    host.steady()
    from benchmark import common

    for key, value in common.cache_dirs().items():
        os.environ[key] = value
    from benchmark import harness

    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T0)
    found = common.forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for what, seconds in out.pop("setup_marks"):
        print(f"setup {what} {seconds!r} s", file=sys.stderr)
    print(f"host {json.dumps(out['host'])}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
