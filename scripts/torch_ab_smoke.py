#!/usr/bin/env python3
"""Run ``chip_smoke.py`` from two checkouts in turns on one CUDA card
(A, B, B, A) and gather the kernel times of each run.

    python scripts/torch_ab_smoke.py PARENT_DIR CHANGE_DIR [--out results/torch_ab_smoke]

Each checkout builds its own kernels.  A run's whole output goes to
``OUT/<i>_<label>.log``.  From each run the script reads the kernel line
(``{"kernels": [...]}``: K1, K2 and K3 at the state branch), K3 at the
reward branch (the ``[7]`` line), the launch floor and K3's single- and
multi-block times where the checkout prints them, and the epoch wall of
the main path.  It prints them and writes them to ``OUT/summary.json``.
It exits non-zero if any run fails.
"""

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path


def read_run(text: str) -> dict:
    kernels = next(json.loads(l) for l in text.splitlines() if l.startswith('{"kernels"'))
    reward = re.search(r"^\[7\] K3 at the reward branch \(n=\d+\): kernel (\S+) ms", text, re.M)
    k3 = next((json.loads(l) for l in text.splitlines() if l.startswith('{"launch_floor_ms"')), {})
    wall = re.search(r"^\[4\] use_pallas=true, 2 epochs: .*epoch wall ms (\[[^\]]*\])", text, re.M)
    card = next(l for l in text.splitlines() if l.startswith("[1] card: "))
    return {
        "card": card.removeprefix("[1] card: "),
        "us": {k["name"]: 1e3 * k["ms"] for k in kernels["kernels"]} | {"K3 huber_mean, reward": 1e3 * float(reward[1])},
        "launch_floor_us": 1e3 * k3["launch_floor_ms"] if k3 else None,
        "k3_paths": k3.get("k3_paths"),
        "k3_crossover": k3.get("k3_crossover"),
        "epoch_wall_ms": json.loads(wall[1]),
        "launches": {k["name"]: k["launches"] for k in kernels["kernels"]},
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--out", type=Path, default=Path("results/torch_ab_smoke"))
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, (label, root) in enumerate([("parent", args.parent), ("change", args.change),
                                       ("change", args.change), ("parent", args.parent)]):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root, capture_output=True,
                              text=True, timeout=1200)
        text = proc.stdout + proc.stderr
        (args.out / f"{i}_{label}.log").write_text(text)
        if proc.returncode != 0:
            print(text[-4000:])
            sys.exit(f"run {i} ({label}, {root}) exited {proc.returncode}")
        run = {"run": i, "label": label} | read_run(proc.stdout)
        runs.append(run)
        print(json.dumps(run), flush=True)
    (args.out / "summary.json").write_text(json.dumps(runs, indent=1))


if __name__ == "__main__":
    main()
