"""The canonical experiment at full depth on the card, by both routes.

    python scripts/torch_canonical_run.py [--epochs 256] [--out results/canonical.json]

Runs ``python -m mfvae_tpu_torch examples/reference_parity.yaml
model.use_pallas=<true|false> train.epoch_num=<epochs>`` once per route,
the kernels first, each in its own process with its own log and
checkpoint directory, and reads each run's ``metrics.jsonl``.  Prints and
writes, per route: the final and the minimum Loss/Test (with its epoch),
the final Loss/Train, the process wall and the median epoch wall; and the
card's name and power limit.  The entry point runs on the CUDA card and
raises without one.
"""

import argparse
import ast
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def losses(metrics: Path, tag: str):
    """{epoch: value} of one tag of a metrics.jsonl."""
    out = {}
    for line in metrics.read_text().splitlines():
        row = json.loads(line)
        if row["tag"] == tag:
            out[row["step"]] = row["value"]
    return out


def run_route(use_pallas: bool, epochs: int, tmp: str) -> dict:
    route = "kernels" if use_pallas else "plain"
    args = [sys.executable, "-m", "mfvae_tpu_torch", str(REPO / "examples" / "reference_parity.yaml"),
            f"model.use_pallas={str(use_pallas).lower()}", f"train.epoch_num={epochs}",
            f"train.log_dir={tmp}/{route}", f"train.checkpoint_dir={tmp}/{route}_ckpt"]
    env = dict(os.environ, PYTHONPATH=f"{REPO}{os.pathsep}" + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run(args, capture_output=True, text=True, env=env, cwd=str(REPO), check=True)
    wall = time.perf_counter() - t0
    result = ast.literal_eval(proc.stdout.strip().splitlines()[-1])
    metrics = next(Path(tmp, route).glob("*/metrics.jsonl"))
    test, train = losses(metrics, "Loss/Test"), losses(metrics, "Loss/Train")
    best = min(test, key=test.get)
    return {
        "route": route,
        "epochs": len(test),
        "final_loss_test": test[max(test)],
        "min_loss_test": test[best],
        "min_loss_test_epoch": best,
        "final_loss_train": train[max(train)],
        "process_wall_s": wall,
        "run_wall_s": result["wall_s"],
        "median_epoch_wall_ms": 1e3 * statistics.median(result["epoch_wall_s"]),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=256)
    ap.add_argument("--out", default="")
    a = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for use_pallas in (True, False):
            rows.append(run_route(use_pallas, a.epochs, tmp))
            print(json.dumps(rows[-1]), flush=True)
    out = {"card": smi, "config": "examples/reference_parity.yaml", "routes": rows}
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
