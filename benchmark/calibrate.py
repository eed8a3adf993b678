"""The readings that the limits of ``correct`` are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds ...] [--fault-seeds ...] [--k3-fault-seeds ...] [--out file.jsonl]

For each of ``--seeds``: the program's set-up (which runs the steps the
reference follows; a rollout cell serves its first requests), then the
numbers its check compares.  For each of ``--control-seeds``: the
reference put in the program's place in fp8 (the precision below the
configuration's bfloat16), against the reference.  For each of
``--fault-seeds`` (training cells): the reference with half of each
batch left out of the loss, against the reference.  For each of
``--k3-fault-seeds`` (cells on the kernel route): the program with kernel
K3 planted to return the mean over the first half of its rows (its
backward left whole), so that only the loss's value is wrong.  One JSON
line per reading; no measured window.  The benchmark's own runs never
run this.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def k3_half_rows(on: bool):
    """Kernel K3 (and its plain stand-in off the card) handed only the
    first half of the rows, while ``on``."""
    from mfvae_tpu_torch.ops import fused_elbo

    real = fused_elbo._huber_mean_cuda, fused_elbo._huber_mean_plain

    def half(fn):
        return lambda x, y, delta, *a, **k: fn(x[: x.shape[0] // 2].contiguous(), y[: y.shape[0] // 2].contiguous(),
                                               delta, *a, **k)

    if on:
        fused_elbo._huber_mean_cuda, fused_elbo._huber_mean_plain = (half(f) for f in real)
    try:
        yield
    finally:
        fused_elbo._huber_mean_cuda, fused_elbo._huber_mean_plain = real


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--k3-fault-seeds", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import gc

    import torch

    from benchmark import common, harness
    from benchmark.reference import model as M

    dev = common.cuda_device(1)
    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    out = open(args.out, "a") if args.out else None

    def emit(kind, seed, readings, t0):
        line = json.dumps({"cell": args.workload, "kind": kind, "seed": seed, "readings": readings,
                           "seconds": time.perf_counter() - t0, "card": torch.cuda.get_device_name(dev)})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for kind, seed_list in (("program", seeds(args.seeds)), ("control_fp8", seeds(args.control_seeds)),
                            ("fault_half_batch", seeds(args.fault_seeds)),
                            ("fault_k3_half_rows", seeds(args.k3_fault_seeds))):
        for seed in seed_list:
            t0 = time.perf_counter()
            run = harness.Run(args.workload, seed, dev)
            driver = common.load_module("drivers", run.work["driver"])
            if kind in ("program", "fault_k3_half_rows"):
                with k3_half_rows(kind == "fault_k3_half_rows"):
                    driver.setup(run)
                getattr(driver, "serve_first", lambda run: None)(run)
                driver.release(run)
                readings = driver.check(run)
            else:
                readings = driver.stand_in(run, M.Precision(fp8=kind == "control_fp8"),
                                           half_batch=kind == "fault_half_batch")
            emit(kind, seed, readings, t0)
            del run
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
