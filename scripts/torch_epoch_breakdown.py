"""Where an epoch of the PyTorch port's main path spends its time, on a
CUDA card.

Runs the default config (simple_tag 30/10/20, batch 128, bf16, full
widths), or the YAML config named by ``--config`` with ``a.b=c``
overrides, with model.use_pallas true and false (plain only where the
kernels are refused: unroll_steps > 1).  With train.n_envs > 1 the epoch
is the batched one.  Per route: one warm-up
epoch, then ``--epochs`` epochs whose four phases (collect, train,
test-collect, eval) are each timed on the host clock between device syncs,
then one collect phase under ``torch.cuda.set_sync_debug_mode("warn")``,
which counts the host syncs it makes, then one epoch under torch.profiler
for the device's busy time and its kernels by device time.  Prints one
JSON line per route.

    python scripts/torch_epoch_breakdown.py [--epochs 3] [--config examples/pursuit_collection.yaml]
        [train.n_envs=4 ...] [--out results/breakdown.jsonl]

Kernel names are cut to 160 characters.  ``--out`` appends the same JSON
lines to a file.
"""

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from mfvae_tpu_torch.config import ExperimentConfig, apply_overrides, load_config  # noqa: E402
from mfvae_tpu_torch.training.experiment import Experiment  # noqa: E402
from mfvae_tpu_torch.training.trainer import EpochCarry, make_phase_fns  # noqa: E402
from mfvae_tpu_torch.utils import profiling  # noqa: E402


def timed(fn, *args):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t)


def make_config(config: str, overrides) -> ExperimentConfig:
    cfg = load_config(config) if config else ExperimentConfig()
    apply_overrides(cfg, list(overrides))
    return cfg


def count_syncs(fn, *args):
    """fn(*args), the number of synchronizing CUDA calls it made and the
    source lines that made them, with their counts."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{Path(w.filename).name}:{w.lineno}"
            where[key] = where.get(key, 0) + 1
    return out, sum(where.values()), where


def breakdown(use_pallas: bool, epochs: int, tmp: str, config: str = "", overrides=()) -> dict:
    cfg = make_config(config, overrides)
    cfg.model.use_pallas = use_pallas
    cfg.train.log_dir = f"{tmp}/results"
    cfg.train.checkpoint_dir = ""
    exp = Experiment(cfg).setup()
    collect, train_phase, test_phase = make_phase_fns(
        exp.env, exp.spec, exp.buffer, exp.test_buffer, cfg, exp.streams
    )

    phases = {"collect": [], "train": [], "test_collect": [], "eval": [], "epoch": []}
    carry = exp.carry
    for i in range(epochs + 1):
        t0 = time.perf_counter()
        (env_c, buf), t_c = timed(collect, carry.env, carry.buffer_state, exp.buffer)
        (ts, _), t_t = timed(train_phase, carry.train_state, buf)
        (env_c, tbuf), t_tc = timed(collect, env_c, carry.test_buffer_state, exp.test_buffer)
        _, t_e = timed(test_phase, ts, tbuf)
        carry = EpochCarry(ts, buf, tbuf, env_c)
        if i == 0:
            continue  # warm-up
        for k, v in zip(phases, (t_c, t_t, t_tc, t_e, 1e3 * (time.perf_counter() - t0))):
            phases[k].append(v)
    (env_c, buf), collect_syncs, sync_sites = count_syncs(collect, carry.env, carry.buffer_state, exp.buffer)
    carry = carry._replace(env=env_c, buffer_state=buf)

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        env_c, buf = collect(carry.env, carry.buffer_state, exp.buffer)
        ts, _ = train_phase(carry.train_state, buf)
        env_c, tbuf = collect(env_c, carry.test_buffer_state, exp.test_buffer)
        test_phase(ts, tbuf)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [
        (e.key[:160], e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        # device-side ranges of user annotations (Optimizer.step#...) overlap
        # the kernels they enclose; count kernels only
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False)
    ]
    busy_ms = sum(k[1] for k in kernels)
    kernels.sort(key=lambda k: -k[1])
    return {
        "config": config or "default",
        "overrides": list(overrides),
        "use_pallas": use_pallas,
        "host_syncs_in_one_collect": collect_syncs,
        "host_sync_sites": sync_sites,
        "env_steps_per_collect": cfg.train.sample_num,
        "phase_ms_median": {k: statistics.median(v) for k, v in phases.items()},
        "phase_ms_all": phases,
        "profiled_epoch_wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "top_kernels_ms_count": kernels[:12],
        "launches_in_profiled_epoch": profiling.counters(),
    }


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--config", default="", help="a YAML config; the default ExperimentConfig when empty")
    p.add_argument("--out", default="", help="append the JSON lines to this file too")
    p.add_argument("overrides", nargs="*", help="a.b=c config overrides")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)
    cfg = make_config(args.config, args.overrides)
    routes = (False,) if cfg.train.unroll_steps > 1 else (True, False)
    with tempfile.TemporaryDirectory() as tmp:
        for use_pallas in routes:
            line = json.dumps({"card": card, **breakdown(use_pallas, args.epochs, tmp, args.config, args.overrides)})
            print(line, flush=True)
            if args.out:
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(line + "\n")


if __name__ == "__main__":
    main()
