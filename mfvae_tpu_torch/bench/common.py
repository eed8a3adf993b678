"""What every measurement entry point shares: the card, the timing
disciplines, the train step's FLOPs and the peaks they are read against.

- **The card.** ``setup(device)`` resolves the device (the card unless the
  caller asks for the CPU; with no card it raises, never falling back) and
  turns TF32 off, the port's setting.  ``device_info`` names the device in
  every JSON the bench prints: on the card its name, the count, and
  ``nvidia-smi --query-gpu=name,power.limit``; on the CPU the word "cpu".
- **Walls.** A wall time is the host clock around work that ends in a
  device sync.  ``best_window`` runs k windows of N calls, each window
  ending in one sync, and keeps the best, as bench.py's ``best_dt`` does;
  ``synced_wall`` syncs after every call.  The timed calls read nothing
  back to the host.
- **FLOPs.** XLA's ``cost_analysis`` has no counterpart, so
  ``step_flops`` counts the train step's matrix products from the model's
  shapes (``STEP_FLOPS_SOURCE``): every ``Dense`` and ``StackedDense`` (the
  encoders, the decoders and their heads), 2·rows·in·out each, forward,
  and twice that backward (the input's gradient and the kernel's: every
  product's input needs a gradient in the train step).  The action
  encoders are gathers, with no product.
- **Peaks.** One H100 SXM at its 700 W limit, dense: 989e12 FLOP/s in
  bf16 and fp16 on the tensor cores, 67e12 in float32 outside them (TF32
  is off).  ``mfu_pct`` divides by the peak of the row's compute dtype;
  it is None off the card, where no device rate exists.  Its numerator is
  ``step_flops``, matrix products only, where bench.py's ``mfu_pct`` counts
  every FLOP XLA's ``cost_analysis`` reports: the JSON says so beside the
  key (``MFU_PCT_NOTE``).
- **The JAX scripts' keys.** ``source_dict_keys`` reads the keys of a dict
  literal from a Python file as text, so a check can hold a JSON line
  against the JAX script it stands beside without importing it.
"""

from __future__ import annotations

import argparse
import ast
import functools
import json
import math
import subprocess
import time
from pathlib import Path
from typing import Callable, Optional

import torch

from mfvae_tpu_torch.models.layers import Dense, StackedDense
from mfvae_tpu_torch.models.mavae import MAVAE
from mfvae_tpu_torch.training.experiment import resolve_device

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
STEP_FLOPS_SOURCE = "matmul shapes"
MFU_PCT_NOTE = ("every mfu_pct here counts the train step's matrix-product FLOPs (step_flops_source), "
                "fewer than the FLOPs XLA's cost_analysis counts for bench.py's mfu_pct")


def setup(device) -> torch.device:
    """The device to measure on; raises without a card unless ``device``
    is the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


@functools.lru_cache(maxsize=None)
def _nvidia_smi() -> str:
    """The card's name and power limit; queried once a process."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def device_info(dev: torch.device) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "nvidia_smi": None}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": _nvidia_smi()}


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def best_window(fn: Callable[[int], object], n: int, reps: int, dev: torch.device) -> float:
    """The best wall seconds of ``reps`` windows of ``fn(0..n-1)``, each
    window ending in one device sync."""
    best = math.inf
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def synced_wall(fn: Callable[[int], object], n: int, dev: torch.device) -> float:
    """Wall seconds of ``fn(0..n-1)`` with a device sync after each call."""
    sync(dev)
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
        sync(dev)
    return time.perf_counter() - t0


def step_flops(model: MAVAE, batch_size: int, windows: int = 1) -> int:
    """The matrix-product FLOPs of one train step over ``batch_size`` rows
    (``windows`` forwards of them: the unroll step's W), forward and
    backward, from the model's shapes."""
    fwd = 0
    for name, m in model.named_modules():
        if isinstance(m, StackedDense):
            stack, d_in, d_out = m.kernel.shape
            fwd += 2 * batch_size * stack * d_in * d_out
        elif isinstance(m, Dense):
            d_in, d_out = m.kernel.shape
            rows = batch_size
            if name.startswith("action_delta_heads."):
                # applied to its group's per-agent action embeddings
                rows *= len(model.spec.groups[int(name.split(".")[1])][1])
            fwd += 2 * rows * d_in * d_out
    return 3 * fwd * windows


def mfu_pct(flops: float, steps_per_sec: float, compute_dtype: str, dev: torch.device) -> Optional[float]:
    """Achieved share of the card's peak for ``compute_dtype``, in percent;
    None off the card."""
    if dev.type != "cuda":
        return None
    return 100.0 * flops * steps_per_sec / PEAK_FLOPS[compute_dtype]


def reset_peak_memory(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_memory(dev: torch.device) -> Optional[int]:
    """Bytes: ``torch.cuda.max_memory_allocated`` since the last reset;
    None off the card."""
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None


def emit(obj: dict, out: Optional[str] = None) -> None:
    """Print ``obj`` as one JSON line; also write it to ``out`` if given."""
    line = json.dumps(obj)
    print(line, flush=True)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(line + "\n")


def source_dict_keys(path, func: str, target: str) -> set:
    """The constant keys of ``target = {...}`` in function ``func`` of the
    Python file at ``path``, read as text (nothing of it is imported)."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    for n in ast.walk(fn):
        if (isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == target for t in n.targets)):
            return {k.value for k in n.value.keys}
    raise ValueError(f"no {target} = {{...}} in {Path(path).name}:{func}")


def cli(prog: str, description: str, argv=None) -> argparse.Namespace:
    """The entry points' flags: --device and --out."""
    p = argparse.ArgumentParser(prog=prog, description=description)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu; without a card, cuda raises")
    p.add_argument("--out", default=None, help="also write the last JSON line to this file")
    return p.parse_args(argv)
