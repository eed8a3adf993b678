#!/usr/bin/env python3
"""Time K3 (``huber_mean_kernel`` in ``mfvae_tpu_torch/ops/csrc/fused_elbo.cu``)
against variants of its own source, in turns on one CUDA card.

    python scripts/torch_k3_variants.py [--out results/torch_k3_variants.json]

Each variant is built from a copy of the source with one edit:

- ``fence_sc``: the ticket is taken with ``__threadfence()`` and
  ``atomicAdd``, in place of the acq_rel ``fetch_add``;
- ``loads4``, ``loads8``: 4 or 8 16-byte loads per tensor per thread a pass
  in place of 2 (the wrapper's grid follows).

Cases: the state branch (n = 724,480) in f32 and bf16, the reward branch
(n = 5,120), the multi-block grid forced at n = 8,192 and 16,384 (the
ticket's cost), and one block forced at n = 8,192 and 12,288 (the
threshold's neighbours).  In each case the source and the variants run in
the order source, variants, variants reversed, source, each result checked
against the plain version first.  Times are the median of 30 loops of 20
back-to-back calls queued behind a device sleep, as in ``chip_smoke.py``.
"""

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from mfvae_tpu_torch.ops import fused_elbo as ops  # noqa: E402
from mfvae_tpu_torch.utils import kernel_build  # noqa: E402

FENCE_ACQ_REL = """    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> ticket(*arrivals);
    last = ticket.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;"""
FENCE_SC = """    __threadfence();
    last = atomicAdd(arrivals, 1u) == gridDim.x - 1;"""
LOADS = "constexpr int kHuberLoads = 2;"


def variants(src: str) -> dict:
    """name -> (source text, loads per thread)."""
    assert FENCE_ACQ_REL in src and LOADS in src, "the K3 source no longer has the edited lines"
    return {
        "source": (src, 2),
        "fence_sc": (src.replace(FENCE_ACQ_REL, FENCE_SC), 2),
        "loads4": (src.replace(LOADS, "constexpr int kHuberLoads = 4;"), 4),
        "loads8": (src.replace(LOADS, "constexpr int kHuberLoads = 8;"), 8),
    }


def median_ms(fn, inner=20, reps=30):
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(5_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=Path("results/torch_k3_variants.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    src = (kernel_build.CSRC_DIR / ops.SOURCE).read_text()
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        kernel_build.CSRC_DIR = Path(tmp)
        for name, (text, loads) in variants(src).items():
            (Path(tmp) / f"k3_{name}.cu").write_text(text)
            ops._LIB, ops.SOURCE = None, f"k3_{name}.cu"
            libs[name] = (ops._lib(), loads)

    g = torch.Generator(device="cuda").manual_seed(0)
    cases = [  # (label, n, dtype, single_block_max)
        ("state f32", 724480, torch.float32, ops.HUBER_SINGLE_BLOCK_MAX),
        ("state bf16", 724480, torch.bfloat16, ops.HUBER_SINGLE_BLOCK_MAX),
        ("reward f32", 5120, torch.float32, ops.HUBER_SINGLE_BLOCK_MAX),
        ("multi-block n=8192", 8192, torch.float32, 0),
        ("multi-block n=16384", 16384, torch.float32, 0),
        ("one block n=8192", 8192, torch.float32, 8192),
        ("one block n=12288", 12288, torch.float32, 12288),
    ]
    order = list(libs) + list(reversed(libs))
    wave = ops._HUBER_BLOCKS_PER_SM * torch.cuda.get_device_properties(0).multi_processor_count
    result = {"card": card, "cases": {}}
    for label, n, dtype, single in cases:
        x = (2 * torch.randn(n, generator=g, device="cuda")).to(dtype)
        y = torch.randn(n, generator=g, device="cuda").to(dtype)
        want = ops._huber_mean_plain(x, y, 1.0)
        times = {}
        for name in order:
            ops._LIB, ops._HUBER_LOADS = libs[name]
            got = ops._huber_mean_cuda(x, y, 1.0, single_block_max=single)
            if not torch.allclose(got, want, rtol=1e-5, atol=0.0):
                sys.exit(f"{name} disagrees with the plain version at {label}: {got.item()} vs {want.item()}")
            blocks = ops.huber_geometry(x.data_ptr(), y.data_ptr(), n, x.element_size(), wave, single).blocks
            times.setdefault(name, {"blocks": blocks, "us": []})["us"].append(
                1e3 * median_ms(lambda: ops._huber_mean_cuda(x, y, 1.0, single_block_max=single))
            )
        result["cases"][label] = times
        print(label, {k: (v["blocks"], [round(t, 3) for t in v["us"]]) for k, v in times.items()}, flush=True)
    print(card)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
