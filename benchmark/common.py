"""What the harness shares: finding a cell's files by name, the card, the
inputs made from the seed, and reading a profiler trace.

- **Files by name.** A cell ``<c>`` is ``workloads/<c>.json`` (its
  configuration, driver, traffic parameters and limits), a configuration
  ``configs/<name>.json``, a driver ``drivers/<name>.py``, a per-layer
  metric ``metrics/<name>.py``.
- **The card.** ``cuda_device`` raises without the cards a cell asks for
  (never falling back to the CPU) and turns TF32 off, as
  ``mfvae_tpu_torch/bench/common.py`` ``setup`` does; ``device_info``
  names the card.
- **Inputs.** Weights, replay rows, rollout starts and plans come from
  generators seeded from ``--seed`` alone, on the device, in a few large
  calls, and are handed alike to the program and to the reference.
- **Traces.** ``Profiled`` runs a stretch under ``torch.profiler`` and
  keeps its device operations and host spans; ``breakdown`` and the busy
  time are worked out from them (the pattern of
  ``scripts/torch_epoch_breakdown.py``).
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import model as M
from benchmark.reference.env import N_ACTIONS, SimpleTag

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "mfvae_tpu")
WEIGHT_STREAM, DATA_STREAM, ROLLOUT_STREAM = 101, 102, 103


# ------------------------------------------------------------------ files
def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def workload(name: str) -> dict:
    return load_json(HERE / "workloads" / f"{name}.json")


def config_dict(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cache_dirs() -> Dict[str, str]:
    """Fixed cache directories inside the checkout, for compilers the
    program may call (its own nvcc builds go to ``mfvae_tpu_torch/build/``,
    also inside the checkout)."""
    base = ROOT / ".bench_cache"
    return {"TRITON_CACHE_DIR": str(base / "triton"), "TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "TORCHINDUCTOR_CACHE_DIR": str(base / "inductor"), "CUDA_CACHE_PATH": str(base / "cuda")}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


# ------------------------------------------------------------------- card
def cuda_device(chips: int) -> torch.device:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} cards, {torch.cuda.device_count()} are visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_info(dev: torch.device, chips: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


# ----------------------------------------------------------------- inputs
def generator(seed: int, stream: int, dev) -> torch.Generator:
    w = np.random.SeedSequence((int(seed), stream)).generate_state(2, np.uint32)
    g = torch.Generator(device=dev)
    g.manual_seed((int(w[0]) << 31) ^ int(w[1]))
    return g


def make_weights(shapes: Dict[str, tuple], seed: int, dev, small=()) -> Dict[str, torch.Tensor]:
    """Every leaf from one normal draw: kernels scaled by 1/sqrt(fan in),
    embeddings N(0, 1), LayerNorm scales 1 + 0.1·N, biases 0.05·N; the
    leaves whose names start with one of ``small`` a tenth of that."""
    sizes = [int(np.prod(s)) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=generator(seed, WEIGHT_STREAM, dev), device=dev)
    out, lo = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        x = flat[lo:lo + n].view(shape)
        lo += n
        if name.endswith(".kernel"):
            x = x / float(np.sqrt(shape[-2]))
        elif name.endswith(".scale"):
            x = 1.0 + 0.1 * x
        elif name.endswith(".bias"):
            x = 0.05 * x
        if name.startswith(tuple(small)):
            x = 0.1 * x
        out[name] = x.clone()
    return out


def make_rows(obs_dims, n_actions: int, rows: int, seed: int, dev) -> dict:
    """Replay rows in the ring's layout, per group of equal obs width:
    obs uniform in [-1, 1], next obs the obs plus N(0, 0.1²), actions
    uniform, rewards 10 with probability 0.05 else 0, done 0."""
    g = generator(seed, DATA_STREAM, dev)
    groups = []
    for od in obs_dims:
        if groups and groups[-1][0] == od:
            groups[-1][1] += 1
        else:
            groups.append([od, 1])
    obs = [torch.rand(rows, a, od, generator=g, device=dev) * 2.0 - 1.0 for od, a in groups]
    nxt = [o + 0.1 * torch.randn(o.shape, generator=g, device=dev) for o in obs]
    n = len(obs_dims)
    actions = torch.randint(0, n_actions, (rows, n), generator=g, device=dev, dtype=torch.int32)
    bounds = np.cumsum([0] + [a for _, a in groups])
    rewards = 10.0 * (torch.rand(rows, n, generator=g, device=dev) < 0.05).to(torch.float32)
    return {"obs": obs, "actions": [actions[:, bounds[i]:bounds[i + 1]].contiguous() for i in range(len(groups))],
            "next_obs": nxt, "rewards": rewards, "done": torch.zeros(rows, device=dev)}


def ref_env(conf: dict, dev) -> SimpleTag:
    e = conf["env"]
    if e["name"] != "MPE_simple_tag_v3" or not e["discrete_actions"]:
        raise NotImplementedError("the reference runs simple_tag with discrete actions")
    return SimpleTag(e["num_adversaries"], e["num_good_agents"], e["num_obs"], e["max_steps"], dev)


def ref_spec(conf: dict) -> M.Spec:
    env = ref_env(conf, "cpu")
    return M.Spec(env.obs_dims, (N_ACTIONS,) * env.n)


def weights(run) -> dict:
    """The run's weights, in the program's layout.  Under
    ``residual_state`` the state output layer starts at a tenth of its
    scale, so a step's predicted change is about 0.1 a coordinate, the
    size of one simple_tag step (speeds up to 1.3, dt 0.1), as a trained
    model's is; at full scale a random model's closed loop drifts by
    about 1 a coordinate a step."""
    m = run.conf["model"]
    M.check_supported(m)
    small = ("state_decoder.out.", "state_head.") if m["residual_state"] else ()
    return make_weights(M.param_shapes(m, ref_spec(run.conf)), run.seed, run.dev, small)


# ----------------------------------------------------------------- traces
class Profiled:
    """A stretch of calls under ``torch.profiler`` (CPU and CUDA), ending
    in a device sync: its wall seconds, its device operations (name,
    start µs, end µs, is a kernel) and its host events."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.wall_s = 0.0
        self.device_ops: List[tuple] = []
        self.host: List[tuple] = []  # (start µs, end µs, name)
        self.spans: List[tuple] = []  # the harness's own spans, bench.*
        self._starts: Optional[List[float]] = None

    def run(self, fn: Callable[[], None]):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.dev.type == "cuda" else [])
        sync(self.dev)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            sync(self.dev)
            self.wall_s = time.perf_counter() - t0
        for e in prof.events():
            start, end = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                if getattr(e, "is_user_annotation", False):
                    continue
                kind = str(getattr(e, "activity_type", "") or "")
                is_kernel = "memcpy" not in kind.lower() and "memset" not in kind.lower() \
                    and not e.name.startswith(("Memcpy", "Memset"))
                self.device_ops.append((e.name, start, end, is_kernel))
            elif e.name.startswith("bench."):
                self.spans.append((start, end, e.name))
            elif not getattr(e, "is_async", False):
                self.host.append((start, end, e.name))
        self.device_ops.sort(key=lambda t: t[1])
        self.host.sort()
        return self

    def kernels(self, names=None) -> List[tuple]:
        return [op for op in self.device_ops if op[3] and (names is None or any(n in op[0] for n in names))]

    def busy_s(self) -> float:
        """The union of the device operations' intervals, in seconds."""
        total, cur_lo, cur_hi = 0.0, None, None
        for _, lo, hi, _ in self.device_ops:
            if cur_hi is None or lo > cur_hi:
                if cur_hi is not None:
                    total += cur_hi - cur_lo
                cur_lo, cur_hi = lo, hi
            else:
                cur_hi = max(cur_hi, hi)
        if cur_hi is not None:
            total += cur_hi - cur_lo
        return total * 1e-6

    def gaps(self) -> List[tuple]:
        """(start µs, end µs) of every stretch with no device operation,
        between the first and the last."""
        out, cur_hi = [], None
        for _, lo, hi, _ in self.device_ops:
            if cur_hi is not None and lo > cur_hi:
                out.append((cur_hi, lo))
            cur_hi = hi if cur_hi is None else max(cur_hi, hi)
        return out

    def host_at(self, t: float) -> str:
        """What the host was doing at ``t``: the harness's span around it
        (``bench.*``) and the innermost host event covering it."""
        if self._starts is None:
            self._starts = [h[0] for h in self.host]
        i = bisect.bisect_right(self._starts, t)
        inner, inner_len = "python", float("inf")
        for s, e, name in self.host[max(0, i - 300):i]:
            if e >= t and e - s < inner_len:
                inner, inner_len = name, e - s
        spans = [(e - s, n) for s, e, n in self.spans if s <= t <= e]
        return f"{min(spans)[1] if spans else 'bench'}:{inner}"

    def breakdown(self, top: int = 10) -> dict:
        ops: Dict[str, float] = {}
        for name, lo, hi, _ in self.device_ops:
            ops[name[:120]] = ops.get(name[:120], 0.0) + (hi - lo) * 1e-6
        idle: Dict[str, float] = {}
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:2000]
        for lo, hi in gaps:
            key = self.host_at(0.5 * (lo + hi))
            idle[key] = idle.get(key, 0.0) + (hi - lo) * 1e-6
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
        return {"device_ops": rank(ops), "idle_gaps": rank(idle)}


def span(name: str):
    """A host span the breakdown names idle gaps by."""
    return torch.profiler.record_function(f"bench.{name}")
