"""Host env stepping rates: the native C++ engine against the port's
``LocalHostEnv``: the counterpart of ``scripts/native_env_bench.py``.

    python -m mfvae_tpu_torch.bench.native_env_bench [--device cpu] [--out FILE]

The host collection loop is the reference's hot loop (128 steps an epoch
at the 40-agent population).  The figures, each a JSON row with the JAX
script's label, its key and its unit:

- ``native_1``: one native simple_tag env (30/10/20) through
  ``NativeHostEnv``'s PettingZoo surface, 2,000 steps (steps/s);
- ``native_b``: 64 native simple_tag envs in one ``NativeSimpleTagEnv``,
  200 steps (env-steps/s); ``spread_b`` and ``wc_b`` the same for
  simple_spread (3 agents) and simple_world_comm (its defaults);
- ``local_1``: the port's ``LocalHostEnv`` (``envs/mpe.py`` in eager torch
  on the CPU, 100 steps), in the place of the JAX script's ``jax_1``, its
  jitted JAX env;
- ``speedup_single`` and ``speedup_batched``: ``native_1`` and
  ``native_b`` over ``local_1``, the script's last line.

Every figure is host work: the engine and the torch env run on the CPU
whatever the device.  ``--device`` names the machine in the JSON (the card
unless the caller asks for the CPU, and without a card it raises, as every
entry point of the bench does).  The last line is
``{"native_env_bench": {key: value}, "device": ...}``.
"""

from __future__ import annotations

import json
import time

import numpy as np

from mfvae_tpu_torch.bench.common import cli, device_info, emit, setup

POP = dict(num_good=10, num_adversaries=30, num_obstacles=20)
FULL = dict(n_single=2000, n_batched=200, n_envs=64, n_local=100)
# the JAX script's variable -> the key here
JAX_NAMES = {"native_1": "native_1", "native_b": "native_b", "spread_b": "spread_b", "wc_b": "wc_b",
             "jax_1": "local_1"}


def bench_native_single(n_steps: int) -> float:
    from mfvae_tpu_torch.envs.native_engine import NativeHostEnv

    env = NativeHostEnv(**POP, max_cycles=10_000)
    env.reset(seed=0)
    rng = np.random.default_rng(0)
    acts_list = [{a: int(rng.integers(0, 5)) for a in env.agents} for _ in range(64)]
    t0 = time.perf_counter()
    for i in range(n_steps):
        env.step(acts_list[i % 64])
    return n_steps / (time.perf_counter() - t0)


def bench_scenario(make, n_envs: int, n_steps: int) -> float:
    """env-steps/s of a batched native env from ``make(n_envs)``."""
    env = make(n_envs)
    env.reset()
    rng = np.random.default_rng(0)
    acts = rng.integers(0, env.action_highs[None, :], size=(n_steps, n_envs, env.num_agents)).astype(np.int32)
    env.step(acts[0])  # warm
    t0 = time.perf_counter()
    for i in range(n_steps):
        env.step(acts[i])
    return n_envs * n_steps / (time.perf_counter() - t0)


def bench_local(n_steps: int) -> float:
    from mfvae_tpu_torch.envs.host_adapter import LocalHostEnv

    env = LocalHostEnv("simple_tag_v3", POP["num_good"], POP["num_adversaries"], POP["num_obstacles"], 10_000)
    env.reset(seed=0)
    rng = np.random.default_rng(0)
    acts = {a: int(rng.integers(0, 5)) for a in env.agents}
    env.step(acts)  # warm
    t0 = time.perf_counter()
    for _ in range(n_steps):
        env.step(acts)
    return n_steps / (time.perf_counter() - t0)


def run(device="cuda", **counts) -> dict:
    """The script's figures; ``counts`` override ``FULL``'s (a cut run)."""
    from mfvae_tpu_torch.envs.native_engine import NativeSimpleSpreadEnv, NativeSimpleTagEnv, NativeSimpleWorldCommEnv

    unknown = set(counts) - set(FULL)
    if unknown:
        raise ValueError(f"unknown counts {sorted(unknown)}; expected some of {sorted(FULL)}")
    c = {**FULL, **counts}
    info = device_info(setup(device))
    n_envs, n = c["n_envs"], c["n_batched"]
    figures = {
        "native_1": bench_native_single(c["n_single"]),
        "native_b": bench_scenario(
            lambda k: NativeSimpleTagEnv(n_envs=k, num_good_agents=POP["num_good"],
                                         num_adversaries=POP["num_adversaries"], num_obs=POP["num_obstacles"],
                                         max_steps=10_000, n_threads=0), n_envs, n),
        "spread_b": bench_scenario(lambda k: NativeSimpleSpreadEnv(n_envs=k, num_agents=3, max_steps=10_000),
                                   n_envs, n),
        "wc_b": bench_scenario(lambda k: NativeSimpleWorldCommEnv(n_envs=k, max_steps=10_000), n_envs, n),
        "local_1": bench_local(c["n_local"]),
    }
    figures["speedup_single"] = figures["native_1"] / figures["local_1"]
    figures["speedup_batched"] = figures["native_b"] / figures["local_1"]
    labels = {
        "native_1": ("native single-env (tag 40 agents)", "steps/s"),
        "native_b": (f"native batched x{n_envs} (tag)", "env-steps/s"),
        "spread_b": (f"native batched x{n_envs} (spread, 3 ag)", "env-steps/s"),
        "wc_b": (f"native batched x{n_envs} (world_comm)", "env-steps/s"),
        "local_1": ("torch LocalHostEnv", "steps/s"),
        "speedup_single": ("native/torch speedup, single", "x"),
        "speedup_batched": ("native/torch speedup, batched", "x"),
    }
    for key, (label, unit) in labels.items():
        print(json.dumps({"figure": label, "key": key, "value": figures[key], "unit": unit}), flush=True)
    return {"native_env_bench": figures, "device": info, "counts": c}


def main(argv=None) -> None:
    a = cli("python -m mfvae_tpu_torch.bench.native_env_bench", __doc__.split("\n\n")[0], argv)
    emit(run(a.device), a.out)


if __name__ == "__main__":
    main()
