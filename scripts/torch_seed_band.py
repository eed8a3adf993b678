"""Seed spread of a pinned whole run in both packages.

The PyTorch port cannot replay JAX's threefry bits, so its whole-run
losses are held to the JAX package's spread over seeds instead of to one
golden (tests/test_torch_experiment.py, tests/test_torch_goldens.py).
This script measures that spread on the CPU: the JAX run of one config of
tests/test_pinned_goldens.py for seeds 0..N-1 and the port's run for the
same seeds, printing min/max of loss_train and loss_test per package.
``pursuit_batched_small``, ``unroll_sticky_small`` and
``world_comm_small`` are parity_small with the collection, unroll and
scenario options of tests/test_torch_goldens.py set in both packages.
``vae_mlp_small``, ``vae_conv_small`` and ``vae_factorized_small`` are
tests/test_vae_experiment.py's VAE family runs (``run_vae_experiment``,
its ``final_loss``).  Besides min/max it prints each package's mean and
standard error, and the gap of the means in standard errors of their
difference.

    JAX_PLATFORMS=cpu python scripts/torch_seed_band.py [N] [--config parity_small|det_small|popart_small|
        pursuit_batched_small|unroll_sticky_small|world_comm_small|vae_mlp_small|vae_conv_small|
        vae_factorized_small]
"""

import argparse
import dataclasses
import json
import math
import statistics
import sys
import tempfile

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

sys.path.insert(0, ".")
from tests.test_pinned_goldens import golden_configs, run_one  # noqa: E402
from tests.test_torch_experiment import parity_small  # noqa: E402
from tests.test_torch_goldens import CONFIGS, VAE_CONFIGS  # noqa: E402

import torch  # noqa: E402

from mfvae_tpu.training import vae_experiment as jvae  # noqa: E402
from mfvae_tpu_torch.training.experiment import Experiment  # noqa: E402
from mfvae_tpu_torch.training.vae_experiment import run_vae_experiment  # noqa: E402

PORT_CONFIGS = {"parity_small": parity_small, **CONFIGS, **VAE_CONFIGS}
# the options each derived config sets on parity_small, for the JAX side
DERIVED = {
    "pursuit_batched_small": {"train.collect_policy": "pursuit", "train.n_envs": 2},
    "unroll_sticky_small": {"train.unroll_steps": 4, "train.collect_policy": "sticky",
                            "train.collect_mix_frac": 0.9, "train.grad_clip": 10.0},
    "world_comm_small": {"env.name": "MPE_simple_world_comm_v3", "env.num_adversaries": 4,
                         "env.num_good_agents": 2, "env.num_obs": 1},
}


def jax_config(tmp: str, config: str, seed: int):
    cfg = golden_configs(tmp)["parity_small" if config in DERIVED else config]
    for key, v in DERIVED.get(config, {}).items():
        section, name = key.split(".")
        setattr(getattr(cfg, section), name, v)
    cfg.train.seed = seed
    return cfg


def run_pair(config: str, seed: int):
    """-> (the JAX run's metrics, the port's), each a dict."""
    if config in VAE_CONFIGS:
        with tempfile.TemporaryDirectory() as tmp:
            cfg = VAE_CONFIGS[config](tmp, seed)
            j = jvae.run_vae_experiment(jvae.VaeExperimentConfig(**dataclasses.asdict(cfg)))
            r = run_vae_experiment(cfg, "cpu")
        return {"final_loss": j["final_loss"]}, {"final_loss": r["final_loss"]}
    with tempfile.TemporaryDirectory() as tmp:
        j = run_one(jax_config(tmp, config, seed))
    with tempfile.TemporaryDirectory() as tmp:
        r = Experiment(PORT_CONFIGS[config](tmp, seed), device="cpu").setup().run()
    return j, {"loss_train": r["loss_train"], "loss_test": r["loss_test"]}


def main(n: int, config: str) -> None:
    out = {"jax": [], "torch": []}
    for seed in range(n):
        j, r = run_pair(config, seed)
        out["jax"].append(j)
        out["torch"].append(r)
        print(seed, out["jax"][-1], out["torch"][-1], flush=True)
    for key in out["torch"][0]:
        stats = {}
        for pkg, runs in out.items():
            vals = [r[key] for r in runs]
            stats[pkg] = (statistics.mean(vals), statistics.stdev(vals) / math.sqrt(len(vals)) if n > 1 else 0.0)
            print(json.dumps({"config": config, "package": pkg, "metric": key, "min": min(vals),
                              "max": max(vals), "mean": stats[pkg][0], "sem": stats[pkg][1]}))
        gap = stats["torch"][0] - stats["jax"][0]
        se = math.hypot(stats["torch"][1], stats["jax"][1])
        print(json.dumps({"config": config, "metric": key, "n": n, "torch_minus_jax": gap,
                          "in_standard_errors": gap / se if se else None}))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=8, help="number of seeds, from 0")
    ap.add_argument("--config", choices=sorted(PORT_CONFIGS), default="parity_small")
    args = ap.parse_args()
    torch.set_num_threads(1)  # as the tests run the port
    main(args.n, args.config)
