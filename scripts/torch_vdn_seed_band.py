"""VDN's training return in both packages over seeds, on the CPU.

The port cannot replay JAX's threefry bits, so whether its VDN learns as
the JAX package's does is a question of spread over seeds.  This script
trains ``vdn_tuned.yaml``'s recipe cut to a CPU size (simple_tag with 6
adversaries, 2 good agents and 2 obstacles, 8 envs, batch 32, hidden 32,
300 updates; epsilon annealed over 40%, target copies every 20, lr 3e-4)
for seeds 0..N-1 in both packages (JAX vmapped, the port one seed after
another) and prints, per package, the mean ``returned_episode_returns``
over the first and the last 50 updates of each seed, their mean and
standard error, the mean last/first ratio, the last 50 updates' mean loss,
and the gap of the last-50 means in standard errors of their difference.

    JAX_PLATFORMS=cpu python scripts/torch_vdn_seed_band.py [N] [--updates 300]
"""

import argparse
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import numpy as np  # noqa: E402
import torch  # noqa: E402

from mfvae_tpu.baselines import vdn as jvdn  # noqa: E402
from mfvae_tpu_torch.baselines import vdn  # noqa: E402

RECIPE = dict(num_good_agents=2, num_adversaries=6, num_obs=2, max_env_steps=25, num_envs=8, num_steps=25,
              buffer_size_time=512, min_buffer_time=64, batch_size=32, sample_sequence_length=16, hidden_dim=32,
              lr=3e-4, reward_scale=0.1, eps_decay=0.4, target_update_interval=20, test_during_training=False,
              log_during_training=False)


def summary(name: str, returns: np.ndarray, loss: np.ndarray) -> np.ndarray:
    first, last = returns[:, :50].mean(1).astype(float), returns[:, -50:].mean(1).astype(float)
    n = len(last)
    print(f"{name}: first 50 {np.round(first, 4).tolist()}, last 50 {np.round(last, 4).tolist()}; last-50 mean "
          f"{last.mean():.4f} +- {last.std(ddof=1) / n ** 0.5:.4f}, last/first {np.mean(last / first):.4f}, "
          f"loss over the last 50 {loss[:, -50:].mean():.4f}")
    return last


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=6)
    ap.add_argument("--updates", type=int, default=300)
    a = ap.parse_args()
    torch.set_num_threads(4)
    kw = dict(RECIPE, num_updates=a.updates)
    t0 = time.perf_counter()
    jm = jax.jit(jax.vmap(jvdn.make_train(jvdn.VdnConfig(**kw))))(jax.random.split(jax.random.PRNGKey(0), a.n))
    jm = jax.tree.map(np.asarray, jm["metrics"])
    print(f"JAX: {a.n} seeds in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pm = vdn.run_seeds(vdn.make_train(vdn.VdnConfig(**kw), device="cpu"), list(range(a.n)))["metrics"]
    print(f"port: {a.n} seeds in {time.perf_counter() - t0:.1f} s")
    j = summary("JAX", jm["returned_episode_returns"], jm["loss"])
    p = summary("port", pm["returned_episode_returns"], pm["loss"])
    se = np.sqrt(j.var(ddof=1) / len(j) + p.var(ddof=1) / len(p))
    print(f"gap of the last-50 means: {abs(j.mean() - p.mean()) / se:.2f} standard errors")


if __name__ == "__main__":
    main()
