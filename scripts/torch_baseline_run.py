"""The tuned VDN baseline at full depth on the card.

    python scripts/torch_baseline_run.py [--config mfvae_tpu_torch/baselines/config/vdn_tuned.yaml]
        [--updates N] [--seed S] [--out results/baseline.json]

Trains ``vdn_tuned.yaml`` (simple_tag 30/10/20, 16 envs, 1,500 updates)
through ``mfvae_tpu_torch.baselines.vdn.make_train`` on the CUDA card, with
the metrics read back every ``log_chunk`` updates as ``vdn.main`` does.
Prints and writes: the wall (host clock around the whole run, ending in a
device sync), the ms per update (wall over updates), the mean
``returned_episode_returns`` at the first update that learns and over the
first and the last 50 updates, the last ``test_return``, and the card's
name and power limit.  The entry point runs on the card and raises without
one.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=str(REPO / "mfvae_tpu_torch/baselines/config/vdn_tuned.yaml"))
    ap.add_argument("--updates", type=int, default=0, help="0: the config's num_updates")
    ap.add_argument("--seed", type=int, default=None, help="default: the config's seed")
    ap.add_argument("--out", default="")
    a = ap.parse_args()

    import numpy as np
    import torch

    from mfvae_tpu_torch.baselines import vdn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    cfg = vdn.VdnConfig.from_yaml(a.config)
    cfg.log_during_training = False
    if a.updates:
        cfg.num_updates = a.updates
    if a.seed is not None:
        cfg.seed = a.seed
    first_learn = []

    def on_update(metrics, update_i):
        if not first_learn and metrics["loss"] != 0.0:
            first_learn.append((update_i, float(metrics["returned_episode_returns"])))
        if update_i % 100 == 0:
            print(f"update {update_i}: {json.dumps({k: float(v) for k, v in metrics.items()})}", flush=True)

    train = vdn.make_train(cfg, metrics_callback=on_update, device="cuda")
    t0 = time.perf_counter()
    out = train(cfg.seed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = out["metrics"]
    ret = m["returned_episode_returns"]
    result = {
        "card": smi,
        "config": str(Path(a.config).resolve().relative_to(REPO)),
        "seed": cfg.seed,
        "updates": cfg.num_updates,
        "env_steps": cfg.num_updates * cfg.num_steps * cfg.num_envs,
        "wall_s": wall,
        "ms_per_update": 1e3 * wall / cfg.num_updates,
        "first_learning_update": first_learn[0][0] if first_learn else None,
        "returned_episode_returns_at_first_learning_update": first_learn[0][1] if first_learn else None,
        "returned_episode_returns_first_50_mean": float(np.mean(ret[:50])),
        "returned_episode_returns_last_50_mean": float(np.mean(ret[-50:])),
        "returned_episode_returns_last": float(ret[-1]),
        "test_return_last": float(m["test_return"][-1]),
        "loss_last_50_mean": float(np.mean(m["loss"][-50:])),
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps({**result, "metrics": {k: v.tolist() for k, v in m.items()}}))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
