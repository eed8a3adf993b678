"""Seed CI for the distillation headline on the card: the port's counterpart
of ``scripts/distill_seed_ci.py``, same protocol.

    python scripts/torch_distill_seed_ci.py [--seeds 0,1,2,3] [--updates 1500]
        [--work DIR] [--ckpt DIR] [--out results/torch/distill_seed_ci.json] [--device cuda]
        [key=value ...]
    python scripts/torch_distill_seed_ci.py --merge a.json b.json --out c.json

Trains the world model of ``examples/behavior_policy.yaml`` (the recipe of
``sticky_study.train_sticky(8, 256, hold=0.9, grad_clip=10.0)``: sticky
collection at hold 0.9, unroll 8, clip 10) once, then re-distills the
adversaries' policy through that same model under independent generators
(seed 1000 + s) and scores each policy's sampled arm and the uniform-random
anchor on the real env: ``chunks`` x ``n_episodes`` episodes of ``ep_len``
steps, chunk c seeded 1234 + c, adversaries on the policy and the rest
random, the adversary return summed over steps and adversaries.

The world model trains with ``train.checkpoint_every`` into ``--ckpt``
(full carries, buffers included: keep it out of ``--work`` when that
directory is copied back) and resumes from it, so a run that fails keeps
its finished epochs.  Its weights and final losses go to ``<work>/wm.pt`` (+ ``.json``);
a later run that finds them skips the training (after each seed the
output so far is written to ``<work>/partial_seeds<s>.json``), so ``--seeds 0,1`` and
``--seeds 2,3`` can run in separate processes and ``--merge`` joins their
outputs.  ``key=value`` overrides apply to the config last (the tests cut
widths and depths with them).  Prints one JSON object with the keys of
``results/r4/distill_seed_ci.json`` plus the card's name and power limit
(``card``), the wall of each stage (``walls_s``) and the world model's
final Loss/Test and Loss/Train (``world_model``).  Runs on the CUDA card
unless ``--device cpu`` is given.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# the protocol of scripts/distill_seed_ci.py, scripts/sticky_study.py and
# scripts/dreamer_iteration_study.py (tests/test_torch_distill_seed_ci.py
# holds these against those files)
HOLD = 0.9
UNROLL = 8
EPOCHS = 256
GRAD_CLIP = 10.0
SEEDS = 4
UPDATES = 1500
N_EPISODES = 32
EP_LEN = 128
CHUNKS = 4
BEHAVIOR_SEED = 1000
EVAL_SEED = 1234
HEADLINE_ANCHOR = 51782.8
WORLD_MODEL = {  # train_sticky's ExperimentConfig edits
    "model.det_features": 128,
    "model.residual_state": True,
    "model.state_skip": True,
    "model.decoder_layernorm": True,
    "model.fused_decoders": False,
    "model.reward_head_mode": "linear",
    "model.reward_head_input": "latent",
    "model.action_delta_head": False,
    "loss.s_weight": 300.0,
    "loss.contact_weight": 0.0,
    "loss.prey_dist_weight": 0.0,
    "buffer.max_size": 10240,
    "train.collect_policy": "sticky",
    "train.epochs_per_dispatch": 32,
    "train.resume": True,
}
BEHAVIOR = {  # behavior_cfg(cfg, updates)
    "algo": "distill",
    "score": "prey_distance",
    "horizon": 8,
    "n_starts": 32,
    "m_rollouts": 24,
    "continuation": "hold",
    "temperature": 0.5,
    "visit_steps": 3,
    "start_pool": 4096,
}


def card_name(device) -> str:
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def build_config(updates: int, work: Path, ckpt: Path, overrides):
    from mfvae_tpu_torch.config import ExperimentConfig, apply_overrides

    cfg = ExperimentConfig()
    apply_overrides(cfg, [f"{k}={v}" for k, v in WORLD_MODEL.items()])
    cfg.train.unroll_steps = UNROLL
    cfg.train.grad_clip = GRAD_CLIP
    cfg.train.epoch_num = EPOCHS
    cfg.train.collect_mix_frac = HOLD
    cfg.train.run_name = "sticky_sticky90_w8_clip10"
    cfg.train.log_dir = str(work / "logs")
    cfg.train.checkpoint_dir = str(ckpt)
    cfg.train.checkpoint_every = 32
    for k, v in BEHAVIOR.items():
        setattr(cfg.behavior, k, v)
    cfg.behavior.updates = updates
    apply_overrides(cfg, list(overrides))
    cfg.validate()
    return cfg


def world_model(cfg, work: Path, device):
    """The set-up Experiment with the trained world model, and its final
    losses: trained (or resumed) on the first run, loaded from
    ``<work>/wm.pt`` after it."""
    import torch

    from mfvae_tpu_torch.training.experiment import Experiment

    weights = work / "wm.pt"
    sidecar = weights.with_suffix(".pt.json")
    if weights.exists() and sidecar.exists():
        cfg.train.resume = False  # the weights stand for the finished run
        exp = Experiment(cfg, device).setup()
        exp.carry.train_state.model.load_state_dict(torch.load(weights, map_location=exp.device,
                                                               weights_only=True))
        return exp, json.loads(sidecar.read_text())
    exp = Experiment(cfg, device).setup()
    res = exp.run()
    exp.ckpt.close()
    losses = {"loss_test": res.get("loss_test"), "loss_train": res.get("loss_train"),
              "epochs": cfg.train.epoch_num,
              "median_epoch_wall_ms": (1e3 * sorted(res["epoch_wall_s"])[len(res["epoch_wall_s"]) // 2]
                                       if res.get("epoch_wall_s") else None)}
    torch.save(exp.carry.train_state.model.state_dict(), weights)
    sidecar.write_text(json.dumps(losses))
    return exp, losses


def run(seeds, updates: int, n_episodes: int, ep_len: int, chunks: int, work: Path, ckpt: Path,
        device: str, overrides=()) -> dict:
    import numpy as np
    import torch

    from mfvae_tpu_torch.behavior import train_behavior
    from mfvae_tpu_torch.imagination import make_policy_actor
    from mfvae_tpu_torch.planning import eval_joint_policy
    from mfvae_tpu_torch.training.experiment import resolve_device
    from mfvae_tpu_torch.training.trainer import make_action_sampler

    dev = resolve_device(device)
    card = card_name(dev)
    print(f"card: {card}", flush=True)
    work.mkdir(parents=True, exist_ok=True)
    walls = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    cfg = build_config(updates, work, ckpt, overrides)
    exp, wm_losses = world_model(cfg, work, dev)
    sync()
    walls["world_model"] = time.perf_counter() - t0
    print(f"[{time.perf_counter() - t0:.0f}s] WM ready: {json.dumps(wm_losses)}", flush=True)
    env, spec = exp.env, exp.spec
    n_adv = cfg.env.num_adversaries
    adv_idx = tuple(range(n_adv))
    is_adv = torch.arange(spec.n_agents, device=dev) < n_adv
    sample_actions, _ = make_action_sampler(env, spec)

    def arm_random(obs, state, g):
        return sample_actions(g, (n_episodes,))

    def eval_arm(pol):
        rets = []
        for c in range(chunks):
            rewards = eval_joint_policy(env, spec, pol, n_episodes=n_episodes, ep_len=ep_len,
                                        generator=torch.Generator(device=dev).manual_seed(EVAL_SEED + c))
            rets.append(rewards[:, :, :n_adv].sum(dim=(1, 2)).double().cpu().numpy())
        r = np.concatenate(rets)
        return float(r.mean()), float(r.std(ddof=1) / np.sqrt(len(r)))

    t = time.perf_counter()
    rand_mean, rand_sem = eval_arm(arm_random)
    walls["random_eval"] = time.perf_counter() - t
    print(f"[{time.perf_counter() - t0:.0f}s] random: {rand_mean:.0f}±{rand_sem:.0f}", flush=True)

    per_seed = []
    partial = work / f"partial_seeds{'-'.join(str(s) for s in seeds)}.json"

    def summary() -> dict:
        walls["total"] = time.perf_counter() - t0
        return {
            "study": "distillation seed CI (same WM, independent behavior keys)",
            "updates": updates, "hold": HOLD, "seeds": len(per_seed),
            "random_anchor": {"mean": rand_mean, "sem": rand_sem},
            "per_seed": per_seed,
            "across_seeds": across_seeds(per_seed),
            "headline_anchor": HEADLINE_ANCHOR,
            "_regen": {"cmd": "python " + " ".join(sys.argv), "wall_s": walls["total"]},
            "card": card,
            "walls_s": walls,
            "world_model": wm_losses,
            "protocol": {"n_episodes": n_episodes, "ep_len": ep_len, "chunks": chunks,
                         "epochs": cfg.train.epoch_num, "overrides": list(overrides)},
        }

    for s in seeds:
        t = time.perf_counter()
        res = train_behavior(exp, generator=torch.Generator(device=dev).manual_seed(BEHAVIOR_SEED + s))
        sync()
        walls[f"distill_seed{s}"] = time.perf_counter() - t
        actor = make_policy_actor(res.policy, env, spec, adv_idx, greedy=False)

        def arm_pol(obs, state, g, actor=actor):
            return torch.where(is_adv, actor(obs, g), sample_actions(g, (n_episodes,)))

        t = time.perf_counter()
        mean, sem = eval_arm(arm_pol)
        walls[f"eval_seed{s}"] = time.perf_counter() - t
        per_seed.append({"seed": s, "return_mean": mean, "return_sem": sem,
                         "final": res.curve[-1] if res.curve else {},
                         "ms_per_update": 1e3 * walls[f"distill_seed{s}"] / max(updates, 1)})
        print(f"[{time.perf_counter() - t0:.0f}s] seed {s}: {mean:.0f}±{sem:.0f}", flush=True)
        # what the seeds so far gave, should a later one not finish
        partial.write_text(json.dumps(summary(), indent=1))

    return summary()


def across_seeds(per_seed) -> dict:
    import numpy as np

    means = np.array([r["return_mean"] for r in per_seed])
    n = len(means)
    return {
        "mean": float(means.mean()),
        "std": float(means.std(ddof=1)) if n > 1 else 0.0,
        "sem": float(means.std(ddof=1) / np.sqrt(n)) if n > 1 else 0.0,
    }


def merge(paths) -> dict:
    """Join the outputs of runs over disjoint seeds through one world
    model: their per-seed rows, walls and a recomputed across-seeds row."""
    outs = [json.loads(Path(p).read_text()) for p in paths]
    out = dict(outs[0])
    out["per_seed"] = sorted((r for o in outs for r in o["per_seed"]), key=lambda r: r["seed"])
    seeds = [r["seed"] for r in out["per_seed"]]
    if len(set(seeds)) != len(seeds):
        raise ValueError(f"the runs to merge repeat a seed: {seeds}")
    out["seeds"] = len(out["per_seed"])
    out["across_seeds"] = across_seeds(out["per_seed"])
    out["walls_s"] = {f"run{i}": o["walls_s"] for i, o in enumerate(outs)}
    out["_regen"] = {"cmd": "merge of " + ", ".join(o["_regen"]["cmd"] for o in outs),
                     "wall_s": sum(o["_regen"]["wall_s"] for o in outs)}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default=",".join(str(s) for s in range(SEEDS)))
    ap.add_argument("--updates", type=int, default=UPDATES)
    ap.add_argument("--episodes", type=int, default=N_EPISODES)
    ap.add_argument("--ep-len", type=int, default=EP_LEN)
    ap.add_argument("--chunks", type=int, default=CHUNKS)
    # the weights (166 MiB at full width) and the checkpoints stay out of
    # what a run hands back: --out names the result
    ap.add_argument("--work", default=str(REPO / ".archive" / "distill_ci"))
    ap.add_argument("--ckpt", default=str(REPO / ".archive" / "distill_ci_ckpt"))
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--merge", nargs="+", default=None)
    a, overrides = ap.parse_known_args(argv)
    if a.merge:
        out = merge(a.merge)
    else:
        seeds = [int(s) for s in a.seeds.split(",") if s != ""]
        out = run(seeds, a.updates, a.episodes, a.ep_len, a.chunks, Path(a.work), Path(a.ckpt),
                  a.device, overrides)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
