"""Train samples/s at batch 256 on the flagship model: the counterpart of
the JAX package's ``bench.py``.

    python -m mfvae_tpu_torch.bench [--device cpu] [--out FILE]

Prints one JSON line with every key of ``bench.py``'s output, each with
its meaning there, so the line reads beside a ``BENCH_r0*.json`` key by
key (those are the JAX package's numbers on a TPU, not the port's).  The
keys that name an XLA mechanism with no counterpart here are ``null``,
each with its reason under ``"absent"``.  Beside them: ``device`` (the
card's name, count and power limit), ``peak_flops``, ``step_flops_source``,
``mfu_pct_note`` (every ``*mfu_pct`` here counts matrix products only,
fewer FLOPs than XLA's count in bench.py's), ``multiseed_4x_discipline``
and ``counts``.

The disciplines (``common.py``): every row starts from the flagship's
initial parameters (a copy, since the train step updates its state in
place) and is warmed up first.

- ``value``: bench.py's N_SCAN = 500 steps of the b256 train step, as an
  eager loop with one device sync at its end, best of 3
  (``value_discipline`` "eager500_one_sync").  ``mfu_pct`` reads it.
- ``dispatch_bound_samples_per_sec``: the 200-step window, one sync, best
  of 3; ``wall_samples_per_sec``: 20 steps with a sync after each.
- multiseed 4×: 4 independent states (seeds 21-24) stepped in lockstep,
  the discipline of ``training/multiseed.py``; 200 lockstep steps, one
  sync, best of 2.
- batch scaling at 1,024 and 4,096 (100 steps); the det128, recipe
  (``world_model.yaml``'s model, ``s_weight`` 300) and control (+
  ``action_delta_head``) rows at b256 (500 steps); the recipe's W = 8
  unroll step (``training/unroll.py``, 100 steps): each best of 2.
- the full epoch: ``Experiment(ExperimentConfig()).setup()``, one warm-up
  ``run_epoch()``, then 20 epochs with a sync after each
  (``wall_epoch_seconds``) and 20 with one sync at the end
  (``pipelined_epoch_seconds``); logs and checkpoints go to a temporary
  directory.

Off the card (``--device cpu``) every ``*mfu_pct`` is null: a CPU run
measures the CPU.
"""

from __future__ import annotations

import copy
import tempfile

import numpy as np
import torch

from mfvae_tpu_torch.bench.common import (
    PEAK_FLOPS,
    MFU_PCT_NOTE,
    STEP_FLOPS_SOURCE,
    best_window,
    cli,
    device_info,
    emit,
    mfu_pct,
    setup,
    step_flops,
    synced_wall,
)
from mfvae_tpu_torch.bench.flagship import (
    bench_targets,
    build_model,
    draw_grouped,
    flagship,
    tiny_config,
    to_batch,
)
from mfvae_tpu_torch.config import ExperimentConfig, LossConfig, ModelConfig, TrainConfig
from mfvae_tpu_torch.data.transitions import GroupedTransition
from mfvae_tpu_torch.training.experiment import Experiment
from mfvae_tpu_torch.training.trainer import create_train_state, make_train_step
from mfvae_tpu_torch.training.unroll import make_unroll_train_step

BATCH = 256
BASELINE = 19.0  # the reference's end-to-end trained samples/s (BASELINE.md)
W_UNROLL = 8
N_REP = 4
# bench.py's iteration counts; ``warmup`` steps precede every timed row
FULL = dict(n_scan=500, n_pipelined=200, n_wall=20, n_multiseed=200, n_scaling=100,
            n_unroll=100, n_epochs=20, reps=3, reps_rows=2, warmup=3)
ABSENT = {
    "b256_unroll8_samples_per_sec": "lax.scan's unroll=8 lets XLA schedule 8 scanned steps as one "
                                    "program; eager PyTorch runs one step at a time and has no counterpart",
    "scanned_epoch_seconds": "train.epochs_per_dispatch (32 epochs in one lax.scan dispatch); the port "
                             "ignores it on purpose and runs epoch by epoch",
    "scanned_end_to_end_samples_per_sec": "derived from scanned_epoch_seconds, absent for the same reason",
}
MULTISEED_DISCIPLINE = ("4 independent train states (seeds 21-24) stepped in lockstep, one after "
                        "another each step (training/multiseed.py), one device sync a window")


def _dtype_name(model) -> str:
    return str(model.dtype).removeprefix("torch.")


def _tiny_experiment(cfg: ExperimentConfig) -> ExperimentConfig:
    """The epoch row at the tiny widths and a small population
    (tests/test_pinned_goldens.py's parity_small sizes)."""
    cfg.model = tiny_config(cfg.model)
    cfg.env.num_good_agents, cfg.env.num_adversaries, cfg.env.num_obs, cfg.env.max_steps = 2, 3, 2, 64
    cfg.buffer.max_size, cfg.buffer.min_size, cfg.buffer.batch_size = 512, 32, 32
    cfg.train.batch_size, cfg.train.sample_num, cfg.train.train_num, cfg.train.test_num = 32, 32, 5, 8
    return cfg


def _window_batch(rng: np.random.Generator, spec, batch: int, device) -> GroupedTransition:
    """bench.py's [B, W] window batch, drawn in its order: every group's
    obs, every group's actions, every group's next obs, the rewards."""
    def t(x):
        return torch.from_numpy(x).to(device)

    obs = tuple(t(rng.normal(size=(batch, W_UNROLL, len(i), od)).astype(np.float32)) for (od, _), i in spec.groups)
    act = tuple(t(rng.integers(0, ad, size=(batch, W_UNROLL, len(i))).astype(np.int32)) for (_, ad), i in spec.groups)
    nxt = tuple(t(rng.normal(size=(batch, W_UNROLL, len(i), od)).astype(np.float32)) for (od, _), i in spec.groups)
    rew = t(rng.normal(size=(batch, W_UNROLL, spec.n_agents)).astype(np.float32))
    return GroupedTransition(obs=obs, actions=act, next_obs=nxt, rewards=rew,
                             done=torch.zeros((batch, W_UNROLL), dtype=torch.float32, device=device))


def run(device="cuda", tiny: bool = False, batch: int = BATCH, batches=(1024, 4096), **counts) -> dict:
    """Every row of bench.py on ``device``; returns the JSON object.
    ``counts`` override ``FULL``'s iteration counts (a cut run)."""
    unknown = set(counts) - set(FULL)
    if unknown:
        raise ValueError(f"unknown counts {sorted(unknown)}; expected some of {sorted(FULL)}")
    c = {**FULL, **counts}
    dev = setup(device)
    spec, model, inputs = flagship(batch, tiny=tiny, device=dev)
    rng = np.random.default_rng(0)
    vb = bench_targets(rng, spec, inputs, dev)
    step = make_train_step(LossConfig())
    gen = torch.Generator(device=dev).manual_seed(2)

    def config(**options):
        mc = ModelConfig(**options)
        return tiny_config(mc) if tiny else mc

    def fresh(m):
        return create_train_state(copy.deepcopy(m), TrainConfig())

    def timed(state, step_fn, wb, n, reps):
        """Best seconds of ``reps`` windows of ``n`` steps after the warm-up."""
        for _ in range(c["warmup"]):
            step_fn(state, wb, gen)
        return best_window(lambda i: step_fn(state, wb, gen), n, reps, dev)

    def mfu(flops, sps, b, m):
        return mfu_pct(flops, sps / b, _dtype_name(m), dev)

    # ---------------------------------------------------- b256, one state
    flops = step_flops(model, batch)
    state = fresh(model)
    pipelined_s = timed(state, step, vb, c["n_pipelined"], c["reps"])
    wall_s = synced_wall(lambda i: step(state, vb, gen), c["n_wall"], dev)
    scan_s = best_window(lambda i: step(state, vb, gen), c["n_scan"], c["reps"], dev)
    value = batch * c["n_scan"] / scan_s

    # ---------------------------------------------------- multiseed 4x
    replicas = [create_train_state(build_model(config(), spec, dev, 21 + r), TrainConfig()) for r in range(N_REP)]
    gens = [torch.Generator(device=dev).manual_seed(23 + r) for r in range(N_REP)]

    def lockstep(_):
        for s, g in zip(replicas, gens):
            step(s, vb, g)

    for _ in range(c["warmup"]):
        lockstep(0)
    multiseed_sps = N_REP * batch * c["n_multiseed"] / best_window(lockstep, c["n_multiseed"], c["reps_rows"], dev)
    del replicas, gens

    # ---------------------------------------------------- batch scaling
    batch_scaling = {}
    for big in batches:
        obs, act = draw_grouped(np.random.default_rng(0), spec, big)  # _flagship(batch_size=big)'s inputs
        vb_b = bench_targets(rng, spec, to_batch(obs, act, dev), dev)
        sps_b = big * c["n_scaling"] / timed(fresh(model), step, vb_b, c["n_scaling"], c["reps_rows"])
        batch_scaling[str(big)] = {"samples_per_sec": sps_b, "mfu_pct": mfu(step_flops(model, big), sps_b, big, model)}
        del vb_b

    # ---------------------------------------------------- det128, recipe, control
    det_model = build_model(config(det_features=128), spec, dev)
    det_sps = batch * c["n_scan"] / timed(fresh(det_model), step, vb, c["n_scan"], c["reps_rows"])
    recipe_kw = dict(det_features=128, residual_state=True, state_skip=True, decoder_layernorm=True,
                     fused_decoders=False)
    recipe_loss = LossConfig(s_weight=300.0)
    recipe_step = make_train_step(recipe_loss)
    recipe_model = build_model(config(**recipe_kw), spec, dev)
    recipe_sps = batch * c["n_scan"] / timed(fresh(recipe_model), recipe_step, vb, c["n_scan"], c["reps_rows"])
    control_model = build_model(config(**recipe_kw, action_delta_head=True), spec, dev)
    control_sps = batch * c["n_scan"] / timed(fresh(control_model), recipe_step, vb, c["n_scan"], c["reps_rows"])

    # ---------------------------------------------------- recipe, unroll W = 8
    unroll_step = make_unroll_train_step(spec, recipe_loss, W_UNROLL)
    wbatch = _window_batch(rng, spec, batch, dev)
    unroll_windows_ps = batch * c["n_unroll"] / timed(fresh(recipe_model), unroll_step, wbatch, c["n_unroll"],
                                                      c["reps_rows"])
    del wbatch

    # ---------------------------------------------------- the full epoch
    cfg = _tiny_experiment(ExperimentConfig()) if tiny else ExperimentConfig()
    with tempfile.TemporaryDirectory() as tmp:
        cfg.train.log_dir, cfg.train.checkpoint_dir = f"{tmp}/results", f"{tmp}/ckpt"
        exp = Experiment(cfg, dev).setup()
        synced_wall(lambda e: exp.run_epoch(), 1, dev)  # warm-up
        wall_epoch_s = synced_wall(lambda e: exp.run_epoch(), c["n_epochs"], dev) / c["n_epochs"]
        pipelined_epoch_s = best_window(lambda e: exp.run_epoch(), c["n_epochs"], 1, dev) / c["n_epochs"]
        exp.logger.close()
    wall_e2e = cfg.train.batch_size * cfg.train.train_num / wall_epoch_s

    return {
        "metric": "train_samples_per_sec_per_chip_batch256",
        "value": value,
        "unit": "samples/s",
        "value_discipline": f"eager{c['n_scan']}_one_sync",
        "vs_baseline": wall_e2e / BASELINE,
        "vs_baseline_discipline": "wall_end_to_end",
        "device_scan_vs_baseline": value / BASELINE,
        "dispatch_bound_samples_per_sec": batch * c["n_pipelined"] / pipelined_s,
        "wall_samples_per_sec": batch * c["n_wall"] / wall_s,
        "wall_epoch_seconds": wall_epoch_s,
        "wall_end_to_end_samples_per_sec": wall_e2e,
        "pipelined_epoch_seconds": pipelined_epoch_s,
        "scanned_epoch_seconds": None,
        "scanned_end_to_end_samples_per_sec": None,
        "step_flops": flops,
        "mfu_pct": mfu(flops, value, batch, model),
        "b256_unroll8_samples_per_sec": None,
        "multiseed_4x_b256_samples_per_sec": multiseed_sps,
        "multiseed_4x_mfu_pct": mfu(flops, multiseed_sps, batch, model),
        "batch_scaling": batch_scaling,
        "det128_b256_samples_per_sec": det_sps,
        "det128_b256_mfu_pct": mfu(step_flops(det_model, batch), det_sps, batch, det_model),
        "recipe_b256_samples_per_sec": recipe_sps,
        "recipe_b256_mfu_pct": mfu(step_flops(recipe_model, batch), recipe_sps, batch, recipe_model),
        "control_b256_samples_per_sec": control_sps,
        "control_b256_mfu_pct": mfu(step_flops(control_model, batch), control_sps, batch, control_model),
        "recipe_unroll8_b256w8_transitions_per_sec": unroll_windows_ps * W_UNROLL,
        "recipe_unroll8_b256w8_windows_per_sec": unroll_windows_ps,
        "recipe_unroll8_b256w8_mfu_pct": mfu(step_flops(recipe_model, batch, W_UNROLL), unroll_windows_ps, batch,
                                             recipe_model),
        "absent": ABSENT,
        "device": device_info(dev),
        "peak_flops": PEAK_FLOPS,
        "step_flops_source": STEP_FLOPS_SOURCE,
        "mfu_pct_note": MFU_PCT_NOTE,
        "multiseed_4x_discipline": MULTISEED_DISCIPLINE,
        "counts": c,
    }


def main(argv=None) -> None:
    a = cli("python -m mfvae_tpu_torch.bench", __doc__.split("\n\n")[0], argv)
    emit(run(a.device), a.out)


if __name__ == "__main__":
    main()
