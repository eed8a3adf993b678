"""Train-step samples/s and MFU across batch sizes and model options on the
flagship model: the counterpart of ``scripts/perf_matrix.py``.

    python -m mfvae_tpu_torch.bench.perf_matrix [--device cpu] [--out FILE]

``measure`` is the JAX script's (``mfu_ceiling.py`` and
``pallas_probe.py`` share it): a model of the given ``ModelConfig`` over
``flagship_batch``'s inputs, its initial parameters from seed 0, and
``make_train_step(LossConfig(), use_pallas=mc.use_pallas)``, so a
``use_pallas`` row runs kernels K1-K3 (``ops/fused_elbo.py``) and every
other row the plain torch route.  The JAX script's scan of ``n_scan``
steps is an eager loop of ``n_scan`` steps with one device sync, after a
warm-up, best of 3.  Each row prints as one JSON line with the JAX row's
keys (``label``, ``batch``, ``ms_per_step``, ``samples_per_sec``,
``flops_per_step``, ``mfu_pct``) and, beside them: ``device``,
``compute_dtype``, ``route`` ("kernels" or "plain"), ``steps`` (every
train step the row took, warm-up included: the kernels' launch count on
the kernel route is K1 = K2 = steps, K3 = 2·steps) and
``max_memory_allocated`` (bytes, the row's peak on the card; null on the
CPU).  The last line is ``{"matrix": rows, "device": ...}`` with
``step_flops_source`` and ``mfu_pct_note`` (the MFU counts matrix
products only).

Labels keep the JAX names: ``_xla`` in ``pallas_probe``'s labels means the
plain torch route here.
"""

from __future__ import annotations

import json

import torch

from mfvae_tpu_torch.bench.common import (
    MFU_PCT_NOTE,
    STEP_FLOPS_SOURCE,
    best_window,
    cli,
    device_info,
    emit,
    mfu_pct,
    peak_memory,
    reset_peak_memory,
    setup,
    step_flops,
)
from mfvae_tpu_torch.bench.flagship import build_model, flagship_batch, flagship_spec, tiny_config
from mfvae_tpu_torch.config import LossConfig, ModelConfig, TrainConfig
from mfvae_tpu_torch.training.trainer import create_train_state, make_train_step

WARMUP = 3  # steps before the timed windows
REPS = 3
# perf_matrix.py's population rows: (adversaries, good agents)
POPULATIONS = ((60, 20), (120, 40), (240, 80))


def measure(mc: ModelConfig, batch_size: int, n_scan: int = 300, label: str = "",
            n_adv: int = 30, n_good: int = 10, n_land: int = 20, *, device="cuda",
            tiny: bool = False, reps: int = REPS, warmup: int = WARMUP) -> dict:
    """One row: ``n_scan`` eager train steps on ``device`` with one sync,
    best of ``reps`` after ``warmup`` steps.  ``tiny`` cuts ``mc``'s widths."""
    dev = setup(device)
    if tiny:
        mc = tiny_config(mc)
    spec = flagship_spec(n_adv, n_good, n_land)
    reset_peak_memory(dev)
    model = build_model(mc, spec, dev)
    batch = flagship_batch(spec, batch_size, dev)
    state = create_train_state(model, TrainConfig())
    step = make_train_step(LossConfig(), use_pallas=mc.use_pallas)
    gen = torch.Generator(device=dev).manual_seed(7)
    for _ in range(warmup):
        step(state, batch, gen)
    best = best_window(lambda i: step(state, batch, gen), n_scan, reps, dev)
    flops = step_flops(model, batch_size)
    sps = batch_size * n_scan / best
    row = {
        "label": label,
        "batch": batch_size,
        "ms_per_step": 1000 * best / n_scan,
        "samples_per_sec": sps,
        "flops_per_step": flops,
        "mfu_pct": mfu_pct(flops, sps / batch_size, mc.compute_dtype, dev),
        "compute_dtype": mc.compute_dtype,
        "route": "kernels" if mc.use_pallas else "plain",
        "steps": warmup + reps * n_scan,
        "max_memory_allocated": peak_memory(dev),
        "device": device_info(dev),
    }
    print(json.dumps(row), flush=True)
    return row


def run(device="cuda", tiny: bool = False, batches=(256, 1024, 4096), batch: int = 256,
        n_scan: int = None, populations=POPULATIONS, reps: int = REPS, warmup: int = WARMUP) -> dict:
    """perf_matrix.py's rows; ``n_scan`` replaces every row's step count
    (a cut run), ``populations`` its population rows."""
    kw = dict(device=device, tiny=tiny, reps=reps, warmup=warmup)

    rows = [measure(ModelConfig(), b, n_scan or 300, label="default_bf16", **kw) for b in batches]
    rows.append(measure(ModelConfig(use_pallas=True), batch, n_scan or 300, label="pallas", **kw))
    rows.append(measure(ModelConfig(fused_decoders=False), batch, n_scan or 300, label="separate_decoders", **kw))
    rows.append(measure(ModelConfig(det_features=64), batch, n_scan or 300, label="det64", **kw))
    rows.append(measure(ModelConfig(compute_dtype="float32"), batch, n_scan or 300, label="f32", **kw))
    # population scaling: the stacked agent axis is the long axis; the
    # decoder input grows as (64 + 64)·A
    for n_adv, n_good in populations:
        rows.append(measure(ModelConfig(), batch, n_scan or 100, label=f"agents_{n_adv + n_good}",
                            n_adv=n_adv, n_good=n_good, n_land=20, **kw))
    return {"matrix": rows, "device": device_info(setup(device)), "step_flops_source": STEP_FLOPS_SOURCE,
            "mfu_pct_note": MFU_PCT_NOTE}


def main(argv=None) -> None:
    a = cli("python -m mfvae_tpu_torch.bench.perf_matrix", __doc__.split("\n\n")[0], argv)
    emit(run(a.device), a.out)


if __name__ == "__main__":
    main()
