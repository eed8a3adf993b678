"""The MFU the stack reaches once the model is not the reference
architecture: the counterpart of ``scripts/mfu_ceiling.py``.

    python -m mfvae_tpu_torch.bench.mfu_ceiling [--device cpu] [--out FILE]

The same train step (``perf_matrix.measure``) at batch 4,096 on
progressively wider decoders, then on ``big_4096`` (128-wide embeddings,
encoders (256, 256, 512), decoder (4,096, 2,048, 2,048, 2,048, 4,096)),
the largest model the port trains.  The rows carry ``perf_matrix``'s keys;
the last line is ``{"mfu_ceiling": rows, "device": ...}``.
"""

from __future__ import annotations

from mfvae_tpu_torch.bench.common import MFU_PCT_NOTE, STEP_FLOPS_SOURCE, cli, device_info, emit, setup
from mfvae_tpu_torch.bench.perf_matrix import REPS, WARMUP, measure
from mfvae_tpu_torch.config import ModelConfig

BATCH = 4096


def run(device="cuda", tiny: bool = False, batch: int = BATCH, n_scan: int = None, reps: int = REPS,
        warmup: int = WARMUP) -> dict:
    """mfu_ceiling.py's rows; ``n_scan`` replaces every row's step count."""
    kw = dict(device=device, tiny=tiny, reps=reps, warmup=warmup)

    rows = [
        measure(ModelConfig(), batch, n_scan or 100, label="reference_arch", **kw),
        measure(ModelConfig(decoder_hidden=(1024, 512, 512, 512, 1024)), batch, n_scan or 100,
                label="no_bottleneck_512", **kw),
        measure(ModelConfig(decoder_hidden=(2048, 1024, 1024, 1024, 2048)), batch, n_scan or 100,
                label="wide_2048", **kw),
        measure(
            ModelConfig(
                idx_features=128, obs_features=128, action_features=128,
                encoder_hidden=(256, 256, 512),
                decoder_hidden=(4096, 2048, 2048, 2048, 4096),
            ),
            batch, n_scan or 50, label="big_4096", **kw,
        ),
    ]
    return {"mfu_ceiling": rows, "device": device_info(setup(device)), "step_flops_source": STEP_FLOPS_SOURCE,
            "mfu_pct_note": MFU_PCT_NOTE}


def main(argv=None) -> None:
    a = cli("python -m mfvae_tpu_torch.bench.mfu_ceiling", __doc__.split("\n\n")[0], argv)
    emit(run(a.device), a.out)


if __name__ == "__main__":
    main()
