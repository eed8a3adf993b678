"""The kernel route against the plain route at det_features 128: the
counterpart of ``scripts/pallas_probe.py``.

    python -m mfvae_tpu_torch.bench.pallas_probe [--device cpu] [--out FILE]

``perf_matrix.measure`` at batch 256 and 4,096, each by the plain torch
route and by kernels K1-K3 (``model.use_pallas``), one after the other,
from the same initial parameters, inputs and generator seed.  The labels
keep the JAX names, ``det128_b{B}_{xla,pallas}``: on the port ``xla``
means the plain torch route and ``pallas`` the hand-written CUDA kernels.
At b4096 K3's state tensor holds 4,096 × 5,660 = 23,183,360 elements.
The last line is ``{"pallas_probe": rows, "device": ...}``.
"""

from __future__ import annotations

from mfvae_tpu_torch.bench.common import MFU_PCT_NOTE, STEP_FLOPS_SOURCE, cli, device_info, emit, setup
from mfvae_tpu_torch.bench.perf_matrix import REPS, WARMUP, measure
from mfvae_tpu_torch.config import ModelConfig


def run(device="cuda", tiny: bool = False, batches=(256, 4096), n_scan: int = 200, reps: int = REPS,
        warmup: int = WARMUP) -> dict:
    """pallas_probe.py's rows."""
    rows = [
        measure(ModelConfig(det_features=128, use_pallas=pallas), b, n_scan,
                label=f"det128_b{b}_{'pallas' if pallas else 'xla'}",
                device=device, tiny=tiny, reps=reps, warmup=warmup)
        for b in batches
        for pallas in (False, True)
    ]
    return {"pallas_probe": rows, "device": device_info(setup(device)), "step_flops_source": STEP_FLOPS_SOURCE,
            "mfu_pct_note": MFU_PCT_NOTE}


def main(argv=None) -> None:
    a = cli("python -m mfvae_tpu_torch.bench.pallas_probe", __doc__.split("\n\n")[0], argv)
    emit(run(a.device), a.out)


if __name__ == "__main__":
    main()
