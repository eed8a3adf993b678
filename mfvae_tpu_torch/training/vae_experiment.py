"""Experiment driver of the single and multimodal VAE families (mirror of
``mfvae_tpu/training/vae_experiment.py``):

1. MLP VAE over one flat modality           (family='mlp')
2. Conv encoder/decoder VAE, bf16, images   (family='conv')
3. factorized multimodal, shared + private  (family='factorized')
4. beta-VAE: KL annealing and free bits     (kl_anneal_steps / free_bits)

    python -m mfvae_tpu_torch.training.vae_experiment {mlp,conv,factorized} [--device cpu]

Every step trains on a fresh synthetic batch (``data/synthetic.py``) made
on the device.  The losses stay on the device and are read once per
``log_every`` chunk (the chunk's mean), as the JAX package reads them once
per scanned chunk; a chunk that runs past ``steps`` is run whole, as
there.  The run's device is an argument, not a config field: the card
unless ``device="cpu"``.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import Tuple

import torch

from mfvae_tpu_torch.data.synthetic import correlated_modalities, sprites
from mfvae_tpu_torch.models.factorized import FactorizedMultimodalVAE
from mfvae_tpu_torch.models.vae import VAE, ConvVAE
from mfvae_tpu_torch.rng import make_streams
from mfvae_tpu_torch.training.checkpoint import CheckpointManager
from mfvae_tpu_torch.training.experiment import resolve_device
from mfvae_tpu_torch.training.metrics import MetricsLogger
from mfvae_tpu_torch.training.vae_trainer import create_vae_state, make_vae_train_step

STREAMS = ("model", "data", "train")


@dataclass
class VaeExperimentConfig:
    family: str = "mlp"  # 'mlp' | 'conv' | 'factorized'
    steps: int = 1000
    batch_size: int = 64
    lr: float = 1e-3
    latent_dim: int = 32
    kl_weight: float = 1.0
    use_huber: bool = False
    kl_anneal_steps: int = 0  # beta-VAE warmup (config 4)
    free_bits: float = 0.0  # beta-VAE floor (config 4)
    # mlp family
    in_dim: int = 64
    # conv family
    image_size: int = 16
    image_channels: int = 3
    conv_channels: Tuple[int, ...] = (16, 32)
    compute_dtype: str = "bfloat16"
    # factorized family
    modality_dims: Tuple[int, int] = (32, 16)
    shared_latent: int = 16
    private_latent: int = 16
    seed: int = 0
    log_dir: str = "results"
    run_name: str = ""
    log_every: int = 100
    checkpoint_dir: str = ""


def build(cfg: VaeExperimentConfig, device, generator: torch.Generator):
    """-> (model on ``device``, gen(data_generator) -> one batch)."""
    if cfg.family == "mlp":
        model = VAE(in_dim=cfg.in_dim, latent_dim=cfg.latent_dim, device=device, generator=generator)

        def gen(g):
            # the flat modality: flattened 8×8×1 sprites (structured, learnable)
            return sprites(g, cfg.batch_size, 8, 1).reshape(cfg.batch_size, -1)[:, : cfg.in_dim]

    elif cfg.family == "conv":
        model = ConvVAE(
            image_shape=(cfg.image_size, cfg.image_size, cfg.image_channels),
            latent_dim=cfg.latent_dim,
            channels=tuple(cfg.conv_channels),
            dtype=getattr(torch, cfg.compute_dtype),
            device=device,
            generator=generator,
        )

        def gen(g):
            return sprites(g, cfg.batch_size, cfg.image_size, cfg.image_channels)

    elif cfg.family == "factorized":
        model = FactorizedMultimodalVAE(
            modality_dims=tuple(cfg.modality_dims),
            shared_latent=cfg.shared_latent,
            private_latent=cfg.private_latent,
            device=device,
            generator=generator,
        )

        def gen(g):
            return correlated_modalities(g, cfg.batch_size, cfg.modality_dims[0], cfg.modality_dims[1])

    else:
        raise ValueError(f"unknown VAE family {cfg.family!r}")
    return model, gen


def run_vae_experiment(cfg: VaeExperimentConfig, device="cuda") -> dict:
    """Train ``cfg.steps`` steps (rounded up to whole chunks).  Returns the
    family, the first and final chunk's mean loss, the steps and the wall
    seconds."""
    dev = resolve_device(device)
    streams = make_streams(cfg.seed, STREAMS, device=dev)
    model, gen = build(cfg, dev, streams["model"])
    state = create_vae_state(model, cfg.lr)
    step_fn = make_vae_train_step(kl_weight=cfg.kl_weight, use_huber=cfg.use_huber,
                                  kl_anneal_steps=cfg.kl_anneal_steps, free_bits=cfg.free_bits)
    chunk = max(1, cfg.log_every)
    logger = MetricsLogger(cfg.log_dir, cfg.run_name or f"vae_{cfg.family}")
    t0 = time.time()
    first = last = None
    for start in range(0, cfg.steps, chunk):
        sums = None
        for _ in range(chunk):
            _, outs = step_fn(state, gen(streams["data"]), streams["train"])
            sums = torch.stack(tuple(outs)) if sums is None else sums + torch.stack(tuple(outs))
        loss, recon, kl = (sums / chunk).tolist()  # one device read per chunk
        logger.scalar("Loss/Train", loss, start + chunk)
        logger.scalar("Loss/Recon_Train", recon, start + chunk)
        logger.scalar("Loss/KL_Train", kl, start + chunk)
        first = first if first is not None else loss
        last = loss
    logger.flush()
    result = {"family": cfg.family, "first_loss": first, "final_loss": last, "steps": cfg.steps,
              "wall_s": time.time() - t0}
    if cfg.checkpoint_dir:
        ckpt = CheckpointManager(cfg.checkpoint_dir)
        ckpt.save(cfg.steps, {"params": model.state_dict(), "step": cfg.steps})
        ckpt.wait()
    return result


def main(argv) -> None:
    args = list(argv)
    device = "cuda"
    if "--device" in args:
        i = args.index("--device")
        if i + 1 >= len(args):
            raise SystemExit("--device needs a value (cuda, cuda:N or cpu)")
        device = args.pop(i + 1)
        args.pop(i)
    fam = args[0] if args else "mlp"
    print(run_vae_experiment(VaeExperimentConfig(family=fam, steps=300), device))


if __name__ == "__main__":
    main(sys.argv[1:])
