"""Entry point, with ``main.py``'s argument contract plus a device flag.

    python -m mfvae_tpu_torch                        # default config, on the card
    python -m mfvae_tpu_torch cfg.yaml a.b=c ...     # YAML + dotted overrides
    python -m mfvae_tpu_torch ... --device cpu       # on the CPU, only when asked
    torchrun --nproc_per_node N -m mfvae_tpu_torch examples/data_parallel.yaml
                                                     # one rank per process (mesh.enable)
"""

import os
import sys

from mfvae_tpu_torch.config import ExperimentConfig, apply_overrides, load_config


def split_args(argv):
    """-> (config path or None, dotted overrides, device)."""
    cfg_path = None
    overrides = []
    device = "cuda"
    args = list(argv)
    while args:
        a = args.pop(0)
        if a == "--device":
            if not args:
                raise SystemExit("--device needs a value (cuda, cuda:N or cpu)")
            device = args.pop(0)
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif "=" in a:
            overrides.append(a)
        elif a.endswith((".yaml", ".yml")):
            cfg_path = a
        else:
            raise SystemExit(f"unrecognized argument {a!r}")
    return cfg_path, overrides, device


def parse_args(argv):
    """-> (ExperimentConfig, device)."""
    cfg_path, overrides, device = split_args(argv)
    cfg = load_config(cfg_path) if cfg_path else ExperimentConfig()
    if overrides:
        apply_overrides(cfg, overrides)
    return cfg, device


def main():
    cfg, device = parse_args(sys.argv[1:])
    import torch.distributed as dist

    from mfvae_tpu_torch.parallel.mesh import init_distributed
    from mfvae_tpu_torch.training.experiment import run_experiment

    if "WORLD_SIZE" in os.environ:  # under torchrun: join its process group
        init_distributed(backend="gloo" if device == "cpu" else None)
    try:
        print(run_experiment(cfg, device))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
