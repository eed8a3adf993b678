"""The benchmark of ``mfvae_tpu_torch`` on one NVIDIA H100 (see
``README.md`` beside this file and ``BENCHMARK.json`` at the repo root)."""
