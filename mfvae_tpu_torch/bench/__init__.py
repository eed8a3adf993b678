"""Measurement entry points of the port: the counterparts of the JAX
package's ``bench.py`` and of ``scripts/perf_matrix.py``, ``mfu_ceiling.py``,
``pallas_probe.py``, ``bench_inference.py`` and ``native_env_bench.py``.

    python -m mfvae_tpu_torch.bench [--device cpu]          # bench.py
    python -m mfvae_tpu_torch.bench.<module> [--device cpu]

Each runs on the card unless the caller asks for the CPU, and raises
without a card otherwise.  Each prints JSON with the keys of its JAX
counterpart, beside the device it ran on (``common.device_info``).
"""
