"""Build-and-load for the port's CUDA sources (``mfvae_tpu_torch/ops/csrc``).

Each ``*.cu`` file is compiled at first use with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, cached under
``mfvae_tpu_torch/build/`` by a content hash of the source, and loaded with
``ctypes``.  Unlike ``mfvae_tpu/utils/native_build.py`` there is no quiet
fallback: a missing compiler or a failed build raises, because a CUDA
tensor must either reach its kernel or fail.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "ops" / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LOADED: dict = {}


class KernelBuildError(RuntimeError):
    """The CUDA toolchain is missing or refused a source."""


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(cuda_home) / "bin" / "nvcc"
        if candidate.exists():
            nvcc = str(candidate)
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (neither on PATH nor under $CUDA_HOME/bin); "
            "the port's CUDA kernels cannot be built"
        )
    return nvcc


def build(source_name: str) -> Path:
    """Compile ``ops/csrc/<source_name>`` unless a library built from the
    same bytes is already cached.  Returns the library's path."""
    src = CSRC_DIR / source_name
    if not src.exists():
        raise KernelBuildError(f"CUDA source {src} is missing")
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    so_path = BUILD_DIR / f"lib{src.stem}-{digest}.so"
    if so_path.exists():
        return so_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # per-process temporary name: a concurrent build in another process
    # must never install a half-written library under the final name
    tmp = so_path.with_name(f"{so_path.name}.tmp.{os.getpid()}")
    cmd = [find_nvcc(), *NVCC_FLAGS, str(src), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    tmp.replace(so_path)
    return so_path


def load(source_name: str) -> ctypes.CDLL:
    """Build (once per content) and load (once per process)."""
    with _LOCK:
        if source_name not in _LOADED:
            _LOADED[source_name] = ctypes.CDLL(str(build(source_name)))
        return _LOADED[source_name]
