"""Build-and-load for the repo's first-party C++ sources (``native/``), the
host MPE engine and the host ring buffer (mirror of
``mfvae_tpu/utils/native_build.py``).

``native/<name>.cpp`` is compiled at first use with g++, with the JAX
package's flags, so both packages step one engine to the same bits, into
the git-ignored ``mfvae_tpu_torch/build/native/`` and loaded with ctypes.
The sources hold no framework code and are built as they are.

The cache key is the source's content hash, the command line and the CPU
(``platform.machine()`` and the model name in ``/proc/cpuinfo``):
``-march=native`` code built on one host may not run on another, and a
library keyed on the source alone could be loaded where it dies with
SIGILL.  As in the JAX package, a missing source or toolchain or a failed
build returns None, and the callers fall back to their numpy paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")

_BUILD_LOCK = threading.Lock()
_LOAD_CACHE: dict = {}


def cpu_model() -> str:
    """The CPU's model name from /proc/cpuinfo ('' where there is none)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return ""


def library_path(source_name: str) -> Path:
    """Where ``native/<source_name>`` is built on this host."""
    src = NATIVE_DIR / source_name
    h = hashlib.sha256(src.read_bytes())
    for part in ("g++", *GXX_FLAGS, platform.machine(), cpu_model()):
        h.update(b"\0" + part.encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def load_cached(source_name: str) -> Optional[ctypes.CDLL]:
    """``build_and_load`` once per process, cached by source name (a None
    result too, so a missing toolchain is probed once)."""
    with _BUILD_LOCK:
        if source_name not in _LOAD_CACHE:
            _LOAD_CACHE[source_name] = build_and_load(source_name)
        return _LOAD_CACHE[source_name]


def build_and_load(source_name: str) -> Optional[ctypes.CDLL]:
    """Compile ``native/<source_name>`` unless this host already built the
    same bytes with the same command, then load it; None when the source
    is missing, g++ is unavailable or the build or load fails."""
    src = NATIVE_DIR / source_name
    if not src.exists():
        return None
    so_path = library_path(source_name)
    if not so_path.exists():
        so_path.parent.mkdir(parents=True, exist_ok=True)
        # per-process temporary name: two processes building at once must
        # never install a truncated library under the final name
        tmp = so_path.with_name(f"{so_path.name}.tmp.{os.getpid()}")
        cmd = ["g++", *GXX_FLAGS, str(src), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            tmp.replace(so_path)
        except (subprocess.CalledProcessError, FileNotFoundError):
            tmp.unlink(missing_ok=True)
            return None
    try:
        return ctypes.CDLL(str(so_path))
    except OSError:
        return None
