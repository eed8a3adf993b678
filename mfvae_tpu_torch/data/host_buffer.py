"""Host ring buffer over the repo's C++ core (``native/ringbuffer.cpp``;
mirror of ``mfvae_tpu/data/host_buffer.py``).

A host-RAM FIFO with a per-field schema, batched add and uniform batch
sampling, for the host backend, whose transitions are made on the CPU
(``envs/host_adapter.py``).  The device path keeps ``data/buffer.py``
``ItemBuffer``.  ``backend`` says which ring serves: "native" (the C++
core, built at first use by ``utils/native_build.py``) or "numpy" (no
toolchain, or ``force_numpy``).  Both draw their samples from a seeded
generator of their own, as the JAX package's do, so at one seed the port's
ring holds and returns what the JAX package's does.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np

from mfvae_tpu_torch.utils.native_build import load_cached


def _get_lib() -> Optional[ctypes.CDLL]:
    lib = load_cached("ringbuffer.cpp")
    if lib is None or getattr(lib, "_rb_configured", False):
        return lib
    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [
        ctypes.c_uint64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
    ]
    lib.rb_destroy.argtypes = [ctypes.c_void_p]
    lib.rb_size.restype = ctypes.c_uint64
    lib.rb_size.argtypes = [ctypes.c_void_p]
    lib.rb_add.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint64
    ]
    lib.rb_sample.restype = ctypes.c_int
    lib.rb_sample.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint64
    ]
    lib.rb_gather.restype = ctypes.c_int
    lib.rb_gather.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
    ]
    lib._rb_configured = True
    return lib


class HostRingBuffer:
    """schema: {field_name: (shape, dtype)} per single item."""

    def __init__(
        self,
        schema: Dict[str, Tuple[Tuple[int, ...], np.dtype]],
        capacity: int,
        seed: int = 0,
        force_numpy: bool = False,
    ):
        self.schema = {
            k: (tuple(shape), np.dtype(dt)) for k, (shape, dt) in schema.items()
        }
        self.capacity = int(capacity)
        self.fields = list(self.schema)
        self._lib = None if force_numpy else _get_lib()
        if self._lib is not None:
            item_bytes = (ctypes.c_uint64 * len(self.fields))(
                *[
                    int(np.prod(self.schema[f][0]) or 1) * self.schema[f][1].itemsize
                    for f in self.fields
                ]
            )
            self._handle = self._lib.rb_create(
                self.capacity, len(self.fields), item_bytes, seed
            )
            self.backend = "native"
        else:
            self._np_data = {
                f: np.zeros((self.capacity,) + shape, dtype=dt)
                for f, (shape, dt) in self.schema.items()
            }
            self._cursor = 0
            self._size = 0
            self._rng = np.random.default_rng(seed)
            self.backend = "numpy"

    # ------------------------------------------------------------------ api
    def __len__(self) -> int:
        if self._lib is not None:
            return int(self._lib.rb_size(self._handle))
        return self._size

    def add(self, items: Dict[str, np.ndarray]) -> None:
        """items: each field either a single item [*shape] or a batch
        [B, *shape]."""
        first = items[self.fields[0]]
        shape0 = self.schema[self.fields[0]][0]
        batched = first.ndim == len(shape0) + 1
        n = first.shape[0] if batched else 1
        arrs = []
        for f in self.fields:
            shape, dt = self.schema[f]
            a = np.asarray(items[f], dtype=dt)
            want = (n,) + shape if batched else shape
            assert a.shape == want, f"{f}: {a.shape} != {want}"
            # note: reshape keeps 0-d fields 0-d where ascontiguousarray
            # would promote them to 1-d
            arrs.append(np.ascontiguousarray(a.reshape(want or (1,))).reshape(want))
        if self._lib is not None:
            ptrs = (ctypes.c_void_p * len(arrs))(
                *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrs]
            )
            self._lib.rb_add(self._handle, ptrs, n)
        else:
            idx = (self._cursor + np.arange(n)) % self.capacity
            for f, a in zip(self.fields, arrs):
                self._np_data[f][idx] = a if batched else a[None]
            self._cursor = (self._cursor + n) % self.capacity
            self._size = min(self._size + n, self.capacity)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        out = {
            f: np.empty((batch_size,) + shape, dtype=dt)
            for f, (shape, dt) in self.schema.items()
        }
        if self._lib is not None:
            ptrs = (ctypes.c_void_p * len(self.fields))(
                *[out[f].ctypes.data_as(ctypes.c_void_p).value for f in self.fields]
            )
            rc = self._lib.rb_sample(self._handle, ptrs, batch_size)
            if rc != 0:
                raise RuntimeError("sample from empty buffer")
        else:
            if self._size == 0:
                raise RuntimeError("sample from empty buffer")
            idx = self._rng.integers(0, self._size, size=batch_size)
            for f in self.fields:
                out[f] = self._np_data[f][idx]
        return out

    def gather(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        indices = np.ascontiguousarray(indices, dtype=np.uint64)
        b = len(indices)
        out = {
            f: np.empty((b,) + shape, dtype=dt)
            for f, (shape, dt) in self.schema.items()
        }
        if self._lib is not None:
            ptrs = (ctypes.c_void_p * len(self.fields))(
                *[out[f].ctypes.data_as(ctypes.c_void_p).value for f in self.fields]
            )
            rc = self._lib.rb_gather(
                self._handle, ptrs,
                indices.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), b,
            )
            if rc != 0:
                raise IndexError(f"rb_gather failed rc={rc}")
        else:
            for f in self.fields:
                out[f] = self._np_data[f][indices.astype(np.int64)]
        return out

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None and getattr(self, "_handle", None):
            lib.rb_destroy(self._handle)
            self._handle = None
