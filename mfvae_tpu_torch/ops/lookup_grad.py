"""K4: the backward of the MAVAE's embedding lookups by position, a
hand-written CUDA kernel beside its plain PyTorch version.

Two lookups of ``models/layers.py`` read a parameter table at positions
that a column of the output fixes:

- ``Embedding.at``, the agent-index embedding of ``MAVAE.encode`` when no
  ids come from the data: the group's S agent positions, the same rows of
  an [R, F] table for every batch row (fixed positions);
- ``StackedEmbedding.forward``, the discrete action embeddings: row
  ``idx[b, s]`` of column s's own table of K rows, an [S, K, F] table
  (per-column bins).

Their forward is the gather of before.  Their backward, through advanced
indexing, was ``index_put_(accumulate=True)`` after a sort of the indices,
on an f32 copy of the bf16 gradient: one warp for each distinct table row,
so a few dozen warps, each thousands of rows deep.  K4
(``ops/csrc/lookup_grad.cu``, built at first use by
``utils/kernel_build.py``) writes the f32 table gradient from the gradient
g [B, S, F] in one launch:

- fixed positions: ``out[pos[s]] = Σ_b g[b, s]``, every other row 0;
- per-column bins: ``out[s·K + k] = Σ_b [idx[b, s] = k] · g[b, s]``,
  K ≤ ``MAX_BINS``, idx int32 or int64 as given.

g is read once, in place, in its own type (float32, bfloat16 or float16)
and summed in f32 in a fixed order, with no atomics on values, so two
calls give the same bits.  Bytes bound it: at b4,096 the adversaries'
[4,096, 30, 64] bf16 gradient is 15.7 MB, 4.7 µs at 3.35 TB/s.  The
source's note says what the design does about that.

The autograd Functions hand the kernel a contiguous gradient
(``.contiguous()``, a copy where autograd passes a strided view, as
``torch.cat``'s backward does), and their forwards return the values of
the gather of before and its cast to the compute dtype, the cast fused in
so that the backward reads the compute-dtype gradient as it is.

Routing: a tensor on the CPU takes the plain version; a CUDA tensor
launches K4 or raises.  Each launch adds one to the counter
``k4.launches`` (``utils/profiling.py``) and is the span ``k4`` under a
profiler.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from mfvae_tpu_torch.ops.fused_elbo import FLOAT_TYPES, _check, _on_cuda, _raise_on
from mfvae_tpu_torch.utils import kernel_build, profiling

SOURCE = "lookup_grad.cu"
MAX_BINS = 8  # kMaxBins in lookup_grad.cu: the accumulators a thread keeps per element
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}  # as in lookup_grad.cu
_INDEX_CODE = {torch.int32: 0, torch.int64: 1}
_WARPS = 8  # kWarps in lookup_grad.cu
CHUNKS = 8  # kChunks in lookup_grad.cu: the blocks (one cluster) a column's batch is split over
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = kernel_build.load(SOURCE)
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.mfvae_lookup_grad.argtypes = [
            P, I, P, I, P, ctypes.c_longlong, I, I, I, I, I, I, P, P,
        ]
        lib.mfvae_lookup_grad.restype = I
        _LIB = lib
    return _LIB


def max_features(dtype: torch.dtype) -> int:
    """The widest row K4 takes: one warp's 16-byte loads."""
    return 32 * (16 // dtype.itemsize)


def supports(features: int, bins: int, dtype: torch.dtype) -> bool:
    """Whether K4 takes a table of rows ``features`` wide with ``bins``
    rows a column (1 for fixed positions), read in ``dtype``."""
    return dtype in _DTYPE_CODE and 1 <= bins <= MAX_BINS and 1 <= features <= max_features(dtype)


class LookupGeometry(NamedTuple):
    lanes: int  # lanes reading one row: a power of two >= the row's 16-byte segments
    aligned: bool  # 16-byte loads: rows a whole number of segments, at a 16-byte boundary


def lookup_geometry(features: int, itemsize: int, ptr: int) -> LookupGeometry:
    """How K4 reads rows of ``features`` elements of ``itemsize`` bytes at
    ``ptr``: a block of the grid (columns × ``CHUNKS``) covers
    ``_WARPS · 32 / lanes`` rows at once."""
    pack = 16 // itemsize
    lanes = 1 << (math.ceil(features / pack) - 1).bit_length()
    return LookupGeometry(lanes, features % pack == 0 and ptr % 16 == 0)


# -------------------------------------------------------------- plain version
def _lookup_grad_plain(g, rows: int, pos=None, idx=None, bins: int = 1):
    """K4's result in plain PyTorch: g's rows summed in f32 into the
    table's rows, [rows, F]."""
    f = g.shape[-1]
    g32 = g.to(torch.float32)
    out = torch.zeros(rows, f, dtype=torch.float32, device=g.device)
    if idx is None:
        out[pos] = g32.sum(0)
    else:
        col = torch.arange(g.shape[1], device=g.device)[None, :] * bins
        out.index_add_(0, (col + idx.long()).reshape(-1), g32.reshape(-1, f))
    return out


# --------------------------------------------------------------- kernel call
def _lookup_grad_cuda(g, rows: int, pos=None, idx=None, bins: int = 1):
    batch, cols, features = g.shape
    out = torch.empty(rows, features, device=g.device, dtype=torch.float32)
    geo = lookup_geometry(features, g.element_size(), g.data_ptr())
    lib = _lib()
    with torch.cuda.device(g.device), profiling.span("k4"):
        err = lib.mfvae_lookup_grad(
            g.data_ptr(), _DTYPE_CODE[g.dtype], None if idx is None else idx.data_ptr(),
            -1 if idx is None else _INDEX_CODE[idx.dtype], None if pos is None else pos.data_ptr(),
            batch, cols, features, bins, rows, geo.lanes, int(geo.aligned), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "lookup_grad")
    profiling.count("k4.launches")
    return out


def lookup_grad(g: torch.Tensor, rows: int, pos: Optional[torch.Tensor] = None,
                idx: Optional[torch.Tensor] = None, bins: int = 1) -> torch.Tensor:
    """The f32 table gradient [rows, F] of a lookup whose output gradient is
    g [B, S, F] (float32, bfloat16 or float16, contiguous): with ``pos``
    [S] int64 (distinct rows), fixed positions; with ``idx`` [B, S] int32
    or int64, per-column bins of ``bins`` rows (rows = S · bins)."""
    _check("lookup_grad", g, dtypes=FLOAT_TYPES)
    if g.dim() != 3 or g.shape[1] == 0 or g.shape[2] == 0:
        raise ValueError(f"lookup_grad: expected g [B, S, F] with S, F > 0, got {tuple(g.shape)}")
    batch, cols, features = g.shape
    if (pos is None) == (idx is None):
        raise ValueError("lookup_grad: pass pos (fixed positions) or idx (per-column bins)")
    index = idx if pos is None else pos
    _check("lookup_grad", index, dtypes=(torch.int64,) if idx is None else tuple(_INDEX_CODE))
    if index.device != g.device:
        raise ValueError(f"lookup_grad: tensors on {index.device} and {g.device}")
    if idx is None:
        if tuple(pos.shape) != (cols,) or rows < cols:
            raise ValueError(f"lookup_grad: expected pos [{cols}] within {rows} rows, got {tuple(pos.shape)}")
        bins = 1
    elif tuple(idx.shape) != (batch, cols) or rows != cols * bins:
        raise ValueError(f"lookup_grad: expected idx [{batch}, {cols}] and {cols} x {bins} rows, "
                         f"got {tuple(idx.shape)} and {rows}")
    if not supports(features, bins, g.dtype):
        raise ValueError(f"lookup_grad: K4 takes 1 to {MAX_BINS} bins and rows of at most "
                         f"{max_features(g.dtype)} {g.dtype} elements, got {bins} and {features}")
    if _on_cuda(g):
        return _lookup_grad_cuda(g, rows, pos, idx, bins)
    return _lookup_grad_plain(g, rows, pos, idx, bins)


# ------------------------------------------------------------------ wrappers
class _LookupFixed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, pos, batch, dtype):
        ctx.save_for_backward(pos)
        ctx.rows = table.shape[0]
        return table[pos].to(dtype)[None].expand(batch, -1, -1)

    @staticmethod
    def backward(ctx, g):
        (pos,) = ctx.saved_tensors
        return lookup_grad(g.contiguous(), ctx.rows, pos=pos), None, None, None


class _LookupBins(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, dtype):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        stack = torch.arange(table.shape[0], device=idx.device)
        return table[stack[None, :], idx.long()].to(dtype)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        cols, bins, features = ctx.table_shape
        grad = lookup_grad(g.contiguous(), cols * bins, idx=idx.contiguous(), bins=bins)
        return grad.view(cols, bins, features), None, None


def lookup_fixed(table: torch.Tensor, pos: torch.Tensor, batch: int, dtype: torch.dtype) -> torch.Tensor:
    """``table[pos]`` [S, F] in ``dtype`` for each of ``batch`` rows, [batch,
    S, F] (a broadcast view), for distinct int64 positions ``pos`` [S];
    its gradient into ``table`` is K4's fixed positions."""
    return _LookupFixed.apply(table, pos, batch, dtype)


def lookup_bins(table: torch.Tensor, idx: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``table[s, idx[b, s]]`` in ``dtype``, [B, S, F], for per-column
    tables [S, K, F] and integer ``idx`` [B, S]; its gradient into
    ``table`` is K4's per-column bins."""
    return _LookupBins.apply(table, idx, dtype)
