"""K5: flax's LayerNorm over the last axis, forward and backward, as
hand-written CUDA kernels beside its plain PyTorch version.

``models/layers.py``'s ``LayerNorm`` computes flax's ``nn.LayerNorm``:
statistics in f32 with the fast variance ``E[x²] − E[x]²`` clamped at 0,
epsilon 1e-6, and ``(x − mean)·(rsqrt(var + eps)·scale) + bias`` stored in
the layer's compute dtype.  Written as eager ops (``_layer_norm_plain``,
the plain version) that is 14 kernels forward and about 25 in autograd's
backward, each a pass over [rows, D] in f32; the world model's decoders run
12 of them a forward (``ln0``-``ln4`` and ``ln_out`` of each MLP), two over
the 15,900-wide decoder input.  K5 (``ops/csrc/layer_norm.cu``, built at
first use by ``utils/kernel_build.py``) is one launch forward and two
backward:

- forward: x read once in the type it arrives in (f32, or the layer's
  bf16 / f16), y written once in the layer's type, and the rows' (mean,
  rstd) saved for the backward (none under ``torch.no_grad()``);
- backward: x and g read once, dx written once in x's type; dscale and
  dbias (f32) as per-block partial sums over fixed row ranges, then a
  second launch that sums them in block order.  No atomics: two calls give
  the same bits.

Bytes bound it: at b4,096 the ``ln0`` input [4,096, 15,900] bf16 is 130 MB,
so a forward moves 260 MB (78 µs at 3.35 TB/s) and a backward 391 MB.  The
source's note says what the design does about that and how the source
fits its launch to a row's width, the pointers and the card: the fewest
threads that hold the row, 64 bytes a thread (a warp for 1,024 bf16
values, the whole 512-thread block at 15,900), with 8- or 16-byte
accesses where the width and the pointers allow them.

The kernel's backward formula is stated in plain PyTorch as
``_layer_norm_bwd_plain`` (from the saved statistics of
``_layer_norm_stats_plain``), which the tests hold against autograd
through the plain version and the kernel against.

Routing: a tensor on the CPU takes the plain version (the same ops as
before, autograd and all); a CUDA tensor launches K5 or raises.  Any
leading shape is flattened to rows (a non-contiguous input, such as the
fused trunk's expanded [B, 2, D], is copied first).  An input of another
type than f32 or the layer's own is cast to f32 first, the plain version's
first op.  Each forward launch and each backward call adds one to the
counter ``k5.launches`` (``utils/profiling.py``) and is the span ``k5``
under a profiler.  K5 launches on the current stream, allocates through
``torch.empty`` and never synchronises, so a CUDA graph can capture it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from mfvae_tpu_torch.ops.fused_elbo import FLOAT_TYPES, _check, _on_cuda, _raise_on
from mfvae_tpu_torch.utils import kernel_build, profiling

SOURCE = "layer_norm.cu"
EPSILON = 1e-6  # flax's; kEps in layer_norm.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}  # as in layer_norm.cu
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = kernel_build.load(SOURCE)
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mfvae_layer_norm_fwd.argtypes = [P, I, I, P, P, L, I, P, P, P]
        lib.mfvae_layer_norm_bwd_blocks.argtypes = [I, L, I, ctypes.POINTER(I)]
        lib.mfvae_layer_norm_bwd.argtypes = [P, I, P, I, P, P, L, I, P, P, P, P, P]
        lib.mfvae_layer_norm_geometry.argtypes = [P, I, P, I, P, L, I, ctypes.POINTER(L)]
        for f in (lib.mfvae_layer_norm_fwd, lib.mfvae_layer_norm_bwd_blocks, lib.mfvae_layer_norm_bwd,
                  lib.mfvae_layer_norm_geometry):
            f.restype = I
        _LIB = lib
    return _LIB


def _geometry(x: torch.Tensor, other: torch.Tensor, scale: torch.Tensor) -> Tuple[int, int, int, int]:
    """(vec, team, blocks, rows a block): how layer_norm.cu launches K5 on
    rows x [rows, D] beside the rows ``other`` (y or g) and ``scale`` on
    this card: the values an access, the threads that hold a row, and the
    backward's blocks and rows a block."""
    rows, d = x.shape
    out = (ctypes.c_longlong * 4)()
    with torch.cuda.device(x.device):
        err = _lib().mfvae_layer_norm_geometry(x.data_ptr(), _DTYPE_CODE[x.dtype], other.data_ptr(),
                                               _DTYPE_CODE[other.dtype], scale.data_ptr(), rows, d, out)
    _raise_on(err, "layer_norm (geometry)")
    return tuple(out)


# ------------------------------------------------------------- plain version
def _layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax's LayerNorm as eager ops: the route of every CPU tensor and of
    a ``LayerNorm`` built without ``kernels``."""
    x = x.to(torch.float32)
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.clamp(torch.mean(x * x, dim=-1, keepdim=True) - mean * mean, min=0.0)
    y = (x - mean) * (torch.rsqrt(var + EPSILON) * scale)
    return (y + bias).to(dtype)


def _layer_norm_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """The [rows, 2] statistics K5's forward saves for rows x [rows, D]:
    (mean, rstd), rstd negated where the clamp engaged (E[x²] − mean² < 0).
    In f32, or in float64 for a float64 x."""
    x = x.to(torch.float64 if x.dtype == torch.float64 else torch.float32)
    mean = torch.mean(x, dim=-1)
    raw = torch.mean(x * x, dim=-1) - mean * mean
    rstd = torch.rsqrt(torch.clamp(raw, min=0.0) + EPSILON)
    return torch.stack([mean, torch.where(raw < 0, -rstd, rstd)], dim=-1)


def _layer_norm_bwd_plain(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
                          stats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5's backward in plain PyTorch, for rows x [rows, D] and the output
    gradient g [rows, D]: (dx in x's type, dscale, dbias), with gh = g·scale
    and xhat = (x − mean)·rstd,

        dx = rstd·(gh − E[gh] − xhat·E[gh·xhat]),  the last term 0 where the clamp engaged,
        dscale = Σ_rows g·xhat,  dbias = Σ_rows g.

    In f32, or in float64 for a float64 x."""
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf, gf = x.to(ct), g.to(ct)
    mean, signed_rstd = stats[:, :1].to(ct), stats[:, 1:].to(ct)
    rstd = signed_rstd.abs()
    xhat = (xf - mean) * rstd
    gh = gf * scale.to(ct)
    ma = gh.mean(-1, keepdim=True)
    mb = torch.where(signed_rstd > 0, (gh * xhat).mean(-1, keepdim=True), torch.zeros_like(ma))
    dx = rstd * (gh - ma - xhat * mb)
    return dx.to(x.dtype), (gf * xhat).sum(0), gf.sum(0)


# -------------------------------------------------------------- kernel calls
def _layer_norm_fwd_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype,
                         save: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """y [rows, D] in ``dtype`` and, with ``save``, the [rows, 2] stats
    (else None), for contiguous rows x [rows, D]."""
    rows, d = x.shape
    y = torch.empty(rows, d, device=x.device, dtype=dtype)
    stats = torch.empty(rows, 2, device=x.device, dtype=torch.float32) if save else None
    if rows == 0:
        return y, stats
    lib = _lib()
    with torch.cuda.device(x.device), profiling.span("k5"):
        err = lib.mfvae_layer_norm_fwd(
            x.data_ptr(), _DTYPE_CODE[x.dtype], _DTYPE_CODE[dtype], scale.data_ptr(), bias.data_ptr(),
            rows, d, y.data_ptr(), None if stats is None else stats.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "layer_norm (forward)")
    profiling.count("k5.launches")
    return y, stats


def _layer_norm_bwd_cuda(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
                         stats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx in x's type, dscale, dbias) for contiguous rows x and g [rows, D]
    and the forward's stats."""
    rows, d = x.shape
    dx = torch.empty_like(x)
    dscale = torch.empty(d, device=x.device, dtype=torch.float32)
    dbias = torch.empty(d, device=x.device, dtype=torch.float32)
    if rows == 0:
        return dx, dscale.zero_(), dbias.zero_()
    lib = _lib()
    blocks = ctypes.c_int()
    with torch.cuda.device(x.device), profiling.span("k5"):
        err = lib.mfvae_layer_norm_bwd_blocks(_DTYPE_CODE[x.dtype], rows, d, ctypes.byref(blocks))
        if not err:
            part = torch.empty(blocks.value, 2, d, device=x.device, dtype=torch.float32)
            err = lib.mfvae_layer_norm_bwd(
                x.data_ptr(), _DTYPE_CODE[x.dtype], g.data_ptr(), _DTYPE_CODE[g.dtype], scale.data_ptr(),
                stats.data_ptr(), rows, d, dx.data_ptr(), part.data_ptr(), dscale.data_ptr(), dbias.data_ptr(),
                torch.cuda.current_stream().cuda_stream,
            )
    _raise_on(err, "layer_norm (backward)")
    profiling.count("k5.launches")
    return dx, dscale, dbias


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, dtype):
        y, stats = _layer_norm_fwd_cuda(x, scale, bias, dtype, save=True)
        ctx.save_for_backward(x, scale, stats)
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, stats = ctx.saved_tensors
        dx, dscale, dbias = _layer_norm_bwd_cuda(x, g.contiguous(), scale, stats)
        return dx, dscale, dbias, None


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax's LayerNorm of x [..., D] with f32 ``scale`` and ``bias`` [D],
    in ``dtype`` (float32, bfloat16 or float16): K5 on a CUDA tensor, the
    plain version on a CPU one."""
    if not _on_cuda(x):
        return _layer_norm_plain(x, scale, bias, dtype)
    if dtype not in FLOAT_TYPES:
        raise TypeError(f"layer_norm: the output type must be one of {FLOAT_TYPES}, got {dtype}")
    _check("layer_norm", scale, bias)
    d = x.shape[-1] if x.dim() else 0
    if d == 0 or tuple(scale.shape) != (d,) or tuple(bias.shape) != (d,):
        raise ValueError(f"layer_norm: expected x [..., D] with D > 0 and scale, bias [D], got "
                         f"{tuple(x.shape)}, {tuple(scale.shape)}, {tuple(bias.shape)}")
    if scale.device != x.device:
        raise ValueError(f"layer_norm: tensors on {scale.device} and {x.device}")
    if x.dtype not in (torch.float32, dtype):
        x = x.to(torch.float32)
    shape = x.shape
    rows = x.reshape(-1, d).contiguous()
    if torch.is_grad_enabled() and (rows.requires_grad or scale.requires_grad or bias.requires_grad):
        y = _LayerNorm.apply(rows, scale, bias, dtype)
    else:
        y, _ = _layer_norm_fwd_cuda(rows, scale, bias, dtype, save=False)
    return y.view(shape)
