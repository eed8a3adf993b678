"""Hand-written CUDA kernels for the ELBO elementwise tail, each beside its
plain PyTorch version.

Four kernels, in ``ops/csrc/fused_elbo.cu`` (built at first use by
``utils/kernel_build.py``):

- K1 ``reparam_kl_fwd`` replaces ``mfvae_tpu/ops/fused_elbo.py``
  ``_fwd_kernel``: ``z = mu + eps·exp(0.5·lv)`` and the per-row KL
  ``-0.5·Σ_f(1 + lv - mu² - e^lv)``.
- K2 ``reparam_kl_bwd`` replaces ``_bwd_kernel``: ``dmu = gz + gkl·mu``,
  ``dlv = 0.5·gz·eps·std - 0.5·gkl·(1 - e^lv)``; eps gets no gradient.
- K3 ``huber_mean`` replaces ``_huber_kernel`` (:164, launched by
  ``_huber_impl`` :184): ``mean(0.5q² + δ(|d| - q))`` with ``d = x - y``,
  ``q = min(|d|, δ)``, accumulated in f32.
- K3w ``huber_rows_wsum``, with no TPU counterpart: the unroll step's
  masked, pooled huber terms (``training/unroll.py``), ``Σ_r w_r ·
  mean_d huber(x_rd - y_rd)`` over rows [R, D] with f32 row weights [R].
  K3 takes an unweighted mean over all elements, so it cannot mask a
  slot.

All four move a few bytes per flop, so device-memory bytes bound them: at
the main path's [128·40, 64] latents K1 moves 5.3 MB, K2 7.9 MB and the
state-branch K3 5.8 MB, 1.6-2.4 µs at 3.35 TB/s.  The kernels read each
input once and write each output once.  K1 and K2 give a warp to each row,
so the per-row KL and the per-row ``gkl`` never leave registers.

K3 is one launch per call.  Hopper's blocks, unlike a TPU's sequential
grid, cannot carry one running sum, so each block writes a partial to a
workspace and the block that arrives last sums the partials in a fixed
order: deterministic, with no second launch.  It reads x and y in place in
their own type (f32, bf16 or f16) with 16-byte loads, on a grid sized to n
and capped at one wave (``huber_geometry``); a small n takes one block.
The workspace (an arrival counter, 0 between calls, and the partials) is
allocated once per (device, stream) and reused: kernels on one stream run
in order, so one call's last block has reset the counter before the next
call's blocks start, and two streams get two workspaces.

K3w is K3's launch with each element weighted by its row's weight: the
flat sum of ``w[row]·huber`` divided by D at the end, on K3's geometry and
K3's workspace (one stream's K3 and K3w calls run in order, so they share
it).  A 16-byte pack may straddle two rows, so packs need D at least the
pack's width; narrower rows are read one element at a time.  Its
backward is plain, as K3's: ``g·w_r/D·clamp(x - y, -δ, δ)``, and the
weights get no gradient.

Dtypes follow the JAX functions: the wrappers take float32, bfloat16 or
float16.  ``fused_reparam_kl`` casts its inputs to f32 before K1, as
``_fused_fwd_impl`` does, and returns dmu and dlv in mu's and logvar's
types.  ``huber_mean`` (and ``huber_rows_wsum``) hands x and y of one type to
the kernel as they are, casts both to f32 where their types differ, and
returns each gradient in its input's type, as ``_huber_bwd`` does.

Routing: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel or raises.  Each launch adds one to the counter
``k1.launches``, ``k2.launches``, ``k3.launches`` or ``k3w.launches``
(``utils/profiling.py`` ``count``); under a profiler each launch is the
span ``k1``, ``k2``, ``k3`` or ``k3w``.

Under ``train.debug_nans`` (``utils/debug_nans.py``) the wrappers hand
each kernel's outputs, or its plain version's, to the check set by
``set_nan_check``; with no check set they read nothing back.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple

import torch

from mfvae_tpu_torch.utils import kernel_build, profiling

SOURCE = "fused_elbo.cu"
_HUBER_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}  # as in fused_elbo.cu
FLOAT_TYPES = tuple(_HUBER_DTYPE_CODE)  # what the wrappers take, as the JAX functions do
_HUBER_THREADS = 256
_HUBER_BLOCKS_PER_SM = 4  # kHuberBlocksPerSm in fused_elbo.cu
_HUBER_LOADS = 2  # kHuberLoads in fused_elbo.cu: 16-byte loads per tensor per thread a pass
# n at or below which K3 runs as one block, with no workspace and no atomic.
# On the H100 one block beat the grid at n = 8,192 and lost at 12,288 (PERF.md).
HUBER_SINGLE_BLOCK_MAX = 8192
_LIB = None
_HUBER_WORKSPACES: dict = {}  # (device index, stream handle) -> int32 tensor
_NAN_CHECK = None  # (where, *outputs) -> None, raising on a NaN; None: off


def set_nan_check(check) -> None:
    """Install ``check(where, *outputs)`` on K1-K3w's outputs (None: off)."""
    global _NAN_CHECK
    _NAN_CHECK = check


def _nan_check(kernel: str, on_cuda: bool, *outputs) -> None:
    if _NAN_CHECK is not None:
        _NAN_CHECK(f"{kernel} ({'kernel' if on_cuda else 'plain version'})", *outputs)


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = kernel_build.load(SOURCE)
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.mfvae_reparam_kl_fwd.argtypes = [P, P, P, P, P, I, I, I, P]
        lib.mfvae_reparam_kl_fwd.restype = I
        lib.mfvae_reparam_kl_bwd.argtypes = [P, P, P, P, P, P, P, I, I, I, P]
        lib.mfvae_reparam_kl_bwd.restype = I
        lib.mfvae_huber_mean_onepass.argtypes = [
            P, P, I, ctypes.c_float, ctypes.c_longlong, I, I, I, P, P, P,
        ]
        lib.mfvae_huber_mean_onepass.restype = I
        lib.mfvae_huber_rows_wsum.argtypes = [
            P, P, P, I, ctypes.c_float, ctypes.c_longlong, ctypes.c_longlong, I, I, I, P, P, P,
        ]
        lib.mfvae_huber_rows_wsum.restype = I
        _LIB = lib
    return _LIB


def _on_cuda(t: torch.Tensor) -> bool:
    """True: launch the kernel; False: take the plain version (CPU)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")


def _check(name: str, *tensors: torch.Tensor, dtypes=(torch.float32,)) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: expected one of {dtypes}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _vec(f: int, *tensors: torch.Tensor) -> int:
    """float2 loads where the row width and every pointer allow them."""
    if f % 2 == 0 and all(t.data_ptr() % 8 == 0 for t in tensors):
        return 2
    return 1


class HuberGeometry(NamedTuple):
    vec: int  # elements per load: 16 bytes' worth, or 1
    head: int  # elements taken one at a time before the first aligned pack
    blocks: int


def huber_geometry(
    x_ptr: int, y_ptr: int, n: int, itemsize: int, max_blocks: int,
    single_block_max: int = HUBER_SINGLE_BLOCK_MAX, row: int = 0,
) -> HuberGeometry:
    """K3's launch geometry for n elements of ``itemsize`` bytes at the
    given addresses.  16-byte loads need x and y at the same offset from a
    16-byte boundary; the head up to that boundary and the tail past the
    last whole pack are read one element at a time.  Each thread takes
    ``_HUBER_LOADS`` loads per tensor a pass, so a block covers
    ``_HUBER_LOADS``·256·vec elements a pass; the grid covers n in one pass,
    capped at ``max_blocks`` (one wave).
    Up to ``single_block_max`` elements, one block does it all.  K3w gives
    its ``row`` width: a pack there may span at most two rows, so 16-byte
    loads need rows at least a pack wide."""
    pack = 16 // itemsize
    vec, head = 1, 0
    if n >= pack and x_ptr % 16 == y_ptr % 16 and (row == 0 or row >= pack):
        vec, head = pack, (-x_ptr) % 16 // itemsize
    if n <= single_block_max:
        return HuberGeometry(vec, head, 1)
    blocks = min(math.ceil(n / (_HUBER_LOADS * _HUBER_THREADS * vec)), max_blocks)
    return HuberGeometry(vec, head, blocks)


# ------------------------------------------------------------- plain versions
def _fwd_rows_plain(mu, lv, eps) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's arithmetic on [rows, F], in the kernel's operation order."""
    std = torch.exp(0.5 * lv)
    z = mu + eps * std
    elv = std * std
    kl = (-0.5 * (1.0 + lv - mu * mu - elv)).sum(dim=-1)
    return z, kl


def _bwd_rows_plain(mu, lv, eps, gz, gkl) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's arithmetic on [rows, F] with gkl [rows]."""
    std = torch.exp(0.5 * lv)
    elv = std * std
    g = gkl[:, None]
    dmu = gz + g * mu
    dlv = gz * 0.5 * eps * std + g * -0.5 * (1.0 - elv)
    return dmu, dlv


def _fused_reparam_kl_plain(mu, logvar, eps):
    """The whole of ``fused_reparam_kl`` in plain differentiable torch ops;
    its autograd is the reference for K2."""
    f = mu.shape[-1]
    z, kl = _fwd_rows_plain(mu.reshape(-1, f), logvar.reshape(-1, f), eps.reshape(-1, f))
    return z.reshape(mu.shape), kl.reshape(mu.shape[:-1])


def _huber_mean_plain(x, y, delta: float = 1.0):
    """K3's arithmetic: x and y cast to f32 before the difference, as the
    TPU kernel's body does."""
    d = torch.abs(x.to(torch.float32) - y.to(torch.float32))
    q = torch.clamp(d, max=delta)
    return (0.5 * q * q + delta * (d - q)).sum() / x.numel()


def _huber_rows_wsum_plain(x, y, w, delta: float = 1.0):
    """K3w's arithmetic: each row's mean huber in f32 (x and y cast to f32
    before the difference), weighted and summed."""
    d = torch.abs(x.to(torch.float32) - y.to(torch.float32))
    q = torch.clamp(d, max=delta)
    return torch.sum(torch.mean(0.5 * q * q + delta * (d - q), dim=-1) * w)


# -------------------------------------------------------------- kernel calls
def _reparam_kl_fwd_cuda(mu, lv, eps):
    _check("reparam_kl_fwd", mu, lv, eps)
    rows, f = mu.shape
    z = torch.empty_like(mu)
    kl = torch.empty(rows, device=mu.device, dtype=torch.float32)
    if rows:
        lib = _lib()
        with torch.cuda.device(mu.device), profiling.span("k1"):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.mfvae_reparam_kl_fwd(
                mu.data_ptr(), lv.data_ptr(), eps.data_ptr(), z.data_ptr(),
                kl.data_ptr(), rows, f, _vec(f, mu, lv, eps, z), stream,
            )
        _raise_on(err, "reparam_kl_fwd")
        profiling.count("k1.launches")
    return z, kl


def _reparam_kl_bwd_cuda(mu, lv, eps, gz, gkl):
    _check("reparam_kl_bwd", mu, lv, eps, gz, gkl)
    rows, f = mu.shape
    dmu = torch.empty_like(mu)
    dlv = torch.empty_like(mu)
    if rows:
        lib = _lib()
        with torch.cuda.device(mu.device), profiling.span("k2"):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.mfvae_reparam_kl_bwd(
                mu.data_ptr(), lv.data_ptr(), eps.data_ptr(), gz.data_ptr(),
                gkl.data_ptr(), dmu.data_ptr(), dlv.data_ptr(), rows, f,
                _vec(f, mu, lv, eps, gz, dmu, dlv), stream,
            )
        _raise_on(err, "reparam_kl_bwd")
        profiling.count("k2.launches")
    return dmu, dlv


def _huber_workspace(stream: int) -> torch.Tensor:
    """The arrival counter and one partial per block of the widest grid,
    for the current device and ``stream``; zeroed once, then reset by each
    launch's last block."""
    key = (torch.cuda.current_device(), stream)
    ws = _HUBER_WORKSPACES.get(key)
    if ws is None:
        sms = torch.cuda.get_device_properties(key[0]).multi_processor_count
        ws = torch.zeros(1 + _HUBER_BLOCKS_PER_SM * sms, dtype=torch.int32, device="cuda")
        ws = _HUBER_WORKSPACES.setdefault(key, ws)
    return ws


def _huber_mean_cuda(x, y, delta: float, single_block_max: int = HUBER_SINGLE_BLOCK_MAX):
    _check("huber_mean", x, y, dtypes=FLOAT_TYPES)
    if x.dtype != y.dtype:
        raise TypeError(f"huber_mean: K3 reads one type, got {x.dtype} and {y.dtype}")
    n = x.numel()
    out = torch.empty((), device=x.device, dtype=torch.float32)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        ws = _huber_workspace(stream)
        geo = huber_geometry(
            x.data_ptr(), y.data_ptr(), n, x.element_size(), ws.numel() - 1, single_block_max
        )
        with profiling.span("k3"):
            err = lib.mfvae_huber_mean_onepass(
                x.data_ptr(), y.data_ptr(), _HUBER_DTYPE_CODE[x.dtype], float(delta), n,
                geo.vec, geo.head, geo.blocks, ws.data_ptr(), out.data_ptr(), stream,
            )
    _raise_on(err, "huber_mean")
    profiling.count("k3.launches")
    return out


def _huber_rows_wsum_cuda(x, y, w, delta: float, single_block_max: int = HUBER_SINGLE_BLOCK_MAX):
    _check("huber_rows_wsum", x, y, dtypes=FLOAT_TYPES)
    _check("huber_rows_wsum", w)
    if x.dtype != y.dtype:
        raise TypeError(f"huber_rows_wsum: K3w reads one type, got {x.dtype} and {y.dtype}")
    rows, d = x.shape
    out = torch.empty((), device=x.device, dtype=torch.float32)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        ws = _huber_workspace(stream)
        geo = huber_geometry(x.data_ptr(), y.data_ptr(), rows * d, x.element_size(), ws.numel() - 1,
                             single_block_max, row=d)
        with profiling.span("k3w"):
            err = lib.mfvae_huber_rows_wsum(
                x.data_ptr(), y.data_ptr(), w.data_ptr(), _HUBER_DTYPE_CODE[x.dtype], float(delta),
                rows * d, d, geo.vec, geo.head, geo.blocks, ws.data_ptr(), out.data_ptr(), stream,
            )
    _raise_on(err, "huber_rows_wsum")
    profiling.count("k3w.launches")
    return out


# ------------------------------------------------------------------ wrappers
class _FusedReparamKL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mu, logvar, eps):
        f = mu.shape[-1]
        args = (mu.reshape(-1, f), logvar.reshape(-1, f), eps.reshape(-1, f))
        cuda = _on_cuda(mu)
        z, kl = _reparam_kl_fwd_cuda(*args) if cuda else _fwd_rows_plain(*args)
        _nan_check("K1 reparam_kl_fwd", cuda, z, kl)
        ctx.save_for_backward(mu, logvar, eps)
        return z.reshape(mu.shape), kl.reshape(mu.shape[:-1])

    @staticmethod
    def backward(ctx, gz, gkl):
        mu, logvar, eps = ctx.saved_tensors
        f = mu.shape[-1]
        # autograd hands in broadcast (stride-0) gradients; the kernel reads
        # dense rows
        args = (
            mu.reshape(-1, f), logvar.reshape(-1, f), eps.reshape(-1, f),
            gz.contiguous().reshape(-1, f), gkl.contiguous().reshape(-1),
        )
        cuda = _on_cuda(mu)
        dmu, dlv = _reparam_kl_bwd_cuda(*args) if cuda else _bwd_rows_plain(*args)
        _nan_check("K2 reparam_kl_bwd", cuda, dmu, dlv)
        return dmu.reshape(mu.shape), dlv.reshape(mu.shape), None


def fused_reparam_kl(mu: torch.Tensor, logvar: torch.Tensor, eps: torch.Tensor):
    """(z [..., F], kl_row [...]), both float32, for latents [..., F] in
    float32, bfloat16 or float16, cast to f32 first:
    ``z = mu + eps·exp(0.5·logvar)``,
    ``kl_row = -0.5·Σ_F(1 + logvar - mu² - e^logvar)``.
    Differentiable in mu and logvar (K2), each gradient in its input's
    type; eps gets no gradient."""
    _check("fused_reparam_kl", mu, logvar, eps, dtypes=FLOAT_TYPES)
    if not (mu.shape == logvar.shape == eps.shape):
        raise ValueError(
            f"fused_reparam_kl: shapes differ {tuple(mu.shape)}, "
            f"{tuple(logvar.shape)}, {tuple(eps.shape)}"
        )
    if mu.dim() < 1 or mu.shape[-1] == 0:
        raise ValueError("fused_reparam_kl: needs a non-empty last axis")
    # autograd's cast back hands dmu and dlv over in mu's and logvar's types
    f32 = torch.float32
    return _FusedReparamKL.apply(mu.to(f32), logvar.to(f32), eps.to(f32))


class _HuberMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, delta):
        ctx.save_for_backward(x, y)
        ctx.delta = delta
        cuda = _on_cuda(x)
        out = _huber_mean_cuda(x, y, delta) if cuda else _huber_mean_plain(x, y, delta)
        _nan_check("K3 huber_mean", cuda, out)
        return out

    @staticmethod
    def backward(ctx, g):
        # the TPU path's backward (_huber_bwd) is plain jnp too: f32, then
        # one rounding to each input's type
        x, y = ctx.saved_tensors
        d = x.to(torch.float32) - y.to(torch.float32)
        grad = torch.clamp(d, -ctx.delta, ctx.delta) * (g / x.numel())
        return grad.to(x.dtype), (-grad).to(y.dtype), None


def huber_mean(x: torch.Tensor, y: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """mean over all elements of huber(x - y) with threshold ``delta``, as a
    float32 scalar, for x and y in float32, bfloat16 or float16 (computed
    in f32).  The gradients come back in x's and y's types."""
    _check("huber_mean", x, y, dtypes=FLOAT_TYPES)
    if x.shape != y.shape:
        raise ValueError(
            f"huber_mean: shapes differ {tuple(x.shape)} vs {tuple(y.shape)}"
        )
    if x.numel() == 0:
        raise ValueError("huber_mean: empty input")
    if x.dtype != y.dtype:
        x, y = x.to(torch.float32), y.to(torch.float32)
    return _HuberMean.apply(x, y, float(delta))


class _HuberRowsWSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, w, delta):
        ctx.save_for_backward(x, y, w)
        ctx.delta = delta
        cuda = _on_cuda(x)
        out = _huber_rows_wsum_cuda(x, y, w, delta) if cuda else _huber_rows_wsum_plain(x, y, w, delta)
        _nan_check("K3w huber_rows_wsum", cuda, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, y, w = ctx.saved_tensors
        d = x.to(torch.float32) - y.to(torch.float32)
        grad = torch.clamp(d, -ctx.delta, ctx.delta) * ((g * w) / x.shape[1])[:, None]
        return grad.to(x.dtype), (-grad).to(y.dtype), None, None


def huber_rows_wsum(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """``Σ_r w_r · mean_d huber(x_rd - y_rd)`` with threshold ``delta``, as a
    float32 scalar, for rows x and y [R, D] in float32, bfloat16 or float16
    (computed in f32) and row weights w [R] in float32.  The gradients come
    back in x's and y's types; w gets none."""
    _check("huber_rows_wsum", x, y, dtypes=FLOAT_TYPES)
    _check("huber_rows_wsum", w)
    if w.device != x.device:
        raise ValueError(f"huber_rows_wsum: tensors on {w.device} and {x.device}")
    if x.dim() != 2 or x.shape != y.shape or tuple(w.shape) != (x.shape[0],):
        raise ValueError(
            f"huber_rows_wsum: expected x, y [R, D] and w [R], got {tuple(x.shape)}, "
            f"{tuple(y.shape)}, {tuple(w.shape)}"
        )
    if x.numel() == 0:
        raise ValueError("huber_rows_wsum: empty input")
    if x.dtype != y.dtype:
        x, y = x.to(torch.float32), y.to(torch.float32)
    return _HuberRowsWSum.apply(x, y, w, float(delta))
