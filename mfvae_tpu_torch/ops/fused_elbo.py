"""Hand-written CUDA kernels for the ELBO elementwise tail, each beside its
plain PyTorch version.

Three kernels, in ``ops/csrc/fused_elbo.cu`` (built at first use by
``utils/kernel_build.py``):

- K1 ``reparam_kl_fwd`` replaces ``mfvae_tpu/ops/fused_elbo.py``
  ``_fwd_kernel``: ``z = mu + eps·exp(0.5·lv)`` and the per-row KL
  ``-0.5·Σ_f(1 + lv - mu² - e^lv)``.
- K2 ``reparam_kl_bwd`` replaces ``_bwd_kernel``: ``dmu = gz + gkl·mu``,
  ``dlv = 0.5·gz·eps·std - 0.5·gkl·(1 - e^lv)``; eps gets no gradient.
- K3 ``huber_mean`` replaces ``_huber_kernel``: ``mean(0.5q² + δ(|d| - q))``
  with ``d = x - y``, ``q = min(|d|, δ)``.

All three move a few bytes per flop, so device-memory bytes bound them: at
the main path's [128·40, 64] latents K1 moves 5.3 MB, K2 7.9 MB and the
state-branch K3 5.8 MB, 1.6-2.4 µs at 3.35 TB/s.  The kernels read each
input once and write each output once.  K1 and K2 give a warp to each row,
so the per-row KL and the per-row ``gkl`` never leave registers; K3 is a
two-pass reduction (fixed grid of block partials, then one block) because
Hopper's blocks, unlike a TPU's sequential grid, cannot carry one running
sum, and a fixed grid keeps the sum order deterministic.

Routing: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel or raises.  Each launch adds one to ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from mfvae_tpu_torch.utils import kernel_build

SOURCE = "fused_elbo.cu"
LAUNCHES = {"reparam_kl_fwd": 0, "reparam_kl_bwd": 0, "huber_mean": 0}
_HUBER_THREADS = 256
_HUBER_MAX_BLOCKS = 4 * 132  # four blocks per H100 SM
_LIB = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = kernel_build.load(SOURCE)
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.mfvae_reparam_kl_fwd.argtypes = [P, P, P, P, P, I, I, I, P]
        lib.mfvae_reparam_kl_fwd.restype = I
        lib.mfvae_reparam_kl_bwd.argtypes = [P, P, P, P, P, P, P, I, I, I, P]
        lib.mfvae_reparam_kl_bwd.restype = I
        lib.mfvae_huber_mean.argtypes = [
            P, P, ctypes.c_float, ctypes.c_longlong, P, I, P, P,
        ]
        lib.mfvae_huber_mean.restype = I
        _LIB = lib
    return _LIB


def _on_cuda(t: torch.Tensor) -> bool:
    """True: launch the kernel; False: take the plain version (CPU)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")


def _check(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
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
    d = torch.abs(x - y)
    q = torch.clamp(d, max=delta)
    return (0.5 * q * q + delta * (d - q)).sum() / x.numel()


# -------------------------------------------------------------- kernel calls
def _reparam_kl_fwd_cuda(mu, lv, eps):
    _check("reparam_kl_fwd", mu, lv, eps)
    rows, f = mu.shape
    z = torch.empty_like(mu)
    kl = torch.empty(rows, device=mu.device, dtype=torch.float32)
    if rows:
        with torch.cuda.device(mu.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _lib().mfvae_reparam_kl_fwd(
                mu.data_ptr(), lv.data_ptr(), eps.data_ptr(), z.data_ptr(),
                kl.data_ptr(), rows, f, _vec(f, mu, lv, eps, z), stream,
            )
        _raise_on(err, "reparam_kl_fwd")
        LAUNCHES["reparam_kl_fwd"] += 1
    return z, kl


def _reparam_kl_bwd_cuda(mu, lv, eps, gz, gkl):
    _check("reparam_kl_bwd", mu, lv, eps, gz, gkl)
    rows, f = mu.shape
    dmu = torch.empty_like(mu)
    dlv = torch.empty_like(mu)
    if rows:
        with torch.cuda.device(mu.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _lib().mfvae_reparam_kl_bwd(
                mu.data_ptr(), lv.data_ptr(), eps.data_ptr(), gz.data_ptr(),
                gkl.data_ptr(), dmu.data_ptr(), dlv.data_ptr(), rows, f,
                _vec(f, mu, lv, eps, gz, dmu, dlv), stream,
            )
        _raise_on(err, "reparam_kl_bwd")
        LAUNCHES["reparam_kl_bwd"] += 1
    return dmu, dlv


def _huber_mean_cuda(x, y, delta: float):
    _check("huber_mean", x, y)
    n = x.numel()
    nparts = min(math.ceil(n / _HUBER_THREADS), _HUBER_MAX_BLOCKS)
    partials = torch.empty(nparts, device=x.device, dtype=torch.float32)
    out = torch.empty((), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().mfvae_huber_mean(
            x.data_ptr(), y.data_ptr(), float(delta), n, partials.data_ptr(),
            nparts, out.data_ptr(), stream,
        )
    _raise_on(err, "huber_mean")
    LAUNCHES["huber_mean"] += 1
    return out


# ------------------------------------------------------------------ wrappers
class _FusedReparamKL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mu, logvar, eps):
        f = mu.shape[-1]
        args = (mu.reshape(-1, f), logvar.reshape(-1, f), eps.reshape(-1, f))
        z, kl = _reparam_kl_fwd_cuda(*args) if _on_cuda(mu) else _fwd_rows_plain(*args)
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
        dmu, dlv = _reparam_kl_bwd_cuda(*args) if _on_cuda(mu) else _bwd_rows_plain(*args)
        return dmu.reshape(mu.shape), dlv.reshape(mu.shape), None


def fused_reparam_kl(mu: torch.Tensor, logvar: torch.Tensor, eps: torch.Tensor):
    """(z [..., F], kl_row [...]) for float32 latents [..., F]:
    ``z = mu + eps·exp(0.5·logvar)``,
    ``kl_row = -0.5·Σ_F(1 + logvar - mu² - e^logvar)``.
    Differentiable in mu and logvar (K2); eps gets no gradient."""
    _check("fused_reparam_kl", mu, logvar, eps)
    if not (mu.shape == logvar.shape == eps.shape):
        raise ValueError(
            f"fused_reparam_kl: shapes differ {tuple(mu.shape)}, "
            f"{tuple(logvar.shape)}, {tuple(eps.shape)}"
        )
    if mu.dim() < 1 or mu.shape[-1] == 0:
        raise ValueError("fused_reparam_kl: needs a non-empty last axis")
    return _FusedReparamKL.apply(mu, logvar, eps)


class _HuberMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, delta):
        ctx.save_for_backward(x, y)
        ctx.delta = delta
        if _on_cuda(x):
            return _huber_mean_cuda(x, y, delta)
        return _huber_mean_plain(x, y, delta)

    @staticmethod
    def backward(ctx, g):
        # the TPU path's backward (_huber_bwd) is plain jnp too
        x, y = ctx.saved_tensors
        d = x - y
        grad = torch.clamp(d, -ctx.delta, ctx.delta) * (g / x.numel())
        return grad, -grad, None


def huber_mean(x: torch.Tensor, y: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """mean over all elements of huber(x - y) with threshold ``delta``, as a
    float32 scalar."""
    _check("huber_mean", x, y)
    if x.shape != y.shape:
        raise ValueError(
            f"huber_mean: shapes differ {tuple(x.shape)} vs {tuple(y.shape)}"
        )
    if x.numel() == 0:
        raise ValueError("huber_mean: empty input")
    return _HuberMean.apply(x, y, float(delta))
