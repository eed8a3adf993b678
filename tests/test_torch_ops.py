"""The port's ELBO-tail ops on the CPU (the kernels' plain versions behind
the same autograd Functions) against the JAX ``fused_reparam_kl`` and
``huber_mean``, which run their Pallas kernels in interpret mode on the
CPU.  Forward values and gradients, rtol 1e-5 / atol 1e-6 (float32 on both
sides, sums over F and over n taken in another order).

bfloat16 and float16 inputs hold exactly representable values on both
sides.  Both compute in f32 (values f32, held at the f32 tolerance) and
round each gradient once to its input's type, so a gradient may differ by
one ulp of that type: rtol 2^-7 for bf16, 2^-10 for f16, with the f32
atol.

K3w (``huber_rows_wsum``, the unroll step's masked pools) has no JAX
counterpart: its plain version is held to a float64 weighted sum at rtol
1e-6, and its gradient to ``w_r/D·clamp(x - y, -δ, δ)``."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfvae_tpu.ops.fused_elbo import fused_reparam_kl as j_fused
from mfvae_tpu.ops.fused_elbo import huber_mean as j_huber
from mfvae_tpu_torch.ops import fused_elbo as ops
from mfvae_tpu_torch.utils import profiling

RTOL, ATOL = 1e-5, 1e-6
TYPES = {  # name -> (torch type, JAX type, gradient rtol: one ulp of the type)
    "float32": (torch.float32, jnp.float32, RTOL),
    "bfloat16": (torch.bfloat16, jnp.bfloat16, 2.0**-7),
    "float16": (torch.float16, jnp.float16, 2.0**-10),
}


def close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(4, 5, 64), (3, 7, 64), (37, 16)], ids=str)
def test_fused_reparam_kl_matches_jax(shape):
    rng = np.random.default_rng(0)
    mu, lv, eps, gz = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
    gkl = rng.normal(size=shape[:-1]).astype(np.float32)

    def jloss(m, l):
        z, kl = j_fused(m, l, jnp.asarray(eps))
        return jnp.sum(z * gz) + jnp.sum(kl * gkl), (z, kl)

    (_, (jz, jkl)), (jdmu, jdlv) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(mu), jnp.asarray(lv)
    )
    tmu = torch.tensor(mu, requires_grad=True)
    tlv = torch.tensor(lv, requires_grad=True)
    tz, tkl = ops.fused_reparam_kl(tmu, tlv, torch.tensor(eps))
    close(tz, jz)
    close(tkl, jkl)
    dmu, dlv = torch.autograd.grad((tz, tkl), (tmu, tlv), (torch.tensor(gz), torch.tensor(gkl)))
    close(dmu, jdmu)
    close(dlv, jdlv)


@pytest.mark.parametrize("n,delta", [(4 * 5 * 64, 1.0), (1001, 0.5), (37, 1.0)])
def test_huber_mean_matches_jax(n, delta):
    rng = np.random.default_rng(1)
    x = (2 * rng.normal(size=n)).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    jv, (jdx, jdy) = jax.value_and_grad(lambda a, b: j_huber(a, b, delta), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y)
    )
    tx = torch.tensor(x, requires_grad=True)
    ty = torch.tensor(y, requires_grad=True)
    tv = ops.huber_mean(tx, ty, delta)
    close(tv, jv)
    dx, dy = torch.autograd.grad(tv, (tx, ty))
    close(dx, jdx)
    close(dy, jdy)
    close(torch.nn.functional.huber_loss(tx, ty, delta=delta), jv)


def as_type(a: np.ndarray, name: str):
    """The values of ``a`` rounded once to ``name``, as a torch tensor and
    as a JAX array that hold the same numbers."""
    tdt, jdt, _ = TYPES[name]
    t = torch.tensor(a).to(tdt)
    return t, jnp.asarray(t.float().numpy()).astype(jdt)


def close_grad(t, j, name):
    """A gradient in its input's type, within one ulp of that type."""
    assert t.dtype == TYPES[name][0] and j.dtype == TYPES[name][1]
    np.testing.assert_allclose(
        t.float().numpy(), np.asarray(j).astype(np.float32), rtol=TYPES[name][2], atol=ATOL
    )


@pytest.mark.parametrize(
    "x_type,y_type",
    [("bfloat16", "bfloat16"), ("float16", "float16"), ("bfloat16", "float32"), ("float16", "bfloat16")],
)
def test_huber_mean_low_precision_matches_jax(x_type, y_type):
    rng = np.random.default_rng(2)
    tx, jx = as_type((2 * rng.normal(size=1000)).astype(np.float32), x_type)
    ty, jy = as_type(rng.normal(size=1000).astype(np.float32), y_type)
    jv, (jdx, jdy) = jax.value_and_grad(lambda a, b: j_huber(a, b, 0.5), argnums=(0, 1))(jx, jy)
    tx.requires_grad_()
    ty.requires_grad_()
    tv = ops.huber_mean(tx, ty, 0.5)
    assert tv.dtype == torch.float32 and jv.dtype == jnp.float32
    close(tv, jv)
    close(ops._huber_mean_plain(tx, ty, 0.5), jv)
    dx, dy = torch.autograd.grad(tv, (tx, ty))
    close_grad(dx, jdx, x_type)
    close_grad(dy, jdy, y_type)


@pytest.mark.parametrize(
    "types",
    [("bfloat16",) * 3, ("float16",) * 3, ("bfloat16", "float16", "float32")],
    ids=lambda t: "-".join(t),
)
def test_fused_reparam_kl_low_precision_matches_jax(types):
    rng = np.random.default_rng(3)
    shape = (3, 7, 64)
    (tmu, jmu), (tlv, jlv), (teps, jeps) = (
        as_type(rng.normal(size=shape).astype(np.float32), name) for name in types
    )
    gz = rng.normal(size=shape).astype(np.float32)
    gkl = rng.normal(size=shape[:-1]).astype(np.float32)

    def jloss(m, l):
        z, kl = j_fused(m, l, jeps)
        return jnp.sum(z * gz) + jnp.sum(kl * gkl), (z, kl)

    (_, (jz, jkl)), (jdmu, jdlv) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(jmu, jlv)
    tmu.requires_grad_()
    tlv.requires_grad_()
    tz, tkl = ops.fused_reparam_kl(tmu, tlv, teps)
    assert tz.dtype == tkl.dtype == torch.float32
    close(tz, jz)
    close(tkl, jkl)
    dmu, dlv = torch.autograd.grad((tz, tkl), (tmu, tlv), (torch.tensor(gz), torch.tensor(gkl)))
    close_grad(dmu, jdmu, types[0])
    close_grad(dlv, jdlv, types[1])


T = ops.HUBER_SINGLE_BLOCK_MAX
WAVE = 4 * 132  # K3's grid cap on an H100: 4 blocks on each of 132 SMs


@pytest.mark.parametrize(
    "n,x_off,y_off,itemsize,want",
    [
        (1, 0, 0, 4, (1, 0, 1)),  # shorter than one pack: one element at a time
        (3, 0, 0, 4, (1, 0, 1)),
        (4, 0, 0, 4, (4, 0, 1)),
        (5120, 0, 0, 4, (4, 0, 1)),  # the reward branch: one block
        (724480, 0, 0, 4, (4, 0, 354)),  # the state branch: 2048 floats a block
        (724480, 0, 0, 2, (8, 0, 177)),  # bf16/f16: 4096 a block
        (T - 1, 0, 0, 4, (4, 0, 1)),
        (T, 0, 0, 4, (4, 0, 1)),
        (T + 1, 0, 0, 4, (4, 0, math.ceil((T + 1) / 2048))),
        (5120, 4, 4, 4, (4, 3, 1)),  # both views 4 bytes in: a head of 3
        (724480, 4, 4, 4, (4, 3, 354)),
        (724480, 4, 0, 4, (1, 0, WAVE)),  # offsets differ: scalar loads
        (724480, 2, 2, 2, (8, 7, 177)),
        (10**8, 0, 0, 4, (4, 0, WAVE)),  # capped at one wave
    ],
)
def test_huber_geometry(n, x_off, y_off, itemsize, want):
    base = 1 << 20
    assert tuple(ops.huber_geometry(base + x_off, 2 * base + y_off, n, itemsize, WAVE)) == want


@pytest.mark.parametrize("itemsize", [4, 2])
def test_huber_geometry_covers_every_element_once(itemsize):
    """The kernel's partition: a scalar head that ends on a 16-byte boundary
    of both tensors, whole packs, and a scalar tail, each shorter than a
    pack; the grid is within the workspace and covers n in one pass unless
    capped."""
    for n in (1, 2, 3, 7, 8, 9, 33, 1001, T, T + 1, 5120, 724480):
        for off in range(0, 16, itemsize):
            for y_off in (off, (off + itemsize) % 16):
                x_ptr, y_ptr = 4096 + off, 8192 + y_off
                vec, head, blocks = ops.huber_geometry(x_ptr, y_ptr, n, itemsize, WAVE)
                npacks = (n - head) // vec
                tail = n - head - npacks * vec
                assert head >= 0 and tail >= 0 and head + npacks * vec + tail == n
                assert head < vec or head == 0 and vec == 1
                assert tail < vec or vec == 1 and tail == 0
                if vec > 1:
                    assert (x_ptr + head * itemsize) % 16 == 0 == (y_ptr + head * itemsize) % 16
                    assert vec * itemsize == 16
                assert 1 <= blocks <= WAVE
                assert blocks == 1 or blocks == WAVE or blocks * 2 * 256 * vec >= n


def test_plain_autograd_agrees_with_the_function_backward():
    """K2's formula (the Function's backward) equals autograd through K1's
    plain arithmetic; on the card the same pair holds the kernel."""
    g = torch.Generator().manual_seed(0)
    mu, lv, eps = (torch.randn(6, 3, 64, generator=g) for _ in range(3))
    gz, gkl = torch.randn(6, 3, 64, generator=g), torch.randn(6, 3, generator=g)
    a = [t.clone().requires_grad_() for t in (mu, lv)]
    b = [t.clone().requires_grad_() for t in (mu, lv)]
    ga = torch.autograd.grad(ops.fused_reparam_kl(*a, eps), a, (gz, gkl))
    gb = torch.autograd.grad(ops._fused_reparam_kl_plain(*b, eps), b, (gz, gkl))
    for x, y in zip(ga, gb):
        torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL)


def test_wrappers_refuse_bad_inputs():
    x = torch.zeros(4, 8)
    with pytest.raises(TypeError):
        ops.fused_reparam_kl(x.double(), x.double(), x.double())
    with pytest.raises(ValueError):
        ops.fused_reparam_kl(x, x, torch.zeros(4, 7))
    with pytest.raises(ValueError):
        ops.fused_reparam_kl(x.t(), x.t(), x.t())  # not contiguous
    with pytest.raises(ValueError):
        ops.huber_mean(x, torch.zeros(8, 4))
    with pytest.raises(TypeError):
        ops.huber_mean(x.double(), x.double())
    with pytest.raises(TypeError):
        ops.huber_mean(x.int(), x.int())
    with pytest.raises(ValueError):
        ops.huber_mean(torch.zeros(0), torch.zeros(0))
    with pytest.raises(ValueError):
        ops.huber_mean(x.to("meta"), x.to("meta"))


def test_cpu_path_launches_nothing():
    profiling.reset_counters()
    x = torch.ones(2, 3, 64, requires_grad=True)
    z, kl = ops.fused_reparam_kl(x, x, x)
    w = torch.ones(2 * 3)
    (z.sum() + kl.sum() + ops.huber_mean(x, 2 * x) + ops.huber_rows_wsum(x.reshape(6, 64), x.reshape(6, 64), w)).backward()
    assert profiling.counters() == {}


def test_kernel_build_raises_without_nvcc(tmp_path, monkeypatch):
    """No quiet fallback: a missing compiler is an error, not a CPU path."""
    from mfvae_tpu_torch.utils import kernel_build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(kernel_build.KernelBuildError, match="nvcc not found"):
        kernel_build.build(ops.SOURCE)
    with pytest.raises(kernel_build.KernelBuildError, match="missing"):
        kernel_build.build("no_such_source.cu")


# ------------------------------------------------------------------ K3w
def huber_rows_wsum64(x, y, w, delta):
    """Σ_r w_r · mean_d huber(x_rd - y_rd), in float64."""
    a = torch.abs(x.double() - y.double())
    q = torch.clamp(a, max=delta)
    return float(torch.sum(torch.mean(0.5 * q * q + delta * (a - q), dim=-1) * w.double()))


WSUM_CASES = {  # name -> (rows, d, delta, weights)
    "mask": (37, 26, 1.0, "mask"),
    "weights": (64, 40, 0.5, "weights"),
    "all_zero": (16, 26, 1.0, "zero"),
    "one_row": (1, 26, 1.0, "weights"),
    "one_column": (50, 1, 1.0, "mask"),
}


@pytest.mark.parametrize("name", sorted(WSUM_CASES))
def test_huber_rows_wsum_matches_float64(name):
    rows, d, delta, kind = WSUM_CASES[name]
    g = torch.Generator().manual_seed(2)
    x, y = 2 * torch.randn(rows, d, generator=g), torch.randn(rows, d, generator=g)
    w = {"mask": (torch.rand(rows, generator=g) < 0.7).float(), "weights": 3 * torch.rand(rows, generator=g),
         "zero": torch.zeros(rows)}[kind]
    xg = x.clone().requires_grad_()
    v = ops.huber_rows_wsum(xg, y, w, delta)
    assert v.dtype == torch.float32 and v.dim() == 0
    want = huber_rows_wsum64(x, y, w, delta)
    assert abs(float(v.detach()) - want) <= 1e-6 * abs(want)  # all-zero weights: exactly 0
    (dx,) = torch.autograd.grad(v, xg)
    torch.testing.assert_close(dx, torch.clamp(x - y, -delta, delta) * (w / d)[:, None], rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("name", ["bfloat16", "float16"])
def test_huber_rows_wsum_low_precision(name):
    dtype, _, ulp = TYPES[name]
    g = torch.Generator().manual_seed(3)
    x, y = (2 * torch.randn(9, 40, generator=g)).to(dtype), torch.randn(9, 40, generator=g).to(dtype)
    w = (torch.rand(9, generator=g) < 0.5).float()
    xg, yg = x.clone().requires_grad_(), y.clone().requires_grad_()
    v = ops.huber_rows_wsum(xg, yg, w, 1.0)
    want = huber_rows_wsum64(x, y, w, 1.0)
    assert abs(float(v.detach()) - want) <= 1e-6 * abs(want)
    dx, dy = torch.autograd.grad(v, (xg, yg))
    assert dx.dtype == dy.dtype == dtype
    grad = torch.clamp(x.float() - y.float(), -1.0, 1.0) * (w / 40)[:, None]
    torch.testing.assert_close(dx, grad.to(dtype), rtol=ulp, atol=1e-12)
    torch.testing.assert_close(dy, (-grad).to(dtype), rtol=ulp, atol=1e-12)


def test_huber_rows_wsum_is_the_weighted_huber_mean():
    """Weights 1 over R rows give R times K3's mean; a weight per row is
    the rows' huber means so weighted (the unroll's masked pool)."""
    g = torch.Generator().manual_seed(4)
    x, y = torch.randn(12, 26, generator=g), torch.randn(12, 26, generator=g)
    torch.testing.assert_close(ops.huber_rows_wsum(x, y, torch.ones(12)), 12 * ops.huber_mean(x, y), rtol=1e-6,
                               atol=0.0)
    w = torch.zeros(12)
    w[3] = 2.0
    torch.testing.assert_close(ops.huber_rows_wsum(x, y, w), 2 * ops.huber_mean(x[3], y[3]), rtol=1e-6, atol=0.0)


def test_huber_rows_wsum_refuses_bad_inputs():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        ops.huber_rows_wsum(x, x, torch.zeros(3))  # a weight per row
    with pytest.raises(ValueError):
        ops.huber_rows_wsum(x.reshape(-1), x.reshape(-1), torch.zeros(32))  # rows [R, D]
    with pytest.raises(TypeError):
        ops.huber_rows_wsum(x, x, torch.zeros(4, dtype=torch.float64))  # f32 weights
    with pytest.raises(TypeError):
        ops.huber_rows_wsum(x.double(), x.double(), torch.zeros(4))
    with pytest.raises(ValueError):
        ops.huber_rows_wsum(torch.zeros(0, 8), torch.zeros(0, 8), torch.zeros(0))


@pytest.mark.parametrize("rows,d,itemsize", [(32768, 5660, 4), (32768, 5660, 2), (32768, 40, 4), (32768, 40, 2),
                                             (100, 3, 4), (7, 5, 2), (1, 26, 4)])
def test_huber_geometry_of_k3w_rows(rows, d, itemsize):
    """K3w takes K3's geometry, with 16-byte loads only where a pack spans
    at most two rows."""
    pack = 16 // itemsize
    geo = ops.huber_geometry(0, 0, rows * d, itemsize, WAVE, row=d)
    n = rows * d
    assert geo.vec == (pack if d >= pack and n >= pack else 1) and geo.head == 0
    assert geo.blocks == ops.huber_geometry(0, 0 if d >= pack else 1, n, itemsize, WAVE).blocks
