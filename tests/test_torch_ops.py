"""The port's ELBO-tail ops on the CPU (the kernels' plain versions behind
the same autograd Functions) against the JAX ``fused_reparam_kl`` and
``huber_mean``, which run their Pallas kernels in interpret mode on the
CPU.  Forward values and gradients, rtol 1e-5 / atol 1e-6 (float32 on both
sides, sums over F and over n taken in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfvae_tpu.ops.fused_elbo import fused_reparam_kl as j_fused
from mfvae_tpu.ops.fused_elbo import huber_mean as j_huber
from mfvae_tpu_torch.ops import fused_elbo as ops

RTOL, ATOL = 1e-5, 1e-6


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
        ops.huber_mean(x.half(), x.half())
    with pytest.raises(ValueError):
        ops.huber_mean(torch.zeros(0), torch.zeros(0))
    with pytest.raises(ValueError):
        ops.huber_mean(x.to("meta"), x.to("meta"))


def test_cpu_path_launches_nothing():
    ops.reset_launch_counts()
    x = torch.ones(2, 3, 64)
    ops.fused_reparam_kl(x, x, x)
    ops.huber_mean(x, 2 * x)
    assert ops.LAUNCHES == {"reparam_kl_fwd": 0, "reparam_kl_bwd": 0, "huber_mean": 0}


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
