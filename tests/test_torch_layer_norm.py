"""K5 (``ops/layer_norm.py``), flax's LayerNorm as one kernel forward and
two backward, on the CPU: the plain version is the eager chain the layer
ran before, bit for bit; the module's plain statement of K5's backward (the
formula the kernel computes, which ``tests/test_torch_cuda.py`` holds the
kernel against on the card) matches autograd through that chain in float64;
the layers route to K5 only with ``kernels`` and only on a CUDA tensor, so
a CPU model with ``model.use_pallas`` computes what the plain model does;
and the parameter names stay.

Tolerance of the float64 comparison: the formula and autograd group the
same float64 products and sums differently, so each element is held to
1e-10 of the largest of its tensor, far above float64's rounding at these
widths and far below any dropped or doubled term.
"""

import pytest
import torch

from mfvae_tpu_torch.config import ModelConfig
from mfvae_tpu_torch.models.layers import LayerNorm, MLP, StackedMLP
from mfvae_tpu_torch.models.mavae import MAVAE, AgentSpec, GroupedBatch
from mfvae_tpu_torch.ops import layer_norm as ln
from mfvae_tpu_torch.utils import profiling


def _chain(x, scale, bias, dtype, ct=torch.float32):
    """``LayerNorm.forward`` as it was before K5, op for op, its statistics
    in ``ct``."""
    x = x.to(ct)
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.clamp(torch.mean(x * x, dim=-1, keepdim=True) - mean * mean, min=0.0)
    y = (x - mean) * (torch.rsqrt(var + 1e-6) * scale)
    return (y + bias).to(dtype)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _params(d, dtype=torch.float32, seed=1):
    scale = (1.0 + 0.1 * torch.randn(d, generator=_gen(seed))).to(dtype)
    bias = (0.05 * torch.randn(d, generator=_gen(seed + 1))).to(dtype)
    return scale, bias


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("in_dtype,dtype", [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                                            (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)],
                         ids=str)
@pytest.mark.parametrize("shape", [(5, 7), (3, 2, 64), (4, 1024), (2, 15900)], ids=str)
def test_the_layer_runs_the_chain_of_before_bit_for_bit(kernels, in_dtype, dtype, shape):
    """Values and gradients of ``LayerNorm`` on a CPU tensor, with and
    without ``kernels``, equal the chain of before exactly."""
    d = shape[-1]
    layer = LayerNorm(d, dtype, kernels=kernels)
    with torch.no_grad():
        layer.scale.copy_(_params(d)[0])
        layer.bias.copy_(_params(d)[1])
    x = (3 * torch.randn(*shape, generator=_gen(0)) + 0.5).to(in_dtype).requires_grad_()
    g = torch.randn(*shape, generator=_gen(3)).to(dtype)
    y = layer(x)
    got = torch.autograd.grad(y, (x, layer.scale, layer.bias), g)
    x2 = x.detach().clone().requires_grad_()
    scale, bias = layer.scale.detach().clone().requires_grad_(), layer.bias.detach().clone().requires_grad_()
    want_y = _chain(x2, scale, bias, dtype)
    want = torch.autograd.grad(want_y, (x2, scale, bias), g)
    assert y.dtype == dtype and torch.equal(y, want_y)
    assert torch.equal(ln._layer_norm_plain(x.detach(), layer.scale, layer.bias, dtype), want_y)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _clamped_rows(d, n):
    """n rows of width d, each 1e8 + k plus a ripple of 0.5·N(0, 1), whose
    float64 E[x²] − E[x]² rounds below 0 (E[x²] is about 1e16, the true
    variance 0.25), so the clamp engages on each while x − mean stays
    about 0.5 and the variance term it drops is large."""
    gen, rows = _gen(d + 100), []
    for k in range(200):
        row = 1e8 + k + 0.5 * torch.randn(1, d, generator=gen, dtype=torch.float64)
        if float(ln._layer_norm_stats_plain(row)[0, 1]) < 0:
            rows.append(row)
            if len(rows) == n:
                return torch.cat(rows)
    raise AssertionError(f"no row of width {d} engages the clamp")


@pytest.mark.parametrize("rows,d", [(6, 1), (6, 7), (6, 64), (6, 1024), (3, 15900)])
def test_the_plain_backward_is_autograd_through_the_chain(rows, d):
    """``_layer_norm_bwd_plain`` from ``_layer_norm_stats_plain``'s
    statistics against autograd through the chain, all in float64, on
    random rows and on rows where the clamp engages (K5 drops the
    variance term there); at width 1 E[x²] − E[x]² is exactly 0
    and the clamp passes the gradient (K5 keeps the term)."""
    x = 3 * torch.randn(rows, d, generator=_gen(d), dtype=torch.float64) + 0.5
    if d == 1:
        assert bool((ln._layer_norm_stats_plain(x)[:, 1] > 0).all())  # raw is 0: no clamp
    else:
        x = torch.cat([x, _clamped_rows(d, 2)])
        stats = ln._layer_norm_stats_plain(x)
        assert bool((stats[-2:, 1] < 0).all()) and bool((stats[:-2, 1] > 0).all())
    scale, bias = _params(d, torch.float64)
    g = torch.randn(x.shape, generator=_gen(7), dtype=torch.float64)
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    want = torch.autograd.grad(_chain(*leaves, torch.float64, ct=torch.float64), leaves, g)
    got = ln._layer_norm_bwd_plain(x, g, scale, ln._layer_norm_stats_plain(x))
    for name, a, b in zip(("dx", "dscale", "dbias"), got, want):
        assert a.dtype == torch.float64, name
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10 * float(b.abs().max()), msg=name)


def test_the_plain_backward_of_a_two_stack_input():
    """The fused trunk's [B, 2, D] input: its rows are the flattened
    leading axes, and the formula over them is autograd's through the
    chain on the [B, 2, D] tensor."""
    b, d = 5, 64
    x = torch.randn(b, 2, d, generator=_gen(11), dtype=torch.float64)
    scale, bias = _params(d, torch.float64)
    g = torch.randn(b, 2, d, generator=_gen(12), dtype=torch.float64)
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    want = torch.autograd.grad(_chain(*leaves, torch.float64, ct=torch.float64), leaves, g)
    rows = x.reshape(-1, d)
    got = ln._layer_norm_bwd_plain(rows, g.reshape(-1, d), scale, ln._layer_norm_stats_plain(rows))
    for a, b_ in zip((got[0].view(b, 2, d), *got[1:]), want):
        torch.testing.assert_close(a, b_, rtol=0, atol=1e-10 * float(b_.abs().max()))


SMALL = ((0.12, 0.16), (0.57, 0.6), (0.94, 1.0))  # column ranges, as shares of the width, made 1e-3 smaller


@pytest.mark.parametrize("which", ["g", "scale"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d", [64, 1024, 8300, 15900, 20000])
def test_the_plain_backward_holds_small_columns_to_float64(d, dtype, which):
    """Columns whose dx is a thousandfold smaller than the row's, as the
    decoder input's are: with g or scale 1e-3 smaller over some ranges,
    the formula in f32 from the f32 statistics (what the card holds K5
    to) and autograd through the f32 chain are each within their
    tolerance of each range's largest |dx| of the float64 formula: 1e-5
    in f32, bf16's half ulp where dx is stored in bf16."""
    rows = 16
    x = (3 * torch.randn(rows, d, generator=_gen(d + 1)) + 0.5).to(dtype)
    g = torch.randn(rows, d, generator=_gen(d + 2))
    scale, bias = _params(d)
    edges = sorted({0, d} | {round(f * d) for r in SMALL for f in r})
    for lo_f, hi_f in SMALL:
        lo, hi = round(lo_f * d), round(hi_f * d)
        (g[:, lo:hi] if which == "g" else scale[lo:hi]).mul_(1e-3)
    g = g.to(dtype)
    want = ln._layer_norm_bwd_plain(x.double(), g.double(), scale.double(), ln._layer_norm_stats_plain(x.double()))[0]
    got = ln._layer_norm_bwd_plain(x, g, scale, ln._layer_norm_stats_plain(x))[0]
    xc = x.clone().requires_grad_()
    (chain,) = torch.autograd.grad(_chain(xc, scale, bias, dtype), xc, g)
    tol = 1e-5 if dtype == torch.float32 else 2.0**-8
    for lo, hi in zip(edges[:-1], edges[1:]):
        ref = want[:, lo:hi]
        for name, dx in (("formula", got), ("chain", chain)):
            assert dx.dtype == dtype
            err = float((dx[:, lo:hi].double() - ref).abs().max() / ref.abs().max())
            assert err <= tol, (name, lo, hi, err)


def test_the_plain_stats_are_the_chain_s():
    """The saved statistics: the chain's mean and rsqrt(var + eps), the
    rstd negated exactly where the clamp engaged."""
    x = torch.cat([torch.randn(4, 64, generator=_gen(5)), _clamped_rows(64, 1).float()])
    stats = ln._layer_norm_stats_plain(x)
    mean = torch.mean(x, dim=-1)
    raw = torch.mean(x * x, dim=-1) - mean * mean
    assert torch.equal(stats[:, 0], mean)
    assert torch.equal(stats[:, 1].abs(), torch.rsqrt(torch.clamp(raw, min=0.0) + 1e-6))
    assert torch.equal(stats[:, 1] < 0, raw < 0)


def test_cpu_tensors_never_count_k5():
    layer = LayerNorm(64, torch.bfloat16, kernels=True)
    profiling.reset_counters()
    x = torch.randn(8, 64, requires_grad=True)
    layer(x).float().sum().backward()
    with torch.no_grad():
        layer(x)
    assert "k5.launches" not in profiling.counters()


def _tag_like_model(use_pallas, fused, seed=0):
    """A tiny model with tag_wm's decoder recipe: det features, residual
    state, state skip, decoder LayerNorm, the five-layer decoder body, bf16."""
    agents = ("adversary_0", "adversary_1", "agent_0")
    spec = AgentSpec.from_dicts(agents, {"adversary_0": 10, "adversary_1": 10, "agent_0": 6},
                                {a: 5 for a in agents})
    cfg = ModelConfig(idx_features=8, obs_features=8, action_features=8, encoder_hidden=(16,),
                      decoder_hidden=(32, 16, 8, 16, 32), det_features=8, residual_state=True, state_skip=True,
                      decoder_layernorm=True, fused_decoders=fused, use_pallas=use_pallas,
                      compute_dtype="bfloat16")
    return MAVAE.from_config(cfg, spec, generator=torch.Generator().manual_seed(seed))


def _batch(model, b=6):
    gen = _gen(9)
    obs = tuple(torch.randn(b, len(i), od, generator=gen) for (od, _), i in model.spec.groups)
    act = tuple(torch.randint(0, ad, (b, len(i)), generator=gen) for (_, ad), i in model.spec.groups)
    return GroupedBatch(obs, act)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_use_pallas_gives_the_plain_model_s_outputs_and_gradients_on_the_cpu(fused):
    """``model.use_pallas`` builds the decoders' LayerNorms with
    ``kernels`` (and no other LayerNorm); on the CPU both models run the
    chain, so their outputs are equal bit for bit and so is every
    gradient but the embedding tables' (K4's plain version sums those in
    another order)."""
    plain, routed = _tag_like_model(False, fused), _tag_like_model(True, fused)
    routed.load_state_dict(plain.state_dict())
    norms = {n: m.kernels for n, m in routed.named_modules() if isinstance(m, LayerNorm)}
    assert len(norms) == (5 if fused else 12) and all(norms.values())
    assert not any(m.kernels for m in plain.modules() if isinstance(m, LayerNorm))
    batch = _batch(plain)
    eps = torch.randn(6, 3, 8, generator=_gen(2))
    outs, grads = [], []
    for model in (plain, routed):
        out = model(batch, eps=eps)
        sum(o.float().sum() for o in out).backward()
        outs.append(out)
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    for name, g in grads[0].items():
        if name.endswith("embedding"):
            torch.testing.assert_close(grads[1][name], g, rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(grads[1][name], g), name


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_state_dict_keys_and_shapes_are_unchanged(fused):
    plain, routed = _tag_like_model(False, fused), _tag_like_model(True, fused)
    assert {k: v.shape for k, v in routed.state_dict().items()} == {k: v.shape for k, v in plain.state_dict().items()}
    keys = routed.state_dict().keys()
    heads = ("decoder_trunk",) if fused else ("state_decoder", "reward_decoder")
    for head in heads:
        for name in ("ln0", "ln1", "ln2", "ln3", "ln_out") + (() if fused else ("ln4",)):
            assert f"{head}.{name}.scale" in keys and f"{head}.{name}.bias" in keys


def test_mlps_pass_kernels_to_their_layer_norms():
    for mlp in (MLP(12, (8, 4), 3, layernorm=True, kernels=True),
                StackedMLP(2, 12, (8, 4), 3, layernorm=True, kernels=True)):
        assert [m.kernels for m in mlp.modules() if isinstance(m, LayerNorm)] == [True] * 3
    assert not any(m.kernels for m in MLP(12, (8,), 3, layernorm=True).modules() if isinstance(m, LayerNorm))
