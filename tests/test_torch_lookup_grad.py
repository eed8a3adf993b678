"""K4 (``ops/lookup_grad.py``), the embedding lookups' backward, on the CPU:
its plain version against autograd of the gather it replaces
(``table[...]`` then ``.to(dtype)``), the two layers that route through it
(``Embedding.at``, ``StackedEmbedding``), the lookups that keep the
gather, and the launch geometry the kernel reads its rows by.

Tolerance: both sides sum the same f32 values (the gradient in its own
type, widened) in another order.  Each element is held to the float64
sum within 2^-20 of the sum of the magnitudes it adds, 16 times f32's
rounding of one add: far above the few units of rounding such a sum
gathers, far below any value that a lost or doubled row would move.
"""

import math

import numpy as np
import pytest
import torch

from mfvae_tpu_torch.config import ModelConfig
from mfvae_tpu_torch.models.layers import Embedding, StackedEmbedding
from mfvae_tpu_torch.models.mavae import MAVAE, AgentSpec, GroupedBatch
from mfvae_tpu_torch.ops import lookup_grad as lg
from mfvae_tpu_torch.utils import profiling

B = 4099  # ragged against every chunk and every block's rows at once
F = 64
REL = 2.0**-20


def _close_to_exact(got, g, rows_of):
    """got [R, F] against the float64 sums of g's rows that ``rows_of``
    [B, S] names (-1: none), within REL of the sums of magnitudes."""
    g64 = g.to(torch.float64).reshape(-1, g.shape[-1])
    flat = rows_of.reshape(-1)
    keep = flat >= 0
    exact = torch.zeros(got.shape, dtype=torch.float64).index_add_(0, flat[keep], g64[keep])
    mag = torch.zeros(got.shape, dtype=torch.float64).index_add_(0, flat[keep], g64[keep].abs())
    assert bool(((got.to(torch.float64) - exact).abs() <= REL * mag).all())


def _grad(g_dtype, s, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(B, s, F, generator=gen).to(g_dtype)


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("s", [30, 10])
def test_fixed_positions_against_the_gather(g_dtype, s):
    rows = 40
    pos = torch.randperm(rows, generator=torch.Generator().manual_seed(s))[:s]
    table = torch.randn(rows, F, requires_grad=True)
    g = _grad(g_dtype, s, 1)
    want, = torch.autograd.grad(table[pos[None, :].expand(B, -1)].to(g_dtype), table, g)
    got = lg._lookup_grad_plain(g, rows, pos=pos)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0.0, atol=float(REL * g.float().abs().sum(0).max()))
    _close_to_exact(got, g, pos[None, :].expand(B, -1))
    untouched = torch.ones(rows, dtype=torch.bool)
    untouched[pos] = False
    assert bool((got[untouched] == 0).all())


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("s", [30, 10])
@pytest.mark.parametrize("bins", range(1, lg.MAX_BINS + 1))
def test_per_column_bins_against_the_gather(g_dtype, s, bins):
    gen = torch.Generator().manual_seed(100 * s + bins)
    table = torch.randn(s, bins, F, generator=gen, requires_grad=True)
    idx = torch.randint(0, bins, (B, s), generator=gen, dtype=torch.int32)
    g = _grad(g_dtype, s, bins)
    stack = torch.arange(s)
    want, = torch.autograd.grad(table[stack[None, :], idx.long()].to(g_dtype), table, g)
    got = lg._lookup_grad_plain(g, s * bins, idx=idx, bins=bins)
    torch.testing.assert_close(got.view(s, bins, F), want, rtol=0.0,
                               atol=float(REL * g.float().abs().sum(0).max()))
    _close_to_exact(got, g, stack[None, :] * bins + idx.long())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_the_layers_keep_their_values_and_gradients(dtype):
    """With ``kernels`` both layers give today's values bit for bit (the
    fixed lookup as a broadcast view), and gradients within the sums'
    tolerance of today's."""
    gen = torch.Generator().manual_seed(0)
    plain, routed = (Embedding(40, F, dtype=dtype, kernels=k) for k in (False, True))
    routed.load_state_dict(plain.state_dict())
    pos = torch.arange(30, 40)
    want = plain(pos[None, :].expand(B, -1))
    got = routed.at(pos, B)
    assert got.dtype == dtype and got.stride(0) == 0 and torch.equal(got, want)
    g = torch.randn(B, 10, F, generator=gen).to(dtype)
    (ga,), (gb,) = (torch.autograd.grad(y, m.embedding, g) for y, m in ((want, plain), (got, routed)))
    torch.testing.assert_close(gb, ga, rtol=0.0, atol=float(REL * g.float().abs().sum(0).max()))

    plain, routed = (StackedEmbedding(30, 5, F, dtype=dtype, kernels=k) for k in (False, True))
    routed.load_state_dict(plain.state_dict())
    idx = torch.randint(0, 5, (B, 30), generator=gen, dtype=torch.int32)
    want, got = plain(idx), routed(idx)
    assert got.dtype == dtype and torch.equal(got, want)
    g = torch.randn(B, 30, F, generator=gen).to(dtype)
    (ga,), (gb,) = (torch.autograd.grad(y, m.embedding, g) for y, m in ((want, plain), (got, routed)))
    torch.testing.assert_close(gb, ga, rtol=0.0, atol=float(REL * g.float().abs().sum(0).max()))


class _Entered:
    """Counts the calls of K4's two autograd Functions."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("lookup_fixed", "lookup_bins"):
            real = getattr(lg, name)
            monkeypatch.setattr(lg, name, self._wrap(name, real))

    def _wrap(self, name, real):
        def wrapped(*args):
            self.calls.append(name)
            return real(*args)
        return wrapped


def test_ids_from_data_and_wide_stacks_keep_the_gather(monkeypatch):
    entered = _Entered(monkeypatch)
    emb = Embedding(40, F, dtype=torch.bfloat16, kernels=True)
    ids = torch.tensor([[0, 39, -1, 40]])
    out = emb.take(ids)
    assert torch.isnan(out[0, 3].float()).all() and torch.equal(out[0, 2], emb.embedding[39].to(torch.bfloat16))
    wide = StackedEmbedding(3, lg.MAX_BINS + 1, F, dtype=torch.bfloat16, kernels=True)
    idx = torch.full((4, 3), lg.MAX_BINS)
    wide(idx).float().sum().backward()
    assert wide.embedding.grad[:, lg.MAX_BINS].abs().sum() > 0
    assert entered.calls == []
    StackedEmbedding(3, lg.MAX_BINS, F, dtype=torch.bfloat16, kernels=True)(idx - 1)
    assert entered.calls == ["lookup_bins"]


def _tiny_model(use_pallas, discrete=True):
    agents = ("adversary_0", "adversary_1", "adversary_2", "agent_0")
    spec = AgentSpec.from_dicts(agents, {"adversary_0": 10, "adversary_1": 10, "adversary_2": 10, "agent_0": 6},
                                {a: 5 for a in agents})
    cfg = ModelConfig(idx_features=8, obs_features=8, action_features=8, encoder_hidden=(16,),
                      decoder_hidden=(32,), use_pallas=use_pallas, discrete_act=discrete)
    return MAVAE.from_config(cfg, spec, generator=torch.Generator().manual_seed(0))


def _batch(model, b=6, seed=1):
    gen = torch.Generator().manual_seed(seed)
    obs = tuple(torch.randn(b, len(i), od, generator=gen) for (od, _), i in model.spec.groups)
    if model.discrete_act:
        act = tuple(torch.randint(0, ad, (b, len(i)), generator=gen, dtype=torch.int32)
                    for (_, ad), i in model.spec.groups)
    else:
        act = tuple(torch.rand(b, len(i), ad, generator=gen) for (_, ad), i in model.spec.groups)
    return GroupedBatch(obs=obs, actions=act)


@pytest.mark.parametrize("discrete", [True, False], ids=["discrete", "continuous"])
def test_use_pallas_routes_the_model_through_k4_and_the_plain_model_never(monkeypatch, discrete):
    """``model.use_pallas: false`` never enters K4's Functions; with it, a
    train step's forward enters them once a group (and once more a group
    for the discrete actions), with the same outputs bit for bit and
    gradients within the sums' tolerance.  Ids from data (the dict call's
    path) skip the fixed lookup."""
    entered = _Entered(monkeypatch)
    plain, routed = _tiny_model(False, discrete), _tiny_model(True, discrete)
    batch = _batch(plain)
    eps = torch.randn(6, 4, 8, generator=torch.Generator().manual_seed(2))
    outs, grads = [], []
    for model in (plain, routed):
        out = model(batch, eps=eps)
        sum(o.float().sum() for o in out).backward()
        outs.append(out)
        grads.append({n: p.grad for n, p in model.named_parameters()})
        if model is plain:
            assert entered.calls == []
    groups = len(plain.spec.groups)
    assert entered.calls == ["lookup_fixed", "lookup_bins"] * groups if discrete else ["lookup_fixed"] * groups
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=1e-5, atol=1e-6)
    entered.calls.clear()
    ids = tuple(routed._group_ids(g)[None, :].expand(6, -1).to(torch.int32) for g in range(groups))
    assert torch.equal(routed(batch, ids, eps=eps)[0], outs[1][0])
    assert entered.calls == (["lookup_bins"] * groups if discrete else [])


def test_wrapper_refuses_bad_inputs():
    g = torch.zeros(4, 3, F, dtype=torch.bfloat16)
    idx = torch.zeros(4, 3, dtype=torch.int32)
    pos = torch.arange(3)
    with pytest.raises(ValueError):
        lg.lookup_grad(g, 3 * (lg.MAX_BINS + 1), idx=idx, bins=lg.MAX_BINS + 1)
    with pytest.raises(ValueError):
        lg.lookup_grad(g.transpose(0, 1), 3, pos=pos)  # not contiguous
    with pytest.raises(TypeError):
        lg.lookup_grad(g.double(), 3, pos=pos)
    with pytest.raises(TypeError):
        lg.lookup_grad(g, 15, idx=idx.float(), bins=5)
    with pytest.raises(ValueError):
        lg.lookup_grad(g, 3, pos=pos, idx=idx)
    with pytest.raises(ValueError):
        lg.lookup_grad(g, 14, idx=idx, bins=5)
    with pytest.raises(ValueError):
        lg.lookup_grad(torch.zeros(4, 3, lg.max_features(torch.float32) + 4), 3, pos=pos)
    profiling.reset_counters()
    lg.lookup_grad(g, 15, idx=idx, bins=5)
    assert profiling.counters() == {}  # the CPU takes the plain version


@pytest.mark.parametrize("itemsize", [4, 2])
def test_geometry_reads_every_element_once(itemsize):
    """The kernel's partition, replayed in numpy: block (col, chunk) of the
    ``CHUNKS`` a column has, warp w and lane l read rows b0 + w·(32/lanes)
    + l/lanes + i·rows_at_once of the chunk and the segment l % lanes of
    each row; every element of g is read exactly once."""
    for batch, features, ptr in ((B, 64, 0), (4096, 64, 0), (7, 33, 8), (1, 1, 2), (0, 64, 0),
                                 (300, 200 if itemsize == 2 else 100, 16), (3, 64, 0)):
        lanes, aligned = lg.lookup_geometry(features, itemsize, ptr)
        pack = 16 // itemsize
        assert lanes & (lanes - 1) == 0 and math.ceil(features / pack) <= lanes <= 32
        assert aligned == (features % pack == 0 and ptr % 16 == 0)
        rows_at_once = lg._WARPS * (32 // lanes)
        per_chunk = -(-batch // lg.CHUNKS)
        reads = np.zeros((batch, features), dtype=np.int64)
        for chunk in range(lg.CHUNKS):
            b0, b1 = chunk * per_chunk, min(batch, (chunk + 1) * per_chunk)
            for t in range(lg._WARPS * 32):
                warp, lane = divmod(t, 32)
                seg = lane % lanes
                if seg * pack >= features:
                    continue
                for b in range(b0 + warp * (32 // lanes) + lane // lanes, b1, rows_at_once):
                    reads[b, seg * pack:min(features, (seg + 1) * pack)] += 1
        assert (reads == 1).all(), (batch, features)
