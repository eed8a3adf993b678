"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA card every test here skips (decided inside
the fixture, never at import).  On a card, run it without the JAX test
harness:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: z and the K2 gradients rtol/atol 1e-6 against the same
arithmetic in plain PyTorch (the kernels are built with -fmad=false and
accurate expf); the per-row KL and the huber mean rtol 1e-5, because the
sums are taken in another order.  K3's gradients in bf16/f16 are held to
one ulp of their type (both sides compute in f32 and round once).  K3 sums
in a fixed order, so two calls on the same inputs are bit-equal.  K3w
(``huber_rows_wsum``) alike, at the unroll cell's shapes (32,768 rows of
5,660 and of 40) in f32 and bf16, and beside K3 on their shared
workspace; one unroll step by both routes on the card.

K4 (``ops/lookup_grad.py``), the embedding lookups' backward, against its
plain version at the b4,096 lookups' shapes ([4,096, 30, 64] and [4,096,
10, 64]) and ragged ones, in f32 and bf16, both modes: each element within
2^-19 of the sum of the magnitudes it adds (both sides within 2^-20 of the
exact sum, as ``tests/test_torch_lookup_grad.py`` holds the plain version
on the CPU), two calls bit-equal; its launches over a tag_wm train step
(4), an unroll step (32) and a rollout (0); no ``indexing_backward_kernel``
in a profiled train step.

``WorldModel``'s rollout step graphs on a model of the tag_wm widths
(simple_tag 30/10/20, ``examples/world_model.yaml``, bf16), discrete and
continuous: the graphed requests against the eager loop of the same
model, bit for bit (the same kernels on the same inputs).
"""

from pathlib import Path

import pytest
import torch

from mfvae_tpu_torch import inference
from mfvae_tpu_torch.config import LossConfig, ModelConfig, TrainConfig, load_config
from mfvae_tpu_torch.data.transitions import VaeBatch
from mfvae_tpu_torch.models.mavae import MAVAE, AgentSpec, GroupedBatch
from mfvae_tpu_torch.ops import fused_elbo as ops
from mfvae_tpu_torch.ops import lookup_grad as lg
from mfvae_tpu_torch.training.trainer import create_train_state, make_train_step
from mfvae_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(dev, *shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator(device=dev).manual_seed(seed), device=dev)


@pytest.mark.parametrize("shape", [(128, 40, 64), (3, 7, 64), (5, 3, 33)], ids=str)
def test_reparam_kl_fwd_and_bwd(dev, shape):
    mu, lv, eps = (_randn(dev, *shape, seed=s) for s in range(3))
    profiling.reset_counters()
    z, kl = ops.fused_reparam_kl(mu, lv, eps)
    zp, klp = ops._fused_reparam_kl_plain(mu, lv, eps)
    torch.testing.assert_close(z, zp, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(kl, klp, rtol=1e-5, atol=1e-6)
    f = shape[-1]
    gz, gkl = _randn(dev, *shape, seed=3), _randn(dev, *shape[:-1], seed=4)
    rows = (mu.reshape(-1, f), lv.reshape(-1, f), eps.reshape(-1, f), gz.reshape(-1, f), gkl.reshape(-1))
    for got, want in zip(ops._reparam_kl_bwd_cuda(*rows), ops._bwd_rows_plain(*rows)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert profiling.counters() == {"k1.launches": 1, "k2.launches": 1}


T = ops.HUBER_SINGLE_BLOCK_MAX
ULP = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}


@pytest.mark.parametrize("n", [128 * 5660, 128 * 40, 1001, 1, 3, T - 1, T, T + 1])
@pytest.mark.parametrize("delta", [1.0, 0.5])
def test_huber_mean(dev, n, delta):
    x, y = 2 * _randn(dev, n, seed=5), _randn(dev, n, seed=6)
    x.requires_grad_()
    h = ops.huber_mean(x, y, delta)
    torch.testing.assert_close(h, ops._huber_mean_plain(x, y, delta), rtol=1e-5, atol=0.0)
    assert torch.equal(ops.huber_mean(x, y, delta), h)  # a fixed sum order
    (dx,) = torch.autograd.grad(h, x)
    torch.testing.assert_close(dx, torch.clamp(x - y, -delta, delta) / n, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("n", [128 * 5660, 128 * 40, 1001, T + 1])
def test_huber_mean_low_precision(dev, dtype, n):
    x, y = (2 * _randn(dev, n, seed=5)).to(dtype), _randn(dev, n, seed=6).to(dtype)
    xg, yg = x.clone().requires_grad_(), y.clone().requires_grad_()
    h = ops.huber_mean(xg, yg, 1.0)
    torch.testing.assert_close(h, ops._huber_mean_plain(x, y, 1.0), rtol=1e-5, atol=0.0)
    assert torch.equal(ops.huber_mean(x, y, 1.0), h)
    dx, dy = torch.autograd.grad(h, (xg, yg))
    want = torch.clamp(x.float() - y.float(), -1.0, 1.0) / n
    assert dx.dtype == dy.dtype == dtype
    torch.testing.assert_close(dx, want.to(dtype), rtol=ULP[dtype], atol=1e-12)
    torch.testing.assert_close(dy, (-want).to(dtype), rtol=ULP[dtype], atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("n", [128 * 5660, 128 * 40])
def test_huber_mean_misaligned_views(dev, dtype, n):
    x, y = (2 * _randn(dev, n + 1, seed=5)).to(dtype), _randn(dev, n + 1, seed=6).to(dtype)
    # one element in on both: a scalar head, then 16-byte loads; on x only:
    # the offsets differ, so every load is scalar
    for xv, yv in ((x[1:], y[1:]), (x[1:], y[:-1])):
        h = ops.huber_mean(xv, yv, 1.0)
        torch.testing.assert_close(h, ops._huber_mean_plain(xv, yv, 1.0), rtol=1e-5, atol=0.0)
        assert torch.equal(ops.huber_mean(xv, yv, 1.0), h)


def test_huber_mean_resets_its_counter(dev):
    """Grids of different sizes back to back on one stream: each call's last
    block must find the counter at 0."""
    calls = []
    for n in (T + 1, 128 * 5660, 128 * 40, T + 1, 128 * 5660):
        x, y = 2 * _randn(dev, n, seed=n), _randn(dev, n, seed=n + 1)
        calls.append((ops.huber_mean(x, y, 1.0), ops._huber_mean_plain(x, y, 1.0)))
    for h, want in calls:
        torch.testing.assert_close(h, want, rtol=1e-5, atol=0.0)


def test_huber_mean_on_two_streams(dev):
    """Each stream has its own workspace, so interleaved calls on two
    streams stay right and bit-equal to themselves."""
    n = 128 * 5660
    inputs = [(2 * _randn(dev, n, seed=s), _randn(dev, n, seed=s + 1)) for s in (7, 9)]
    wants = [ops._huber_mean_plain(x, y, 1.0) for x, y in inputs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(20):
        for i, (stream, (x, y)) in enumerate(zip(streams, inputs)):
            with torch.cuda.stream(stream):
                got[i].append(ops.huber_mean(x, y, 1.0))
    torch.cuda.synchronize()
    for hs, want in zip(got, wants):
        torch.testing.assert_close(hs[0], want, rtol=1e-5, atol=0.0)
        assert all(torch.equal(h, hs[0]) for h in hs)
    keys = {k for k in ops._HUBER_WORKSPACES if k[1] in {s.cuda_stream for s in streams}}
    assert len(keys) == 2


# K3w at the tag_unroll.train_w8 cell's shapes (W·B = 32,768 rows of the
# state's 5,660 and the reward's 40 columns), at ragged and narrow rows
WSUM_SHAPES = [(32768, 5660), (32768, 40), (1001, 26), (7, 3), (1, 1), (1, 5660), (T // 8 + 1, 8)]


def _mask(dev, rows, seed):
    return (torch.rand(rows, generator=torch.Generator(device=dev).manual_seed(seed), device=dev) < 0.7).float()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", WSUM_SHAPES, ids=str)
def test_huber_rows_wsum(dev, shape, dtype):
    rows, d = shape
    x, y = (2 * _randn(dev, rows, d, seed=5)).to(dtype), _randn(dev, rows, d, seed=6).to(dtype)
    w = _mask(dev, rows, 7)
    profiling.reset_counters()
    xg = x.clone().requires_grad_()
    h = ops.huber_rows_wsum(xg, y, w, 1.0)
    torch.testing.assert_close(h, ops._huber_rows_wsum_plain(x, y, w, 1.0), rtol=1e-5, atol=0.0)
    assert torch.equal(ops.huber_rows_wsum(x, y, w, 1.0), h)  # a fixed sum order
    assert profiling.counters() == {"k3w.launches": 2}
    (dx,) = torch.autograd.grad(h, xg)
    want = torch.clamp(x.float() - y.float(), -1.0, 1.0) * (w / d)[:, None]
    assert dx.dtype == dtype
    torch.testing.assert_close(dx, want.to(dtype), rtol=ULP.get(dtype, 1e-6), atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_huber_rows_wsum_misaligned_views(dev, dtype):
    rows, d = 4096, 40
    flat_x, flat_y = (2 * _randn(dev, rows * d + 1, seed=5)).to(dtype), _randn(dev, rows * d + 1, seed=6).to(dtype)
    w = _mask(dev, rows, 8)
    # one element in on both: a scalar head, then 16-byte packs straddling
    # rows; on x only: every load scalar
    for xv, yv in ((flat_x[1:], flat_y[1:]), (flat_x[1:], flat_y[:-1])):
        xv, yv = xv.view(rows, d), yv.view(rows, d)
        h = ops.huber_rows_wsum(xv, yv, w, 1.0)
        torch.testing.assert_close(h, ops._huber_rows_wsum_plain(xv, yv, w, 1.0), rtol=1e-5, atol=0.0)
        assert torch.equal(ops.huber_rows_wsum(xv, yv, w, 1.0), h)


def test_huber_rows_wsum_and_k3_share_the_workspace(dev):
    """K3 and K3w calls of several grid sizes back to back on one stream:
    each call's last block must find the shared counter at 0."""
    calls = []
    for rows, d in ((T // 26 + 1, 26), (32768, 40), (4096, 5660), (3, 3), (32768, 40)):
        x, y = 2 * _randn(dev, rows, d, seed=rows), _randn(dev, rows, d, seed=rows + 1)
        w = _mask(dev, rows, rows + 2)
        calls.append((ops.huber_rows_wsum(x, y, w, 1.0), ops._huber_rows_wsum_plain(x, y, w, 1.0)))
        calls.append((ops.huber_mean(x, y, 1.0), ops._huber_mean_plain(x, y, 1.0)))
    for h, want in calls:
        torch.testing.assert_close(h, want, rtol=1e-5, atol=0.0)


def test_unroll_step_routes_agree_on_the_card(dev):
    """One unroll step (W = 3, episode ends inside the windows) by the
    plain route and by the kernel route: K1/K2 in each window step, K3w on
    both pooled branches, no K3."""
    from mfvae_tpu_torch.data.transitions import GroupedTransition
    from mfvae_tpu_torch.training.unroll import make_unroll_train_step

    agents = ("adversary_0", "adversary_1", "agent_0")
    spec = AgentSpec.from_dicts(agents, {"adversary_0": 10, "adversary_1": 10, "agent_0": 6}, {a: 5 for a in agents})
    cfg = ModelConfig(idx_features=8, obs_features=8, action_features=8, encoder_hidden=(16,),
                      decoder_hidden=(32,), compute_dtype="float32", residual_state=True, state_skip=True)
    b, w = 16, 3
    g = torch.Generator(device=dev).manual_seed(0)
    done = torch.zeros(b, w, device=dev)
    done[0, 0] = done[3, 1] = 1.0
    windows = GroupedTransition(
        obs=(torch.randn(b, w, 2, 10, generator=g, device=dev), torch.randn(b, w, 1, 6, generator=g, device=dev)),
        actions=(torch.randint(0, 5, (b, w, 2), generator=g, device=dev),
                 torch.randint(0, 5, (b, w, 1), generator=g, device=dev)),
        next_obs=(torch.randn(b, w, 2, 10, generator=g, device=dev), torch.randn(b, w, 1, 6, generator=g, device=dev)),
        rewards=torch.randn(b, w, 3, generator=g, device=dev), done=done,
    )
    eps = torch.randn(w, b, 3, 8, generator=g, device=dev)
    init = MAVAE.from_config(cfg, spec, device=dev, generator=torch.Generator(device=dev).manual_seed(1)).state_dict()
    results = []
    for use_pallas in (False, True):
        model = MAVAE.from_config(cfg, spec, device=dev)
        model.load_state_dict(init)
        state = create_train_state(model, TrainConfig(grad_clip=0.5))
        profiling.reset_counters()
        state, out = make_unroll_train_step(spec, LossConfig(), w, use_pallas=use_pallas)(state, windows, eps=eps)
        results.append((out, state.model.state_dict(), profiling.counters()))
    (o1, p1, l1), (o2, p2, l2) = results
    assert l1 == {} and l2 == {"k1.launches": w, "k2.launches": w, "k3w.launches": 2}
    for a, b_ in zip(o1, o2):
        torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-6)
    for name in p1:
        torch.testing.assert_close(p1[name], p2[name], rtol=1e-4, atol=1e-5)


def test_wrappers_refuse_on_the_card(dev):
    x = torch.zeros(4, 8, device=dev)
    with pytest.raises(TypeError):
        ops.huber_mean(x.double(), x.double())
    with pytest.raises(ValueError):
        ops.fused_reparam_kl(x, x, x.cpu())


def test_train_step_routes_agree_on_the_card(dev):
    agents = ("adversary_0", "adversary_1", "agent_0")
    spec = AgentSpec.from_dicts(agents, {"adversary_0": 10, "adversary_1": 10, "agent_0": 6}, {a: 5 for a in agents})
    cfg = ModelConfig(idx_features=8, obs_features=8, action_features=8, encoder_hidden=(16,),
                      decoder_hidden=(32,), compute_dtype="float32")
    g = torch.Generator(device=dev).manual_seed(0)
    batch = VaeBatch(
        inputs=GroupedBatch(
            obs=(torch.randn(8, 2, 10, generator=g, device=dev), torch.randn(8, 1, 6, generator=g, device=dev)),
            actions=(torch.randint(0, 5, (8, 2), generator=g, device=dev), torch.randint(0, 5, (8, 1), generator=g, device=dev)),
        ),
        next_state=torch.randn(8, 26, generator=g, device=dev),
        rewards=torch.randn(8, 3, generator=g, device=dev),
    )
    init = MAVAE.from_config(cfg, spec, device=dev, generator=torch.Generator(device=dev).manual_seed(1)).state_dict()
    results = []
    for use_pallas in (False, True):
        model = MAVAE.from_config(cfg, spec, device=dev)
        model.load_state_dict(init)
        state = create_train_state(model, TrainConfig())
        profiling.reset_counters()
        state, out = make_train_step(LossConfig(), use_pallas=use_pallas)(
            state, batch, torch.Generator(device=dev).manual_seed(2)
        )
        results.append((out, state.model.state_dict(), profiling.counters()))
    (o1, p1, l1), (o2, p2, l2) = results
    assert l1 == {} and l2 == {"k1.launches": 1, "k2.launches": 1, "k3.launches": 2}
    for a, b in zip(o1, o2):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    for name in p1:
        torch.testing.assert_close(p1[name], p2[name], rtol=1e-4, atol=1e-5)


def test_kernel_spans_cover_their_kernels_under_a_profiler(dev):
    """K1-K3's spans: one host event a launch under the profiler (K2's on
    autograd's thread), whose device-side range holds its one kernel."""
    from torch.profiler import ProfilerActivity, profile

    mu, lv, eps = (_randn(dev, 64, 40, 64, seed=s).requires_grad_(s < 2) for s in range(3))
    x, y = _randn(dev, 64, 5660, seed=3), _randn(dev, 64, 5660, seed=4)
    xr, yr = _randn(dev, 64, 40, seed=5), _randn(dev, 64, 40, seed=6)

    def step():
        z, kl = ops.fused_reparam_kl(mu, lv, eps)
        (z.sum() + kl.sum() + ops.huber_mean(x, y) + ops.huber_mean(xr, yr)).backward()

    step()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize(dev)
    events = prof.events()
    host = [e.name for e in events if e.device_type != torch.autograd.DeviceType.CUDA]
    assert {k: host.count(f"mfvae.{k}") for k in ("k1", "k2", "k3")} == {"k1": 3, "k2": 3, "k3": 6}
    kernels = {"k1": "reparam_kl_fwd_kernel", "k2": "reparam_kl_bwd_kernel", "k3": "huber_mean_kernel"}
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    for k, kname in kernels.items():
        ranges = [e.time_range for e in on_device if e.name == f"mfvae.{k}"]
        mine = [e.time_range for e in on_device if kname in e.name]
        assert len(ranges) == len(mine) == host.count(f"mfvae.{k}"), k
        for r in ranges:
            assert sum(r.start <= m.start and m.end <= r.end for m in mine) == 1, k


def test_k3w_span_covers_its_kernel_under_a_profiler(dev):
    """K3w's span: one host event a launch, whose device-side range holds
    its one kernel; no kernel of K3's name."""
    from torch.profiler import ProfilerActivity, profile

    x, y, w = _randn(dev, 256, 5660, seed=3), _randn(dev, 256, 5660, seed=4), _mask(dev, 256, 5)
    ops.huber_rows_wsum(x, y, w)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ops.huber_rows_wsum(x, y, w)
        torch.cuda.synchronize(dev)
    events = prof.events()
    assert [e.name for e in events if e.device_type != torch.autograd.DeviceType.CUDA].count("mfvae.k3w") == 3
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    ranges = [e.time_range for e in on_device if e.name == "mfvae.k3w"]
    mine = [e.time_range for e in on_device if "huber_rows_wsum_kernel" in e.name]
    assert len(ranges) == len(mine) == 3
    assert not [e for e in on_device if "huber_mean_kernel" in e.name]
    for r in ranges:
        assert sum(r.start <= m.start and m.end <= r.end for m in mine) == 1


def test_host_backend_launches_no_kernel_on_the_card(dev, tmp_path):
    """HostExperiment builds its train step without use_pallas, as the JAX
    package does: model.use_pallas=true launches none of K1-K3."""
    import math

    from mfvae_tpu_torch.config import ExperimentConfig
    from mfvae_tpu_torch.training.host_experiment import HostExperiment

    cfg = ExperimentConfig()
    cfg.env.backend = "host"
    cfg.env.num_good_agents, cfg.env.num_adversaries, cfg.env.num_obs = 1, 2, 1
    cfg.model.use_pallas = True
    cfg.buffer.min_size, cfg.buffer.batch_size = 4, 8
    cfg.train.epoch_num, cfg.train.sample_num, cfg.train.train_num = 2, 8, 2
    cfg.train.log_dir = str(tmp_path)
    exp = HostExperiment(cfg).setup()
    assert next(exp.train_state.model.parameters()).device.type == "cuda"
    profiling.reset_counters()
    result = exp.run()
    assert profiling.counters() == {}
    assert math.isfinite(result["loss_train"])


EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
B, T = 32, 5


def _tag_world_model(dev, discrete=True, use_pallas=False):
    from mfvae_tpu_torch.envs.mpe import make
    from mfvae_tpu_torch.training.experiment import build_spec

    cfg = load_config(str(EXAMPLES / "world_model.yaml"))
    cfg.model.discrete_act = discrete
    cfg.model.use_pallas = use_pallas
    e = cfg.env
    env = make(e.name, device=dev, num_good_agents=e.num_good_agents, num_adversaries=e.num_adversaries,
               num_obs=e.num_obs, max_steps=e.max_steps, discrete_actions=discrete)
    return MAVAE.from_config(cfg.model, build_spec(env), device=dev, generator=torch.Generator(device=dev).manual_seed(0))


def _request(model, dev, seed, b=B, t=T):
    """(start obs, plan) per group, as views of other strides, as the
    planners pass them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    obs = tuple(torch.randn(len(i), b, od, generator=g, device=dev).transpose(0, 1) for (od, _), i in model.spec.groups)
    if model.discrete_act:
        plan = tuple(torch.randint(0, ad, (t, b, 2 * len(i)), generator=g, device=dev)[..., ::2]
                     for (_, ad), i in model.spec.groups)
    else:
        plan = tuple(torch.rand(t, b, len(i), ad, generator=g, device=dev) * 2 - 1 for (_, ad), i in model.spec.groups)
    return obs, plan


def _eager(model, obs, plan):
    return inference.WorldModel(model)._rollout(obs, plan)  # a key's first request runs eagerly


def _equal(got, want):
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("discrete", [True, False], ids=["discrete", "continuous"])
def test_rollout_graph_replays_the_eager_loop(dev, discrete):
    model = _tag_world_model(dev, discrete)
    wm = inference.WorldModel(model)
    (obs_a, plan_a), (obs_b, plan_b) = _request(model, dev, 1), _request(model, dev, 2)
    want_a, want_b = _eager(model, obs_a, plan_a), _eager(model, obs_b, plan_b)
    profiling.reset_counters()
    _equal(wm._rollout(obs_a, plan_a), want_a)  # eager
    got_a = wm._rollout(obs_a, plan_a)  # captured, then replayed
    assert profiling.counters() == {"rollout.eager_steps": T, "rollout.graph_captures": 1, "rollout.graph_replays": T}
    kept = tuple(x.clone() for x in got_a)
    got_b = wm._rollout(obs_b, plan_b)
    _equal(got_a, want_a)
    _equal(got_b, want_b)
    _equal(got_a, kept)  # request 1's tensors after request 2
    _equal(wm._rollout(obs_b, tuple(p[:2] for p in plan_b)), tuple(x[:2] for x in want_b))  # another horizon
    assert profiling.counters()["rollout.graph_captures"] == 1


def test_rollout_graph_reads_updated_and_replaced_parameters(dev):
    model = _tag_world_model(dev)
    wm = inference.WorldModel(model)
    obs, plan = _request(model, dev, 3)
    for _ in range(2):
        wm._rollout(obs, plan)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.01)  # in place, as optimizer.step
    want = _eager(model, obs, plan)
    profiling.reset_counters()
    _equal(wm._rollout(obs, plan), want)
    assert profiling.counters() == {"rollout.graph_replays": T}
    model.reward_linear.kernel = torch.nn.Parameter(2 * model.reward_linear.kernel.detach())
    want = _eager(model, obs, plan)
    profiling.reset_counters()
    for _ in range(2):
        _equal(wm._rollout(obs, plan), want)
    # a new key: served eagerly, then captured
    assert profiling.counters() == {"rollout.eager_steps": T, "rollout.graph_captures": 1,
                                    "rollout.graph_replays": T}


def test_rollout_graph_keeps_the_newest_keys(dev):
    model = _tag_world_model(dev)
    wm = inference.WorldModel(model)
    sizes = [8, 16, 24, 32, 40]
    profiling.reset_counters()
    for b in sizes:
        obs, plan = _request(model, dev, b, b=b, t=2)
        for _ in range(2):
            wm._rollout(obs, plan)
    assert [key[1][0][0][0] for key in wm._graphs] == sizes[1:]
    assert profiling.counters() == {"rollout.eager_steps": 10, "rollout.graph_captures": 5, "rollout.graph_replays": 10}
    obs, plan = _request(model, dev, 0, b=8, t=2)
    wm._rollout(obs, plan)  # evicted: eager again
    assert profiling.counters()["rollout.eager_steps"] == 12
    obs64 = tuple(o.double() for o in obs)  # the refeed is float32: another start stays eager
    for _ in range(2):
        wm._rollout(obs64, plan)
    assert profiling.counters()["rollout.eager_steps"] == 16 and len(wm._graphs) == 4


def test_replayed_rollout_shows_its_kernels_and_spans_under_a_profiler(dev):
    from torch.profiler import ProfilerActivity, profile

    model = _tag_world_model(dev)
    obs, plan = _request(model, dev, 4)

    def traced(wm):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wm._rollout(obs, plan)
            torch.cuda.synchronize(dev)
        events = prof.events()
        host = [e.name for e in events if e.device_type != torch.autograd.DeviceType.CUDA]
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False) and not e.name.startswith(("Memcpy", "Memset"))]
        return host, len(kernels)

    host, eager = traced(inference.WorldModel(model))
    assert host.count("mfvae.rollout.step") == T and "mfvae.rollout.replay" not in host
    wm = inference.WorldModel(model)
    for _ in range(2):
        wm._rollout(obs, plan)
    host, replayed = traced(wm)
    assert host.count("mfvae.rollout.step") == host.count("mfvae.rollout.replay") == T
    assert "mfvae.rollout.refeed" not in host and "mfvae.rollout.capture" not in host
    # the graph's kernels (the step, its refeed) and the copies around it;
    # eagerly the strided start costs a few kernels more
    assert eager - 10 <= replayed <= eager + 6 * T + 2, (eager, replayed)


# ------------------------------------------------------------------- K4
K4_REL = 2.0**-19  # two sides, each within 2^-20 of the exact sum


def _k4_check(got, g, rows, **kw):
    """got against the plain version on the CPU, within K4_REL of the sums
    of the magnitudes each element adds."""
    cpu = {k: v.cpu() if torch.is_tensor(v) else v for k, v in kw.items()}
    want = lg._lookup_grad_plain(g.cpu(), rows, **cpu).double()
    mag = lg._lookup_grad_plain(g.cpu().abs(), rows, **cpu).double()
    assert bool(((got.cpu().double() - want).abs() <= K4_REL * mag).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [(4096, 30, 64, 5), (4096, 10, 64, 5), (4099, 7, 33, 8), (5, 3, 64, 1)], ids=str)
def test_lookup_grad(dev, shape, dtype):
    batch, cols, features, bins = shape
    gen = torch.Generator(device=dev).manual_seed(0)
    g = torch.randn(batch, cols, features, generator=gen, device=dev).to(dtype)
    idx = torch.randint(0, bins, (batch, cols), generator=gen, device=dev, dtype=torch.int32)
    pos = torch.randperm(cols + 3, generator=gen, device=dev)[:cols]
    profiling.reset_counters()
    for kw, rows in ((dict(pos=pos), cols + 3), (dict(idx=idx, bins=bins), cols * bins),
                     (dict(idx=idx.long(), bins=bins), cols * bins)):
        got = lg.lookup_grad(g, rows, **kw)
        assert torch.equal(lg.lookup_grad(g, rows, **kw), got)
        _k4_check(got, g, rows, **kw)
    assert profiling.counters() == {"k4.launches": 6}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_lookup_grad_reads_a_misaligned_gradient(dev, dtype):
    """A contiguous view off a 16-byte boundary: K4 reads it element by element."""
    batch, cols, features = 4096, 30, 64
    gen = torch.Generator(device=dev).manual_seed(1)
    g = torch.randn(batch * cols * features + 1, generator=gen, device=dev).to(dtype)[1:].view(batch, cols, features)
    assert not lg.lookup_geometry(features, g.element_size(), g.data_ptr()).aligned
    idx = torch.randint(0, 5, (batch, cols), generator=gen, device=dev)
    for kw, rows in ((dict(pos=torch.arange(cols, device=dev)), 40), (dict(idx=idx, bins=5), cols * 5)):
        got = lg.lookup_grad(g, rows, **kw)
        assert torch.equal(lg.lookup_grad(g, rows, **kw), got)
        _k4_check(got, g, rows, **kw)


def test_lookup_grad_refuses_on_the_card(dev):
    g = torch.zeros(8, 3, 64, device=dev, dtype=torch.bfloat16)
    idx = torch.zeros(8, 3, device=dev, dtype=torch.int32)
    pos = torch.arange(3, device=dev)
    with pytest.raises(ValueError):
        lg.lookup_grad(g, 3 * (lg.MAX_BINS + 1), idx=idx, bins=lg.MAX_BINS + 1)
    with pytest.raises(ValueError):
        lg.lookup_grad(g[:, :, ::2], 3, pos=pos)  # not contiguous
    with pytest.raises(TypeError):
        lg.lookup_grad(g.double(), 3, pos=pos)
    with pytest.raises(TypeError):
        lg.lookup_grad(g, 15, idx=idx.to(torch.int16), bins=5)
    with pytest.raises(ValueError):
        lg.lookup_grad(g, 3, pos=pos.cpu())


def _tag_batch(spec, dev, b, *window):
    """Random simple_tag inputs: a VaeBatch, or with ``window`` (W,) the
    windows of an unroll step."""
    from mfvae_tpu_torch.data.transitions import GroupedTransition

    gen = torch.Generator(device=dev).manual_seed(7)
    lead = (b, *window)

    def obs():
        return tuple(torch.randn(*lead, len(i), od, generator=gen, device=dev) for (od, _), i in spec.groups)

    act = tuple(torch.randint(0, ad, (*lead, len(i)), generator=gen, device=dev, dtype=torch.int32)
                for (_, ad), i in spec.groups)
    if window:
        return GroupedTransition(obs(), act, obs(), torch.randn(*lead, spec.n_agents, generator=gen, device=dev),
                                 torch.zeros(*lead, device=dev))
    return VaeBatch(GroupedBatch(obs(), act), torch.randn(b, sum(spec.obs_dims), generator=gen, device=dev),
                    torch.randn(b, spec.n_agents, generator=gen, device=dev))


def test_k4_launches_over_a_train_step_an_unroll_step_and_a_rollout(dev):
    """tag_wm (simple_tag 30/10/20, model.use_pallas): a train step runs K4
    once a group for the agent-index embedding and once a group for the
    actions, 4; an unroll step of W = 8 32; a rollout (no backward) none."""
    from mfvae_tpu_torch.training.unroll import make_unroll_train_step

    model = _tag_world_model(dev, use_pallas=True)
    spec, loss = model.spec, load_config(str(EXAMPLES / "world_model.yaml")).loss
    state = create_train_state(model, TrainConfig())
    profiling.reset_counters()
    make_train_step(loss, use_pallas=True)(state, _tag_batch(spec, dev, 64), torch.Generator(device=dev).manual_seed(1))
    assert profiling.counters() == {"k1.launches": 1, "k2.launches": 1, "k3.launches": 2, "k4.launches": 4}
    profiling.reset_counters()
    make_unroll_train_step(spec, loss, 8, use_pallas=True)(state, _tag_batch(spec, dev, 64, 8),
                                                           torch.Generator(device=dev).manual_seed(2))
    assert profiling.counters() == {"k1.launches": 8, "k2.launches": 8, "k3w.launches": 2, "k4.launches": 32}
    wm = inference.WorldModel(model)
    obs, plan = _request(model, dev, 5)
    profiling.reset_counters()
    for _ in range(3):  # eager, captured, replayed
        wm._rollout(obs, plan)
    assert "k4.launches" not in profiling.counters()


def test_a_profiled_train_step_runs_k4_and_no_indexing_backward(dev):
    from torch.profiler import ProfilerActivity, profile

    model = _tag_world_model(dev, use_pallas=True)
    state = create_train_state(model, TrainConfig())
    step = make_train_step(load_config(str(EXAMPLES / "world_model.yaml")).loss, use_pallas=True)
    batch, gen = _tag_batch(model.spec, dev, 256), torch.Generator(device=dev).manual_seed(3)
    step(state, batch, gen)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch, gen)
        torch.cuda.synchronize(dev)
    events = prof.events()
    on_device = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    assert not [n for n in on_device if "indexing_backward" in n]
    assert sum("lookup_grad_kernel" in n for n in on_device) == 4
    assert [e.name for e in events if e.device_type != torch.autograd.DeviceType.CUDA].count("mfvae.k4") == 4
