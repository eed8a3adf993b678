"""The port's GPipe pipeline (``mfvae_tpu_torch/parallel/pp.py``) against
the JAX package's, on the same numpy parameters: JAX in this process on
conftest's CPU mesh, the port over 2 and 4 gloo ranks (``spawn_ranks``,
tests/test_torch_parallel.py).  Forward and gradients within atol 1e-6:
float32 products and sums in another order.

- ``pipeline_apply`` over 2 and 4 stages, and over a 2 × 2 ('data',
  'pipe') grid with ``data_parallel``; the loss's gradients for the
  stacked kernels, biases and the input;
- ``pipelined_mlp`` (fc0, a 4-layer uniform body over the stages, 'out')
  and its gradients for every layer;
- the output does not depend on the microbatch count, every rank returns
  the whole output, and a stage count other than the mesh's is refused.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mfvae_tpu_torch.parallel.mesh import Mesh
from mfvae_tpu_torch.parallel.pp import (
    PipelineParams,
    init_pipeline_params,
    make_pipe_mesh,
    pipeline_apply,
    pipeline_param_shardings,
    pipelined_mlp,
    sequential_apply,
)
from tests.test_torch_experiment import one_torch_thread  # noqa: F401
from tests.test_torch_parallel import spawn_ranks

L, W, B, M = 2, 8, 16, 4


def numpy_case(n_stages: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    mlp = {f"fc{i}": {"kernel": (rng.normal(size=(W, W)) / np.sqrt(W)).astype(np.float32),
                      "bias": (0.1 * rng.normal(size=W)).astype(np.float32)} for i in range(5)}
    mlp["out"] = {"kernel": rng.normal(size=(W, 3)).astype(np.float32), "bias": np.zeros(3, np.float32)}
    return {
        "kernel": (rng.normal(size=(n_stages, L, W, W)) / np.sqrt(W)).astype(np.float32),
        "bias": (0.1 * rng.normal(size=(n_stages, L, W))).astype(np.float32),
        "x": rng.normal(size=(B, W)).astype(np.float32),
        "target": rng.normal(size=(B, W)).astype(np.float32),
        "mlp": mlp,
    }


def _torch_case(case):
    def leaf(a):
        return torch.tensor(a, requires_grad=True)

    params = PipelineParams(leaf(case["kernel"]), leaf(case["bias"]))
    mlp = {k: {n: leaf(v) for n, v in layer.items()} for k, layer in case["mlp"].items()}
    return params, leaf(case["x"]), torch.from_numpy(case["target"]), mlp


def _pipeline_grads(params, x, target, mesh, m, data_parallel=False) -> dict:
    y = pipeline_apply(params, x, mesh, m, data_parallel=data_parallel)
    loss = torch.mean((y - target) ** 2)
    loss.backward()
    return {"y": y.detach().numpy(), "loss": float(loss), "kernel": params.kernel.grad.numpy(),
            "bias": params.bias.grad.numpy(), "x": x.grad.numpy()}


def _mlp_grads(mlp, x, mesh, m, data_parallel=False) -> dict:
    y = pipelined_mlp(mlp, x, mesh, m, data_parallel=data_parallel)
    loss = torch.sum(y ** 2)
    loss.backward()
    return {"y": y.detach().numpy(), "loss": float(loss),
            **{f"{k}/{n}": t.grad.numpy() for k, layer in mlp.items() for n, t in layer.items()}}


def _pp_rank(rank, cases, world):
    out = {}
    if world == 2:
        mesh = make_pipe_mesh(2)
        for m in (2, M):
            out[f"apply M={m}"] = _pipeline_grads(*_torch_case(cases[2])[:3], mesh, m)
        params, x, _, mlp = _torch_case(cases[2])
        out["mlp"] = _mlp_grads(mlp, x, mesh, M)
    else:
        out["apply"] = _pipeline_grads(*_torch_case(cases[4])[:3], make_pipe_mesh(4), M)
        grid = make_pipe_mesh(2, n_data=2)
        out["dp apply"] = _pipeline_grads(*_torch_case(cases[2])[:3], grid, M // 2, data_parallel=True)
        params, x, _, mlp = _torch_case(cases[2])
        out["dp mlp"] = _mlp_grads(mlp, x, grid, M // 2, data_parallel=True)
    return out


def _jax_reference(case, n_pipe, n_data, m, data_parallel=False):
    import jax
    import jax.numpy as jnp

    from mfvae_tpu.parallel import pp as jpp

    mesh = jpp.make_pipe_mesh(n_pipe=n_pipe, n_data=n_data)
    params = jpp.PipelineParams(jnp.asarray(case["kernel"]), jnp.asarray(case["bias"]))

    def loss(p, x):
        y = jpp.pipeline_apply(p, x, mesh=mesh, n_microbatches=m, data_parallel=data_parallel)
        return jnp.mean((y - case["target"]) ** 2), y

    (lv, y), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(case["x"]))
    apply = {"y": y, "loss": lv, "kernel": gp.kernel, "bias": gp.bias, "x": gx}

    def mlp_loss(p, x):
        y = jpp.pipelined_mlp(p, x, mesh=mesh, n_microbatches=m, data_parallel=data_parallel)
        return jnp.sum(y ** 2), y

    tree = jax.tree.map(jnp.asarray, case["mlp"])
    (lv, y), g = jax.jit(jax.value_and_grad(mlp_loss, has_aux=True))(tree, jnp.asarray(case["x"]))
    mlp = {"y": y, "loss": lv, **{f"{k}/{n}": g[k][n] for k in g for n in g[k]}}
    return apply, mlp


def _close(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-6, rtol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def cases():
    return {2: numpy_case(2), 4: numpy_case(4, seed=1)}


@pytest.fixture(scope="module")
def two_ranks(cases, tmp_path_factory):
    return spawn_ranks(_pp_rank, 2, tmp_path_factory.mktemp("pp2"), cases, 2)


@pytest.fixture(scope="module")
def four_ranks(cases, tmp_path_factory):
    return spawn_ranks(_pp_rank, 4, tmp_path_factory.mktemp("pp4"), cases, 4)


def test_two_stages_match_jax(cases, two_ranks):
    apply, mlp = _jax_reference(cases[2], 2, 1, M)
    for r in two_ranks:
        _close(r[f"apply M={M}"], apply)
        _close(r["mlp"], mlp)


def test_four_stages_and_the_dp_grid_match_jax(cases, four_ranks):
    apply, _ = _jax_reference(cases[4], 4, 1, M)
    dp_apply, dp_mlp = _jax_reference(cases[2], 2, 2, M // 2, data_parallel=True)
    for r in four_ranks:
        _close(r["apply"], apply)
        _close(r["dp apply"], dp_apply)
        _close(r["dp mlp"], dp_mlp)


def test_microbatch_count_invariance(two_ranks):
    for r in two_ranks:
        np.testing.assert_allclose(r["apply M=2"]["y"], r[f"apply M={M}"]["y"], atol=1e-6)
        np.testing.assert_allclose(r["apply M=2"]["kernel"], r[f"apply M={M}"]["kernel"], atol=1e-6)


def test_one_rank_matches_sequential_apply(cases):
    """A world-1 pipe mesh runs the whole body as one stage."""
    params, x, target, _ = _torch_case(cases[2])
    one = PipelineParams(params.kernel.detach().reshape(1, 2 * L, W, W), params.bias.detach().reshape(1, 2 * L, W))
    y = pipeline_apply(one, x, make_pipe_mesh(1), M)
    np.testing.assert_allclose(y.detach().numpy(), sequential_apply(params, x).detach().numpy(), atol=1e-6)


def test_wrong_stage_count_refused(cases):
    params, x, _, _ = _torch_case(cases[4])
    with pytest.raises(ValueError, match="4 stages"):
        pipeline_apply(params, x, Mesh({"data": 1, "pipe": 2}), M)


def test_init_and_placements():
    p = init_pipeline_params(torch.Generator().manual_seed(0), 4, L, W)
    assert p.n_stages == 4 and p.layers_per_stage == L and p.width == W
    assert torch.equal(p.bias, torch.zeros(4, L, W))
    # lecun-normal: truncated at 2 sigma of 1/sqrt(fan_in), each slice its own draw
    assert float(p.kernel.abs().max()) <= 2 / np.sqrt(W) / 0.8796 + 1e-6
    assert not torch.equal(p.kernel[0, 0], p.kernel[0, 1])
    mesh = Mesh({"data": 1, "pipe": 4})
    sh = pipeline_param_shardings(p, mesh)
    assert tuple(sh.kernel.spec) == ("pipe",) and tuple(sh.bias.spec) == ("pipe",)
