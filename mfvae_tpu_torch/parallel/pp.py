"""Pipeline parallelism (GPipe schedule) over a 'pipe' mesh axis (mirror of
``mfvae_tpu/parallel/pp.py``).

Each rank owns one *stage* (a block of layers); microbatches stream
through the stages and activations hop to the next rank with ``ppermute``,
here ``Mesh.shift`` by +1 inside one ``autograd.Function`` whose backward
is the shift by −1.  So the loop is the JAX package's loop and autograd of
a pipelined forward is the reverse pipeline, with no schedule written for
the backward.

Schedule: GPipe fill-drain.  For S stages and M microbatches the loop runs
T = M + S − 1 ticks; at tick t stage s computes microbatch t − s (when
0 <= t − s < M).  Bubble fraction (S−1)/(M+S−1), so pick M >= ~4·S.  Every
rank runs every tick on every branch (selected with ``torch.where``, as
JAX's ``jnp.where``), so each rank's backward has the same collectives in
the same order.

MAVAE's decoder is 6 small MLP layers, far below the depth where PP beats
DP×TP, so PP is off in every shipped config, as in the JAX package; it
pipelines any uniform-width layer body (``pipelined_mlp``).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from mfvae_tpu_torch.models.layers import lecun_normal_
from mfvae_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, make_grid
from mfvae_tpu_torch.parallel.sharding import NamedSharding, P
from mfvae_tpu_torch.parallel.tp import copy, gather, reduce, scatter

PIPE_AXIS = "pipe"


class PipelineParams(NamedTuple):
    """Stacked per-stage parameters for a uniform-width ReLU body.

    kernel: [S, L, W, W], S stages of L layers each (each rank computes
            with its own stage's slice); bias: [S, L, W]."""

    kernel: torch.Tensor
    bias: torch.Tensor

    @property
    def n_stages(self) -> int:
        return self.kernel.shape[0]

    @property
    def layers_per_stage(self) -> int:
        return self.kernel.shape[1]

    @property
    def width(self) -> int:
        return self.kernel.shape[-1]


def init_pipeline_params(generator: Optional[torch.Generator], n_stages: int, layers_per_stage: int,
                         width: int, device=None) -> PipelineParams:
    """Lecun-normal kernels per (stage, layer) slice, as independently
    initialized Dense layers; zero biases."""
    kernel = torch.empty(n_stages * layers_per_stage, width, width, device=device)
    for k in kernel:
        lecun_normal_(k, width, generator)
    return PipelineParams(
        kernel=kernel.reshape(n_stages, layers_per_stage, width, width),
        bias=torch.zeros(n_stages, layers_per_stage, width, device=device),
    )


def sequential_apply(params: PipelineParams, x: torch.Tensor, activation=torch.relu) -> torch.Tensor:
    """Ground truth: all S·L layers in order on one rank."""
    s, l, w = params.n_stages, params.layers_per_stage, params.width
    k = params.kernel.reshape(s * l, w, w)
    b = params.bias.reshape(s * l, w)
    for i in range(s * l):
        x = activation(x @ k[i] + b[i])
    return x


def _stage_block(kernel, bias, h, activation):
    """One stage's L layers: kernel [L, W, W], bias [L, W]."""
    for i in range(kernel.shape[0]):
        h = activation(h @ kernel[i] + bias[i])
    return h


class _Shift(torch.autograd.Function):
    """ppermute by +1 along the axis; its transpose shifts by −1."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.shift(x, axis, +1)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.shift(g.contiguous(), ctx.axis, -1), None, None


def pipeline_apply(
    params: PipelineParams,
    x: torch.Tensor,
    mesh: Mesh,
    n_microbatches: int,
    activation: Callable = torch.relu,
    data_parallel: bool = False,
) -> torch.Tensor:
    """Pipelined forward of the uniform body: x [B, W] -> [B, W], the same
    whole tensor on every rank.

    Each rank computes with stage ``index('pipe')`` of ``params`` (its
    gradient gathered over 'pipe', so every rank holds the whole gradient,
    as JAX's of a replicated input).  With ``data_parallel`` each data row
    of the grid pipelines its own block of x (2-D DP×PP) and the outputs are
    gathered; B per data row must divide by ``n_microbatches``."""
    n_stages = mesh.shape[PIPE_AXIS]
    if params.n_stages != n_stages:
        raise ValueError(f"params have {params.n_stages} stages, the mesh's 'pipe' axis {n_stages}")
    kernel, bias = params.kernel, params.bias
    if data_parallel:
        # each data row sees its rows only: sum the param grads over 'data'
        kernel, bias = copy(kernel, mesh, DATA_AXIS), copy(bias, mesh, DATA_AXIS)
        x = scatter(x, mesh, DATA_AXIS, 0)
    kernel = scatter(kernel, mesh, PIPE_AXIS, 0)[0]  # [L, W, W], this rank's stage
    bias = scatter(bias, mesh, PIPE_AXIS, 0)[0]
    x = copy(x, mesh, PIPE_AXIS)  # stage 0 alone reads x: sum its grad over 'pipe'
    stage = mesh.index(PIPE_AXIS)
    b, w = x.shape
    m = n_microbatches
    if b % m:
        raise ValueError(f"batch {b} per data row does not divide into {m} microbatches")
    mb = x.reshape(m, b // m, w)
    first = torch.tensor(stage == 0, device=x.device)
    last = torch.tensor(stage == n_stages - 1, device=x.device)
    state = torch.zeros(b // m, w, dtype=x.dtype, device=x.device)
    outputs = [torch.zeros(b // m, w, dtype=x.dtype, device=x.device) for _ in range(m)]
    for t in range(m + n_stages - 1):
        # stage 0 ingests microbatch t (clipped: what it computes past the
        # fill is masked out below)
        h = torch.where(first, mb[min(t, m - 1)], state)
        out = _stage_block(kernel, bias, h, activation)
        # the last stage completes microbatch t − (S−1) at tick t
        oidx = min(max(t - (n_stages - 1), 0), m - 1)
        done = last & (t >= n_stages - 1)
        outputs[oidx] = torch.where(done, out, outputs[oidx])
        # S−1 -> 0 wraps; stage 0 ignores its incoming edge
        state = _Shift.apply(out, mesh, PIPE_AXIS)
    # the last stage holds the outputs: a sum of the one-hot contributions
    y = torch.where(last, torch.stack(outputs), torch.zeros((), dtype=x.dtype, device=x.device))
    y = reduce(y, mesh, PIPE_AXIS).reshape(b, w)
    return gather(y, mesh, DATA_AXIS, 0) if data_parallel else y


def mlp_body_to_pipeline(params: Dict[str, Dict[str, torch.Tensor]], n_stages: int) -> PipelineParams:
    """Restack the uniform-width hidden body fc1..fcN of an MLP's parameters
    ({'fc0': {'kernel', 'bias'}, ..., 'out': ...}, ``models/layers.py``
    names) into [S, L, W, W] / [S, L, W]; fc0 (the input projection) and
    'out' stay outside the pipeline."""
    body_names = sorted((k for k in params if k.startswith("fc") and k != "fc0"), key=lambda s: int(s[2:]))
    if not body_names:
        raise ValueError("MLP has no hidden body beyond fc0")
    if len(body_names) % n_stages:
        raise ValueError(f"{len(body_names)} body layers don't split into {n_stages} stages")
    kernels = torch.stack([params[n]["kernel"] for n in body_names])
    biases = torch.stack([params[n]["bias"] for n in body_names])
    w = kernels.shape[-1]
    if kernels.shape[-2] != w:
        raise ValueError(f"body is not uniform-width: {tuple(kernels.shape)}")
    lps = len(body_names) // n_stages
    return PipelineParams(kernel=kernels.reshape(n_stages, lps, w, w), bias=biases.reshape(n_stages, lps, w))


def pipelined_mlp(
    params: Dict[str, Dict[str, torch.Tensor]],
    x: torch.Tensor,
    mesh: Mesh,
    n_microbatches: int,
    activation: Callable = torch.relu,
    data_parallel: bool = False,
) -> torch.Tensor:
    """An MLP (fc0..fcN + 'out') with its uniform hidden body pipelined over
    'pipe'; fc0 and the head run replicated.  Differentiable end to end."""
    pp = mlp_body_to_pipeline(params, mesh.shape[PIPE_AXIS])
    h = activation(x @ params["fc0"]["kernel"] + params["fc0"]["bias"])
    h = pipeline_apply(pp, h, mesh, n_microbatches, activation=activation, data_parallel=data_parallel)
    return h @ params["out"]["kernel"] + params["out"]["bias"]


def make_pipe_mesh(n_pipe: int, n_data: int = 1) -> Mesh:
    """The ('data', 'pipe') mesh; 'pipe' innermost, so neighbouring stages
    are neighbouring ranks."""
    return make_grid({DATA_AXIS: n_data, PIPE_AXIS: n_pipe})


def pipeline_param_shardings(params: PipelineParams, mesh: Mesh) -> PipelineParams:
    """Each stage's slice on its pipeline rank."""
    return PipelineParams(kernel=NamedSharding(mesh, P(PIPE_AXIS)), bias=NamedSharding(mesh, P(PIPE_AXIS)))
