"""Process grids over torch.distributed (mirror of ``mfvae_tpu/parallel/mesh.py``).

The JAX package lays one SPMD program over a ('data','model') device mesh
and lets XLA insert the collectives.  Here each rank is one process and
the collectives are explicit: a ``Mesh`` is the grid of ranks, with one
process group per row and column, and the few collectives the port needs
(sum, gather, broadcast, the ring shift of the pipeline).  The innermost
axis varies fastest over the ranks (rank = d·n_model + m), as JAX reshapes
its device list, so a model group is a run of neighbouring ranks.

Without a process group the mesh has world size 1 and every collective
returns its input: ``python -m mfvae_tpu_torch examples/data_parallel.yaml``
runs so on one card, as the JAX package's mesh over one device does.

Gloo runs ``all_reduce`` and ``broadcast`` on CUDA tensors itself and
refuses the others (all_gather, send/recv); those are staged through pinned
host memory, and the mesh records their names in ``staged``.  Half-precision
tensors travel as float32 (gloo's CPU kernels are not defined for every
half type, and a sum of bf16 partials loses bits in bf16).
"""

from __future__ import annotations

import math
import os
from datetime import timedelta
from typing import Dict, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# the collectives gloo runs on CUDA tensors without a host copy
_GLOO_ON_DEVICE = frozenset({"all_reduce", "broadcast"})


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = 600.0,
) -> None:
    """Join the process group; call once per process before ``make_mesh``.

    With no arguments it reads torchrun's environment (env://); otherwise
    ``coordinator_address`` is ``host:port`` of rank 0's store (tcp://).
    The backend defaults to NCCL with a card and gloo without.  Each rank's
    current CUDA device becomes cuda:{local rank % device count} (the local
    rank is torchrun's ``LOCAL_RANK``, else the rank), so ranks beyond the
    host's cards share them: two ranks on a one-card host both use cuda:0.
    Every collective gives up after ``timeout_s`` seconds."""
    given = (coordinator_address, num_processes, process_id)
    if all(a is None for a in given):
        init_method, kw = "env://", {}
    elif any(a is None for a in given):
        raise ValueError("init_distributed needs coordinator_address, num_processes and process_id together")
    else:
        init_method = f"tcp://{coordinator_address}"
        kw = {"world_size": int(num_processes), "rank": int(process_id)}
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        local_rank = int(os.environ.get("LOCAL_RANK", kw.get("rank", 0)))
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, timeout=timedelta(seconds=timeout_s), **kw)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor a collective sends: half types as float32, bools as
    bytes, contiguous."""
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.to(torch.float32)
    elif t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return t.contiguous()


class Mesh:
    """A grid of ranks with named axes, outermost first (``shape`` is
    ordered), and one process group per axis line through this rank.

    ``Mesh({'data': 2, 'model': 3})`` with no groups is a layout only: its
    collectives raise.  ``make_mesh`` and ``pp.make_pipe_mesh`` build the
    live ones."""

    def __init__(self, shape: Dict[str, int], rank: int = 0, groups: Optional[Dict[str, object]] = None,
                 backend: Optional[str] = None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.rank = rank
        self.groups = dict(groups or {})
        self.backend = backend
        self.staged = set()  # names of the collectives that went through host memory
        self.coords = {}
        rest = rank
        for name in reversed(self.axis_names):
            self.coords[name] = rest % self.shape[name]
            rest //= self.shape[name]

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"

    def __deepcopy__(self, memo):
        # process groups cannot be copied; a copied model keeps the mesh
        return self

    # ------------------------------------------------------------ data layout
    def local_rows(self, x: torch.Tensor, axis: str = DATA_AXIS, n_batches: int = 1) -> torch.Tensor:
        """This rank's rows of ``x`` [n_batches · n · R, ...] laid out as
        n_batches blocks of n equal parts along ``axis`` (n its size):
        part ``index(axis)`` of every block, [n_batches · R, ...]."""
        n = self.shape[axis]
        if n == 1:
            return x
        return x.unflatten(0, (n_batches, n, -1))[:, self.index(axis)].flatten(0, 1)

    # ------------------------------------------------------------ collectives
    def _group(self, axis: Optional[str]):
        if axis is None:
            return None  # the world
        if axis not in self.groups:
            raise RuntimeError(f"{self!r} has no process group for axis {axis!r}")
        return self.groups[axis]

    def _staged(self, name: str, t: torch.Tensor) -> bool:
        if t.is_cuda and self.backend == "gloo" and name not in _GLOO_ON_DEVICE:
            self.staged.add(name)
            return True
        return False

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``t`` over ``axis``, as a new tensor (``t`` itself when
        the axis has one rank)."""
        if self.shape[axis] == 1:
            return t
        out = _wire(t).clone()
        dist.all_reduce(out, group=self._group(axis))
        return out.to(t.dtype)

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any rank of the mesh (a host sync)."""
        if self.size == 1:
            return flag
        t = torch.tensor([float(flag)], device="cuda" if self.backend == "nccl" else "cpu")
        for axis in self.axis_names:
            t = self.all_reduce(t, axis)
        return bool(t.item() > 0)

    def all_gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The ranks' ``t`` along ``axis`` concatenated on ``dim``, in axis order."""
        n = self.shape[axis]
        if n == 1:
            return t
        w = _wire(t)
        if self._staged("all_gather", w):
            w = w.cpu().pin_memory()
        parts = [torch.empty_like(w) for _ in range(n)]
        dist.all_gather(parts, w, group=self._group(axis))
        return torch.cat(parts, dim=dim).to(device=t.device, dtype=t.dtype)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` overwritten in place with world rank ``src``'s."""
        if self.size == 1 and not dist.is_initialized():
            return t
        w = _wire(t)
        dist.broadcast(w, src=src)
        if w is not t:
            t.copy_(w)
        return t

    def shift(self, t: torch.Tensor, axis: str, offset: int) -> torch.Tensor:
        """The ring permutation along ``axis``: index i sends ``t`` to
        i + offset (mod n) and returns what i − offset sent (JAX's
        ``ppermute`` with the pairs (i, i + offset))."""
        n = self.shape[axis]
        if n == 1:
            return t
        w = _wire(t)
        if self._staged("send/recv", w):
            w = w.cpu().pin_memory()
        recv = torch.empty_like(w)
        i = self.index(axis)
        ops = [dist.P2POp(dist.isend, w, self._peer(axis, (i + offset) % n)),
               dist.P2POp(dist.irecv, recv, self._peer(axis, (i - offset) % n))]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv.to(device=t.device, dtype=t.dtype)

    def _peer(self, axis: str, index: int) -> int:
        """The world rank at ``index`` on this rank's line along ``axis``."""
        coords = dict(self.coords, **{axis: index})
        rank = 0
        for name in self.axis_names:
            rank = rank * self.shape[name] + coords[name]
        return rank


def _grid_groups(shape: Dict[str, int], rank: int) -> Dict[str, object]:
    """One process group per axis line through ``rank``.  Every rank calls
    ``new_group`` for every line, in one order, as torch.distributed asks."""
    names = tuple(shape)
    sizes = [shape[a] for a in names]
    ranks = torch.arange(math.prod(sizes)).reshape(sizes)
    groups = {}
    for k, axis in enumerate(names):
        if sizes[k] == 1:
            continue
        lines = ranks.movedim(k, -1).reshape(-1, sizes[k]).tolist()
        for line in lines:
            g = dist.new_group(line)
            if rank in line:
                groups[axis] = g
    return groups


def make_grid(shape: Dict[str, int]) -> Mesh:
    """The live mesh of ``shape`` over the first prod(shape) ranks of the
    world (world size 1 without a process group)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = math.prod(shape.values())
    if n > world:
        raise ValueError(f"need {n} devices, have {world}")
    if not dist.is_initialized():
        return Mesh(shape)
    rank = dist.get_rank()
    groups = _grid_groups(shape, rank)
    if rank >= n:
        raise ValueError(f"rank {rank} lies outside the {shape} mesh")
    return Mesh(shape, rank, groups, dist.get_backend())


def make_mesh(n_data: int = -1, n_model: int = 1) -> Mesh:
    """The ('data','model') mesh; ``n_data=-1`` takes world // n_model."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data == -1:
        if world % n_model:
            raise ValueError(f"world size {world} is not divisible by n_model {n_model}")
        n_data = world // n_model
    return make_grid({DATA_AXIS: n_data, MODEL_AXIS: n_model})
