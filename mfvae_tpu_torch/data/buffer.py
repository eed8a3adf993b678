"""Device-resident replay buffers (mirror of ``mfvae_tpu/data/buffer.py``'s
``ItemBuffer`` and ``TrajectoryBuffer``).

The data is a tree (nested tuples, NamedTuples and dicts) of tensors with
a leading [capacity] axis on the run's device, or [shards, capacity] for
the batched epoch, where each of ``shards`` envs feeds its own shard (the JAX
package vmaps one buffer over that axis).  Unlike the JAX buffer, which
returns a new state from every pure call, ``add``/``add_batch`` write into
the state's tensors in place (one copy instead of a fresh capacity-sized
buffer per step) and return the state with its host-side ``cursor`` and
``size`` advanced.  The host counts every add, so it knows both numbers
without reading the device; the shards add in lockstep, so one cursor and
one size serve them all.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leaf-wise over tensors nested in tuples/NamedTuples
    and dicts."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        mapped = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*mapped) if hasattr(tree, "_fields") else tuple(mapped)
    raise TypeError(f"unsupported tree node {type(tree)!r}")


def tree_leaves(tree: Tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    subs = tree.values() if isinstance(tree, dict) else tree
    return [leaf for sub in subs for leaf in tree_leaves(sub)]


class BufferState(NamedTuple):
    """data: tree with leading [capacity, ...] (or [shards, capacity, ...])
    axes; cursor: next write position; size: valid entries per shard."""

    data: Tree
    cursor: int
    size: int


class SampleBatch(NamedTuple):
    experience: Tree


def window_starts(a: torch.Tensor, b: torch.Tensor, size: int, cursor: int, capacity: int,
                  window: int, block: int) -> torch.Tensor:
    """Window start slots from the two uniform draws of ``sample_window``.

    With ``block``: start = a·block + b (a the block, b the offset in
    [0, block − window]), clamped into the valid prefix, so a caller off
    the phase-aligned invariant reads overlapping valid windows, never the
    zero tail.  Without: ``a`` counts from the oldest item once the ring
    is full (from the cursor), so no window crosses the write seam."""
    if block:
        return torch.clamp(a * block + b, max=max(size - window, 0))
    base = cursor if size >= capacity else 0
    return (base + a) % capacity


@dataclass(frozen=True)
class ItemBuffer:
    """Uniform-sampling FIFO ring over single items or item batches, with
    an optional leading axis of ``shards`` independent rings (0: none).

    Under data parallelism a rank holds shards [first_shard, first_shard +
    shards) of ``global_shards``: every draw is taken for all of them, from
    a generator in the same state on every rank, and the rank keeps its
    shards' part, so the ranks together draw what one ring of
    ``global_shards`` would."""

    max_length: int
    min_length: int = 64
    sample_batch_size: int = 64
    shards: int = 0
    global_shards: int = 0
    first_shard: int = 0

    def _lead(self) -> tuple:
        return (self.shards,) if self.shards else ()

    def _randint(self, high: int, n: int, generator, device) -> torch.Tensor:
        """Uniform [*lead, n] draws below ``high``, taken over the global shards."""
        if not self.global_shards:
            return torch.randint(0, high, self._lead() + (n,), generator=generator, device=device)
        idx = torch.randint(0, high, (self.global_shards, n), generator=generator, device=device)
        return idx[self.first_shard : self.first_shard + self.shards]

    def init(self, example_item: Tree) -> BufferState:
        """``example_item`` carries the [shards] axis when ``shards`` > 0."""
        k = len(self._lead())

        def zeros(x):
            return torch.zeros((*x.shape[:k], self.max_length, *x.shape[k:]), dtype=x.dtype, device=x.device)

        return BufferState(data=tree_map(zeros, example_item), cursor=0, size=0)

    def add(self, state: BufferState, item: Tree) -> BufferState:
        """Write one item (one per shard: leaves [shards, ...]) at the cursor."""

        def write(buf, x):
            if self.shards:
                buf[:, state.cursor] = x
            else:
                buf[state.cursor] = x

        tree_map(write, state.data, item)
        return BufferState(
            data=state.data,
            cursor=(state.cursor + 1) % self.max_length,
            size=min(state.size + 1, self.max_length),
        )

    def add_batch(self, state: BufferState, items: Tree) -> BufferState:
        """Write a [B, ...] batch at the cursor, wrapping around."""
        if self.shards:
            raise NotImplementedError("add_batch writes an unsharded ring")
        b = tree_leaves(items)[0].shape[0]
        device = tree_leaves(state.data)[0].device
        idx = (state.cursor + torch.arange(b, device=device)) % self.max_length

        def write(buf, x):
            buf[idx] = x.to(buf.dtype)

        tree_map(write, state.data, items)
        return BufferState(
            data=state.data,
            cursor=(state.cursor + b) % self.max_length,
            size=min(state.size + b, self.max_length),
        )

    def can_sample(self, state: BufferState) -> bool:
        return state.size >= self.min_length

    def sample(
        self,
        state: BufferState,
        generator: Optional[torch.Generator],
        batch_size: Optional[int] = None,
    ) -> SampleBatch:
        """Uniform with replacement over the valid prefix.  ``batch_size``
        (items per shard) defaults to ``sample_batch_size``; the eval phase
        draws all of its steps' batches in one call.  Sharded, each
        consecutive run of shards·sample_batch_size items is one batch of
        sample_batch_size items from every shard, as the JAX package's
        stratified global batch."""
        n = self.sample_batch_size if batch_size is None else batch_size
        device = tree_leaves(state.data)[0].device
        idx = self._randint(max(state.size, 1), n, generator, device)
        if self.shards:
            bs = self.sample_batch_size
            # [shards, n] -> [n / bs, shards, bs]: whole batches, each stratified
            idx = idx.reshape(self.shards, n // bs, bs).transpose(0, 1)
            rows = torch.arange(self.shards, device=device)[None, :, None]
            return SampleBatch(experience=tree_map(lambda buf: buf[rows, idx].flatten(0, 2), state.data))
        return SampleBatch(experience=tree_map(lambda buf: buf.index_select(0, idx), state.data))

    def sample_window(
        self,
        state: BufferState,
        generator: Optional[torch.Generator],
        window: int,
        block: int = 0,
    ) -> SampleBatch:
        """Sample runs of ``window`` consecutive items, leaves
        [shards·sample_batch_size, window, ...].

        Sequential adds write time-adjacent items at adjacent slots; the
        ring's write seam once full, and with ``block`` > 0 (which must
        divide max_length) every block boundary, break that adjacency and
        are kept out of the start distribution (``window_starts``).
        Episode ends inside a window are the caller's to mask."""
        if window > self.max_length:
            raise ValueError(f"window {window} exceeds the capacity {self.max_length}")
        if block and not (window <= block <= self.max_length and self.max_length % block == 0):
            raise ValueError(f"block {block} must lie in [window, capacity] and divide {self.max_length}")
        device = tree_leaves(state.data)[0].device
        n = self.sample_batch_size
        if block:
            a = self._randint(max(state.size // block, 1), n, generator, device)
            b = self._randint(block - window + 1, n, generator, device)
        else:
            full = state.size >= self.max_length
            n_starts = self.max_length - window + 1 if full else max(state.size - window + 1, 1)
            a = self._randint(n_starts, n, generator, device)
            b = None
        starts = window_starts(a, b, state.size, state.cursor, self.max_length, window, block)
        return SampleBatch(experience=self.gather_windows(state, starts, window))

    def gather_windows(self, state: BufferState, starts: torch.Tensor, window: int) -> Tree:
        """The windows at ``starts`` ([*lead, n]): leaves [shards·n, window, ...],
        shard-major."""
        idx = (starts[..., None] + torch.arange(window, device=starts.device)) % self.max_length
        if not self.shards:
            return tree_map(lambda buf: buf[idx], state.data)
        rows = torch.arange(self.shards, device=idx.device)[:, None, None]
        return tree_map(lambda buf: buf[rows, idx].flatten(0, 1), state.data)


@dataclass(frozen=True)
class TrajectoryBuffer:
    """Time-major trajectory ring for recurrent Q-learning.

    Leaves are [add_batch_size, time_capacity, ...] and the time axis is
    the ring: ``add`` writes a [add_batch_size, T, ...] chunk (one row per
    env) at the cursor, cast to the buffer's dtype; ``sample`` returns
    [sample_batch_size, sample_sequence_length, ...] windows at uniform
    (env row, start time).  Once the ring is full the starts count from the
    oldest step (the cursor), so no window crosses the write seam.  As in
    ``ItemBuffer``, writes are in place and ``cursor``/``size`` are host
    ints, so ``can_sample`` reads nothing from the device."""

    add_batch_size: int
    time_capacity: int
    min_length_time: int = 64
    sample_batch_size: int = 64
    sample_sequence_length: int = 8

    def init(self, example_step: Tree) -> BufferState:
        def make(x):
            return torch.zeros((self.add_batch_size, self.time_capacity) + tuple(x.shape), dtype=x.dtype,
                               device=x.device)

        return BufferState(data=tree_map(make, example_step), cursor=0, size=0)

    def add(self, state: BufferState, traj: Tree) -> BufferState:
        """traj leaves: [add_batch_size, T, ...]."""
        t = tree_leaves(traj)[0].shape[1]
        device = tree_leaves(state.data)[0].device
        idx = (state.cursor + torch.arange(t, device=device)) % self.time_capacity

        def write(buf, x):
            buf[:, idx] = x.to(buf.dtype)

        tree_map(write, state.data, traj)
        return BufferState(
            data=state.data,
            cursor=(state.cursor + t) % self.time_capacity,
            size=min(state.size + t, self.time_capacity),
        )

    def can_sample(self, state: BufferState) -> bool:
        return state.size >= max(self.min_length_time, self.sample_sequence_length)

    def draw_indices(self, state: BufferState, generator: Optional[torch.Generator]):
        """(rows [S], starts [S]) of one ``sample``: rows uniform over the
        env rows, starts uniform over the valid window starts."""
        device = tree_leaves(state.data)[0].device
        L, cap = self.sample_sequence_length, self.time_capacity
        full = state.size >= cap
        n_starts = cap - L + 1 if full else max(state.size - L + 1, 1)
        rows = torch.randint(0, self.add_batch_size, (self.sample_batch_size,), generator=generator, device=device)
        offs = torch.randint(0, n_starts, (self.sample_batch_size,), generator=generator, device=device)
        return rows, ((state.cursor if full else 0) + offs) % cap

    def sample(self, state: BufferState, generator: Optional[torch.Generator] = None,
               indices=None) -> SampleBatch:
        """Windows at ``indices`` = (rows, starts) or at a fresh draw."""
        rows, starts = self.draw_indices(state, generator) if indices is None else indices
        offs = torch.arange(self.sample_sequence_length, device=starts.device)
        time_idx = (starts[:, None] + offs) % self.time_capacity
        return SampleBatch(experience=tree_map(lambda buf: buf[rows[:, None], time_idx], state.data))
