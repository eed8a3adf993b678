"""Device-resident replay buffer (mirror of ``mfvae_tpu/data/buffer.py``'s
``ItemBuffer``).

The data is a tree (nested tuples / NamedTuples) of tensors with a leading
[capacity] axis on the run's device.  Unlike the JAX buffer, which returns
a new state from every pure call, ``add``/``add_batch`` write into the
state's tensors in place (one copy instead of a fresh capacity-sized
buffer per step) and return the state with its host-side ``cursor`` and
``size`` advanced.  The host counts every add, so it knows both numbers
without reading the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leaf-wise over tensors nested in tuples/NamedTuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, tuple):
        mapped = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*mapped) if hasattr(tree, "_fields") else tuple(mapped)
    raise TypeError(f"unsupported tree node {type(tree)!r}")


def tree_leaves(tree: Tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for sub in tree for leaf in tree_leaves(sub)]


class BufferState(NamedTuple):
    """data: tree with leading [capacity, ...] axes; cursor: next write
    position; size: valid entries."""

    data: Tree
    cursor: int
    size: int


class SampleBatch(NamedTuple):
    experience: Tree


@dataclass(frozen=True)
class ItemBuffer:
    """Uniform-sampling FIFO ring over single items or item batches."""

    max_length: int
    min_length: int = 64
    sample_batch_size: int = 64

    def init(self, example_item: Tree) -> BufferState:
        data = tree_map(
            lambda x: torch.zeros((self.max_length, *x.shape), dtype=x.dtype, device=x.device),
            example_item,
        )
        return BufferState(data=data, cursor=0, size=0)

    def add(self, state: BufferState, item: Tree) -> BufferState:
        def write(buf, x):
            buf[state.cursor] = x

        tree_map(write, state.data, item)
        return BufferState(
            data=state.data,
            cursor=(state.cursor + 1) % self.max_length,
            size=min(state.size + 1, self.max_length),
        )

    def add_batch(self, state: BufferState, items: Tree) -> BufferState:
        """Write a [B, ...] batch at the cursor, wrapping around."""
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
        defaults to ``sample_batch_size``; the eval phase draws all of its
        steps' batches in one call."""
        n = self.sample_batch_size if batch_size is None else batch_size
        device = tree_leaves(state.data)[0].device
        idx = torch.randint(0, max(state.size, 1), (n,), generator=generator, device=device)
        return SampleBatch(experience=tree_map(lambda buf: buf.index_select(0, idx), state.data))
