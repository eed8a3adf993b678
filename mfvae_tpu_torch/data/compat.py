"""The reference's replay-buffer surface (mirror of ``mfvae_tpu/data/compat.py``).

The reference wraps flashbax in a stateful class with
``init_buffer/add_trans/can_sample/sample`` (jax_ver/jax_buffer.py:80-140).
``TransitionBuffer`` keeps that surface over the port's ``ItemBuffer``, on
the flat keyed transitions of ``data/transitions.py``
``create_joint_transition``, so reference-style code runs unchanged.  New
code uses ``ItemBuffer`` directly.  ``sample`` takes a ``torch.Generator``
where the reference takes a key.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from mfvae_tpu_torch.data.buffer import ItemBuffer, SampleBatch
from mfvae_tpu_torch.data.transitions import create_joint_transition


def generate_dummy_transition(transition: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Zeros of the transition's schema (jax_ver/jax_buffer.py:62-78)."""
    return {k: torch.zeros_like(v) for k, v in transition.items()}


def print_transition_shape(transition: Dict[str, torch.Tensor]) -> None:
    """Shape and dtype of each field (jax_ver/jax_buffer.py:58-60)."""
    for k, v in transition.items():
        print(f"key {k} with shape: {tuple(v.shape)} and type {v.dtype}")


class TransitionBuffer:
    """The reference's JaxFbxBuffer surface: a max_length/min_length/
    batch_size constructor and init_buffer/add_trans/can_sample/sample."""

    def __init__(self, max_length: int = 50_000, min_length: int = 64, batch_size: int = 64,
                 add_batch: bool = False):
        self._buffer = ItemBuffer(max_length=max_length, min_length=min_length, sample_batch_size=batch_size)
        self._add_batch = add_batch
        self.buffer_state = None

    def init_buffer(self, obs, reward, actions, next_obs, done) -> None:
        transition = create_joint_transition(obs, reward, actions, next_obs, done)
        self.buffer_state = self._buffer.init(generate_dummy_transition(transition))

    def add_trans(self, obs, reward, actions, next_obs, done) -> None:
        if self.buffer_state is None:
            print("buffer not init; please call init_buffer() first")
            return
        transition = create_joint_transition(obs, reward, actions, next_obs, done)
        add = self._buffer.add_batch if self._add_batch else self._buffer.add
        self.buffer_state = add(self.buffer_state, transition)

    def can_sample(self) -> Optional[bool]:
        if self.buffer_state is None:
            print("buffer not init; please call init_buffer() first")
            return None
        return self._buffer.can_sample(self.buffer_state)

    def sample(self, generator: Optional[torch.Generator] = None) -> Optional[SampleBatch]:
        if self.buffer_state is None:
            print("buffer not init; please call init_buffer() first")
            return None
        if not self.can_sample():
            print("can not sample now")
            return None
        return self._buffer.sample(self.buffer_state, generator)
