"""Named RNG streams as ``torch.Generator``s.

``mfvae_tpu/rng.py`` derives seven independent named keys from one seed.
Here each name is an independent ``torch.Generator`` on the run's device,
seeded from (seed, stream index).  A generator is stateful, so consumers
draw from it in order; its ``get_state()`` goes into checkpoints, which is
what makes a resume exact.  The numbers differ from JAX's threefry bits:
tests that compare the two packages make their noise with numpy and hand
it to both.

``bug_compat`` (``train.bug_compat_rng``): the reference never re-splits
its keys inside its loops, and the JAX package replays that with streams
whose ``next()`` never advances, so every epoch runs on the same epoch
key.  Threefry bits cannot be replayed here; only that regime carries
over, and it is defined so: every stream an epoch draws from
(``EPOCH_STREAMS``: act, step, sample, train, eval, and reset on
auto-reset) is put back to its state at the start of epoch 0 before every
epoch.  ``Streams.freeze`` takes that snapshot once the experiment is set
up and ``Streams.rewind`` restores it.  Each epoch then replays the same
draws: the same actions, the same eps and the same draws for its buffer
samples (the buffer contents still differ between epochs).  The snapshot
follows from the seed alone, so a resumed run rebuilds it in its own setup
and continues exactly.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

STREAM_NAMES = ("reset", "act", "step", "sample", "model", "train", "eval")
EPOCH_STREAMS = ("reset", "act", "step", "sample", "train", "eval")


def stream_seed(seed: int, index: int) -> int:
    """A well-mixed 63-bit seed for stream ``index`` of run ``seed``."""
    state = np.random.SeedSequence((int(seed), int(index))).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


class Streams(dict):
    """name -> ``torch.Generator``, with the ``bug_compat`` epoch rewind
    (a no-op without ``bug_compat``)."""

    def __init__(self, generators: Dict[str, torch.Generator], bug_compat: bool = False):
        super().__init__(generators)
        self.bug_compat = bug_compat
        self._epoch0: Optional[Dict[str, torch.Tensor]] = None

    def freeze(self) -> None:
        """Snapshot the epoch streams: the state every epoch starts from."""
        if self.bug_compat:
            self._epoch0 = {n: self[n].get_state() for n in EPOCH_STREAMS if n in self}

    def rewind(self) -> None:
        """Put the epoch streams back to the ``freeze`` snapshot."""
        if self._epoch0 is not None:
            for name, state in self._epoch0.items():
                self[name].set_state(state)


def make_streams(
    seed: int,
    names: Sequence[str] = STREAM_NAMES,
    device="cuda",
    bug_compat: bool = False,
) -> Streams:
    """One independent generator per name, all on ``device``."""
    out = {}
    for i, name in enumerate(names):
        g = torch.Generator(device=device)
        g.manual_seed(stream_seed(seed, i))
        out[name] = g
    return Streams(out, bug_compat)
