"""Named RNG streams as ``torch.Generator``s.

``mfvae_tpu/rng.py`` derives seven independent named keys from one seed.
Here each name is an independent ``torch.Generator`` on the run's device,
seeded from (seed, stream index).  A generator is stateful, so consumers
draw from it in order; its ``get_state()`` goes into checkpoints, which is
what makes a resume exact.  The numbers differ from JAX's threefry bits:
tests that compare the two packages make their noise with numpy and hand
it to both.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

STREAM_NAMES = ("reset", "act", "step", "sample", "model", "train", "eval")


def stream_seed(seed: int, index: int) -> int:
    """A well-mixed 63-bit seed for stream ``index`` of run ``seed``."""
    state = np.random.SeedSequence((int(seed), int(index))).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def make_streams(
    seed: int,
    names: Sequence[str] = STREAM_NAMES,
    device="cuda",
    bug_compat: bool = False,
) -> Dict[str, torch.Generator]:
    """One independent generator per name, all on ``device``."""
    if bug_compat:
        raise NotImplementedError(
            "train.bug_compat_rng (the reference's frozen keys) is not ported"
        )
    out = {}
    for i, name in enumerate(names):
        g = torch.Generator(device=device)
        g.manual_seed(stream_seed(seed, i))
        out[name] = g
    return out
