"""The train step's FLOPs, counted from the model's shapes.

XLA's ``cost_analysis`` has no counterpart, so ``step_flops`` counts the
train step's matrix products: every ``Dense`` and ``StackedDense`` (the
encoders, the decoders and their heads), 2·rows·in·out each, forward, and
twice that backward (the input's gradient and the kernel's: every
product's input needs a gradient in the train step).  The action encoders
are gathers, with no product.
"""

from __future__ import annotations

from mfvae_tpu_torch.models.layers import Dense, StackedDense
from mfvae_tpu_torch.models.mavae import MAVAE


def step_flops(model: MAVAE, batch_size: int, windows: int = 1) -> int:
    """The matrix-product FLOPs of one train step over ``batch_size`` rows
    (``windows`` forwards of them: the unroll step's W), forward and
    backward, from the model's shapes."""
    fwd = 0
    for name, m in model.named_modules():
        if isinstance(m, StackedDense):
            stack, d_in, d_out = m.kernel.shape
            fwd += 2 * batch_size * stack * d_in * d_out
        elif isinstance(m, Dense):
            d_in, d_out = m.kernel.shape
            rows = batch_size
            if name.startswith("action_delta_heads."):
                # applied to its group's per-agent action embeddings
                rows *= len(model.spec.groups[int(name.split(".")[1])][1])
            fwd += 2 * rows * d_in * d_out
    return 3 * fwd * windows
