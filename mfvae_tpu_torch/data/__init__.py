from mfvae_tpu_torch.data.buffer import BufferState, ItemBuffer, SampleBatch, TrajectoryBuffer
from mfvae_tpu_torch.data.transitions import (
    GroupedTransition,
    VaeBatch,
    create_dataset,
    create_joint_transition,
    group_env_step,
    vae_batch_from_grouped,
)

__all__ = [
    "BufferState", "ItemBuffer", "SampleBatch", "TrajectoryBuffer",
    "GroupedTransition", "VaeBatch", "create_dataset",
    "create_joint_transition", "group_env_step", "vae_batch_from_grouped",
]
