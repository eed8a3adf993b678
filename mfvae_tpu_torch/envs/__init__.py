from mfvae_tpu_torch.envs.mpe import (
    MPEState,
    SimpleAdversaryEnv,
    SimpleSpreadEnv,
    SimpleTagEnv,
    make,
)
from mfvae_tpu_torch.envs.spaces import Box, Discrete, get_space_size
from mfvae_tpu_torch.envs.wrappers import BatchedEnv, LogWrapper

__all__ = [
    "MPEState", "SimpleAdversaryEnv", "SimpleSpreadEnv", "SimpleTagEnv", "make",
    "Box", "Discrete", "get_space_size", "BatchedEnv", "LogWrapper",
]
