from mfvae_tpu_torch.parallel.dp import make_dp_train_step
from mfvae_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    init_distributed,
    make_mesh,
)
from mfvae_tpu_torch.parallel.pp import (
    PIPE_AXIS,
    PipelineParams,
    init_pipeline_params,
    make_pipe_mesh,
    pipeline_apply,
    pipeline_param_shardings,
)
from mfvae_tpu_torch.parallel.sharding import check_divisibility, mavae_param_shardings

__all__ = [
    "make_dp_train_step", "DATA_AXIS", "MODEL_AXIS", "init_distributed",
    "make_mesh", "check_divisibility", "mavae_param_shardings",
    "PIPE_AXIS", "PipelineParams", "init_pipeline_params", "make_pipe_mesh",
    "pipeline_apply", "pipeline_param_shardings",
]
