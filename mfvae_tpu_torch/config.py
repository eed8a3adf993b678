"""Config system: one dataclass tree, YAML-loadable — a field-for-field
copy of ``mfvae_tpu/config.py``, so one YAML file means the same run in
both packages (``tests/test_torch_config.py`` holds the two equal).

The port keeps its own copy because ``mfvae_tpu/__init__.py`` imports JAX.
Options the port has not implemented yet are refused where they are used
(``models/mavae.py``, ``training/experiment.py``), never silently ignored.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Dict, List, Optional, Tuple

import yaml


@dataclass
class ModelConfig:
    """Mirror of ``mfvae_tpu.config.ModelConfig``."""

    idx_features: int = 64
    obs_features: int = 64
    action_features: int = 64
    discrete_act: bool = True
    encoder_hidden: Tuple[int, ...] = (64, 64, 256)
    action_encoder_hidden: Tuple[int, ...] = (64,)
    decoder_hidden: Tuple[int, ...] = (1024, 256, 64, 256, 1024)
    reward_head_init: str = "lecun"
    compute_dtype: str = "bfloat16"
    rng_mode: str = "vectorized"
    remat: bool = False
    use_pallas: bool = False
    latent_structure: str = "private"
    shared_latent: int = 32
    det_features: int = 0
    residual_state: bool = False
    state_skip: bool = False
    decoder_layernorm: bool = False
    fused_decoders: bool = True
    reward_head_mode: str = "linear"
    reward_bins: int = 65
    reward_head_input: str = "latent"
    action_delta_head: bool = False


@dataclass
class LossConfig:
    """Mirror of ``mfvae_tpu.config.LossConfig``."""

    family: str = "jax"
    use_huber: bool = True
    huber_delta: float = 1.0
    kl_weight: Optional[float] = None
    r_weight: Optional[float] = None
    kl_anneal_steps: int = 0
    free_bits: float = 0.0
    s_weight: float = 1.0
    contact_weight: float = 0.0
    contact_threshold: float = 0.5
    prey_dist_weight: float = 0.0

    def resolved_weights(self) -> Tuple[float, float]:
        if self.family == "jax":
            kw = 0.1 if self.kl_weight is None else self.kl_weight
            rw = 0.5 if self.r_weight is None else self.r_weight
        elif self.family == "torch":
            kw = 0.0025 if self.kl_weight is None else self.kl_weight
            rw = 0.005 if self.r_weight is None else self.r_weight
        else:
            raise ValueError(f"unknown loss family {self.family!r}")
        return kw, rw


@dataclass
class BufferConfig:
    """Mirror of ``mfvae_tpu.config.BufferConfig``."""

    max_size: int = 10_000
    min_size: int = 64
    batch_size: int = 128
    kind: str = "item"


@dataclass
class TrainConfig:
    """Mirror of ``mfvae_tpu.config.TrainConfig``."""

    epoch_num: int = 256
    sample_num: int = 128
    n_envs: int = 1
    batch_size: int = 128
    train_num: int = 10
    test_num: int = 64
    lr: float = 1e-3
    lr_schedule: str = "constant"
    lr_t_max: int = 50
    lr_warmup_steps: int = 0
    lr_min_ratio: float = 0.0
    mode: str = "Adam"
    popart_beta: float = 3e-4
    grad_clip: float = 0.0
    seed: int = 0
    collect_policy: str = "random"
    collect_epsilon: float = 0.1
    collect_mix_frac: float = 0.5
    unroll_steps: int = 1
    unroll_stop_gradient: bool = False
    unroll_mean_feedback: bool = False
    bug_compat_rng: bool = False
    log_dir: str = "results"
    run_name: str = ""
    checkpoint_dir: str = "model_save"
    checkpoint_every: int = 0
    resume: bool = False
    debug_nans: bool = False
    fused_epoch: bool = True
    epochs_per_dispatch: int = 1
    profile_epochs: int = 0
    eval_vmap: bool = True


@dataclass
class EnvConfig:
    """Mirror of ``mfvae_tpu.config.EnvConfig``."""

    name: str = "MPE_simple_tag_v3"
    num_good_agents: int = 10
    num_adversaries: int = 30
    num_obs: int = 20
    max_steps: int = 1000
    discrete_actions: bool = True
    backend: str = "jax"
    n_host_envs: int = 1


@dataclass
class BehaviorConfig:
    """Mirror of ``mfvae_tpu.config.BehaviorConfig``."""

    algo: str = "distill"
    plan_agents: str = "adversaries"
    score: str = "prey_distance"
    horizon: int = 8
    updates: int = 1500
    learning_rate: float = 3e-4
    hidden: tuple = (128, 128)
    start_pool: int = 4096
    start_burn_in: int = 32
    n_starts: int = 256
    n_rollouts: int = 16
    entropy_coef: float = 1e-2
    value_coef: float = 0.5
    gamma: float = 0.95
    lam: float = 0.95
    target_ema: float = 0.0
    critic_symlog: bool = False
    bootstrap_tail: bool = True
    critic_time_feature: bool = False
    centralized: bool = False
    m_rollouts: int = 24
    continuation: str = "hold"
    temperature: float = 0.5
    visit_steps: int = 3
    save_path: str = ""
    eval_episodes: int = 0
    eval_ep_len: int = 128


@dataclass
class MeshConfig:
    """Mirror of ``mfvae_tpu.config.MeshConfig``."""

    data_axis: int = -1
    model_axis: int = 1
    enable: bool = False


@dataclass
class ExperimentConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    buffer: BufferConfig = field(default_factory=BufferConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    env: EnvConfig = field(default_factory=EnvConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    behavior: BehaviorConfig = field(default_factory=BehaviorConfig)

    def validate(self) -> "ExperimentConfig":
        """Cross-field consistency, checked by the experiment drivers
        BEFORE any env/model construction (configs are mutable, so this
        runs at use time, not at dataclass init)."""
        if self.env.discrete_actions != self.model.discrete_act:
            raise ValueError(
                "env.discrete_actions and model.discrete_act must agree "
                f"(got env={self.env.discrete_actions}, "
                f"model={self.model.discrete_act})"
            )
        self.loss.resolved_weights()
        cp = self.train.collect_policy
        if cp not in ("random", "pursuit", "episode_mix", "sticky") and not (
            cp.startswith("vdn:") or cp.startswith("imagination:")
        ):
            raise ValueError(
                f"unknown collect_policy {cp!r} (expected 'random', "
                "'pursuit', 'episode_mix', 'sticky', 'vdn:<policy.npz>', "
                "or 'imagination:<policy.msgpack>')"
            )
        if not 0.0 <= self.train.collect_epsilon <= 1.0:
            raise ValueError(
                f"collect_epsilon must be in [0, 1]; got "
                f"{self.train.collect_epsilon}"
            )
        if not 0.0 <= self.train.collect_mix_frac <= 1.0:
            raise ValueError(
                f"collect_mix_frac must be in [0, 1]; got "
                f"{self.train.collect_mix_frac}"
            )
        b = self.behavior
        if b.algo not in ("reinforce", "actor_critic", "distill"):
            raise ValueError(
                f"unknown behavior.algo {b.algo!r} (expected 'reinforce', "
                "'actor_critic', or 'distill')"
            )
        if b.plan_agents not in ("adversaries", "all"):
            raise ValueError(
                f"unknown behavior.plan_agents {b.plan_agents!r} "
                "(expected 'adversaries' or 'all')"
            )
        if b.score not in ("prey_distance", "reward"):
            raise ValueError(
                f"unknown behavior.score {b.score!r} (expected "
                "'prey_distance' or 'reward')"
            )
        if b.continuation not in ("hold", "random"):
            raise ValueError(
                f"unknown behavior.continuation {b.continuation!r} "
                "(expected 'hold' or 'random')"
            )
        return self


def _to_dict(obj: Any) -> Any:
    if is_dataclass(obj):
        return {f.name: _to_dict(getattr(obj, f.name)) for f in fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_to_dict(v) for v in obj]
    return obj


def _from_dict(cls, data: Dict[str, Any]):
    kwargs = {}
    for f in fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if is_dataclass(f.type) if isinstance(f.type, type) else False:
            kwargs[f.name] = _from_dict(f.type, v)
        elif f.name in _NESTED.get(cls, {}):
            kwargs[f.name] = _from_dict(_NESTED[cls][f.name], v)
        else:
            default = f.default_factory() if f.default_factory is not dataclasses.MISSING else f.default
            if isinstance(default, tuple) and isinstance(v, list):
                v = tuple(v)
            kwargs[f.name] = v
    return cls(**kwargs)


_NESTED = {
    ExperimentConfig: {
        "model": ModelConfig,
        "loss": LossConfig,
        "buffer": BufferConfig,
        "train": TrainConfig,
        "env": EnvConfig,
        "mesh": MeshConfig,
        "behavior": BehaviorConfig,
    }
}


def save_config(cfg: Any, path: str) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(_to_dict(cfg), f, sort_keys=False)


def load_config(path: str, overrides: Optional[List[str]] = None) -> ExperimentConfig:
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    cfg = _from_dict(ExperimentConfig, data)
    if overrides:
        apply_overrides(cfg, overrides)
    return cfg


def apply_overrides(cfg: Any, overrides: List[str]) -> None:
    """Apply ``a.b.c=value`` dotted-path overrides in place."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must look like path.to.field=value")
        path, raw = ov.split("=", 1)
        parts = path.split(".")
        obj = cfg
        for p in parts[:-1]:
            obj = getattr(obj, p)
        name = parts[-1]
        cur = getattr(obj, name)
        setattr(obj, name, _coerce(raw, cur))


def _coerce(raw: str, like: Any) -> Any:
    if isinstance(like, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(like, int) and not isinstance(like, bool):
        return int(raw)
    if isinstance(like, float):
        return float(raw)
    if isinstance(like, tuple):
        return tuple(int(x) for x in raw.strip("()[] ").split(",") if x)
    if like is None:
        try:
            return float(raw)
        except ValueError:
            return raw
    return raw
