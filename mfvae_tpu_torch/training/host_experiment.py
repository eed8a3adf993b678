"""Host-backend experiment (mirror of ``mfvae_tpu/training/host_experiment.py``).

    exp = HostExperiment(cfg)            # trains on the CUDA card
    exp = HostExperiment(cfg, "cpu")     # on the CPU, only when asked
    result = exp.setup().run()

A host env (``envs/host_adapter.py`` ``create_env``: the native C++ engine
where g++ builds it) makes transitions on the CPU into the host ring
(``data/host_buffer.py``), on a background collector thread, while the
device trains the MAVAE with the port's train step.  ``env.n_host_envs``
> 1 steps K native envs per call (``NativeBatchedCollector``).

As in the JAX package, the train step (and here the model's layers, K4's
lookups) is built without ``use_pallas``: the host backend runs the plain
ops whatever ``model.use_pallas`` says, and no test step runs in ``run``.
Each sampled host batch is assembled once into pinned staging tensors and
copied to the device per field, not per agent; the losses are read from
the device once per epoch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from mfvae_tpu_torch.config import ExperimentConfig, save_config
from mfvae_tpu_torch.data.transitions import VaeBatch
from mfvae_tpu_torch.envs import native_engine as ne
from mfvae_tpu_torch.envs.host_adapter import (
    AsyncCollector,
    MultiAgentHostBuffer,
    NativeBatchedCollector,
    create_env,
)
from mfvae_tpu_torch.models.losses import LossOutputs
from mfvae_tpu_torch.models.mavae import MAVAE, AgentSpec, GroupedBatch
from mfvae_tpu_torch.rng import make_streams
from mfvae_tpu_torch.training.experiment import resolve_device
from mfvae_tpu_torch.training.metrics import MetricsLogger
from mfvae_tpu_torch.training.trainer import (
    build_s_col_weight,
    create_train_state,
    make_test_step,
    make_train_step,
)


class _Staging:
    """One set of host tensors a batch is assembled into (pinned when the
    device is a card), with the event of the copies that last read them."""

    def __init__(self, spec: AgentSpec, batch: int, discrete: bool, pin: bool):
        def empty(shape, dtype):
            return torch.empty(shape, dtype=dtype, pin_memory=pin)

        self.obs, self.act = [], []
        for (od, ad), idxs in spec.groups:
            self.obs.append(empty((batch, len(idxs), od), torch.float32))
            act_shape = (batch, len(idxs)) if discrete else (batch, len(idxs), ad)
            self.act.append(empty(act_shape, torch.int32 if discrete else torch.float32))
        self.next_state = empty((batch, sum(spec.obs_dims)), torch.float32)
        self.rewards = empty((batch, spec.n_agents), torch.float32)
        self.event: Optional[torch.cuda.Event] = None


class HostExperiment:
    def __init__(self, cfg: ExperimentConfig, device="cuda"):
        self.cfg = cfg
        cfg.validate()
        self.device = resolve_device(device)
        # the device path's env name (MPE_simple_tag_v3) as the host
        # factory's PettingZoo-style name
        env_name = cfg.env.name.replace("MPE_", "")
        self.env, obs_dims, act_dims, _, _ = create_env(
            env_name,
            num_good=cfg.env.num_good_agents,
            num_adversaries=cfg.env.num_adversaries,
            num_obstacles=cfg.env.num_obs,
            max_cycles=cfg.env.max_steps,
            seed=cfg.train.seed,
            discrete=cfg.env.discrete_actions,
            scripted_policy=cfg.train.collect_policy != "random",
        )
        self.agents = list(self.env.agents)
        self.spec = AgentSpec.from_dicts(self.agents, obs_dims, act_dims)
        self.buffer = MultiAgentHostBuffer(
            self.env, max_size=cfg.buffer.max_size, batch_size=cfg.buffer.batch_size, seed=cfg.train.seed,
        )
        self.collector = None
        if cfg.env.n_host_envs > 1:
            # the batched collector always steps the native engine, even
            # where create_env found PettingZoo: only it steps in batch
            try:
                self.collector = NativeBatchedCollector(
                    self.buffer,
                    env=self._make_batched_native_env(env_name),
                    seed=cfg.train.seed,
                    continuous=not cfg.env.discrete_actions,
                    collect_policy=cfg.train.collect_policy,
                    epsilon=cfg.train.collect_epsilon,
                    mix_frac=cfg.train.collect_mix_frac,
                )
            except RuntimeError as e:  # no toolchain: the JAX package degrades and keeps running
                print(f"n_host_envs={cfg.env.n_host_envs} unavailable ({e}); "
                      "falling back to single-env AsyncCollector")
        if self.collector is None:
            self.collector = AsyncCollector(
                self.env, self.buffer, seed=cfg.train.seed,
                policy=cfg.train.collect_policy,
                epsilon=cfg.train.collect_epsilon,
                mix_frac=cfg.train.collect_mix_frac,
            )
        self.streams = make_streams(cfg.train.seed, device=self.device)
        self.logger: Optional[MetricsLogger] = None
        self.train_state = None
        self.train_step = None
        self.test_step = None
        self._staging: List[_Staging] = []
        self._slot = 0

    def _make_batched_native_env(self, env_name: str):
        """The batched native env of ``n_host_envs`` for the scenario."""
        cfg = self.cfg
        common = dict(n_envs=cfg.env.n_host_envs, max_steps=cfg.env.max_steps, seed=cfg.train.seed,
                      auto_reset=False)
        if env_name == "simple_adversary_v3":
            return ne.NativeSimpleAdversaryEnv(num_good_agents=cfg.env.num_good_agents, **common)
        if env_name == "simple_spread_v3":
            return ne.NativeSimpleSpreadEnv(num_agents=cfg.env.num_good_agents, **common)
        if env_name == "simple_world_comm_v3":
            return ne.NativeSimpleWorldCommEnv(
                num_good_agents=cfg.env.num_good_agents, num_adversaries=cfg.env.num_adversaries,
                num_obs=cfg.env.num_obs, **common,
            )
        return ne.NativeSimpleTagEnv(
            num_good_agents=cfg.env.num_good_agents, num_adversaries=cfg.env.num_adversaries,
            num_obs=cfg.env.num_obs, **common,
        )

    def setup(self):
        cfg = self.cfg
        if cfg.model.reward_head_mode == "twohot" and cfg.train.mode != "Adam":
            raise ValueError(
                "model.reward_head_mode='twohot' requires train.mode='Adam' "
                "(ART/POPART normalize scalar reward targets)"
            )
        model_cfg = dataclasses.replace(cfg.model, use_pallas=False)
        model = MAVAE.from_config(model_cfg, self.spec, device=self.device, generator=self.streams["model"])
        self.train_state = create_train_state(model, cfg.train)
        s_col_w = build_s_col_weight(self.spec, cfg, self.device)
        # no use_pallas, as the JAX package builds the host step
        self.train_step = make_train_step(cfg.loss, cfg.train.mode, cfg.train.popart_beta, s_col_weight=s_col_w)
        self.test_step = make_test_step(cfg.loss, cfg.train.mode, s_col_weight=s_col_w)
        pin = self.device.type == "cuda"
        self._staging = [
            _Staging(self.spec, cfg.buffer.batch_size, cfg.model.discrete_act, pin) for _ in range(2)
        ]
        self.logger = MetricsLogger(cfg.train.log_dir, cfg.train.run_name or "host_run")
        save_config(cfg, str(self.logger.run_dir / "config.yaml"))
        return self

    def device_batch(self, sample: Dict[str, np.ndarray]) -> VaeBatch:
        """Assemble a host sample into grouped tensors on the device.

        The per-agent fields are written once into one of two staging
        sets (pinned on a card) and each field goes to the device in one
        copy; a staging set is refilled only after the copies that read it
        last have run."""
        spec = self.spec
        st = self._staging[self._slot]
        self._slot ^= 1
        if st.event is not None:
            st.event.synchronize()
        next_state, col = st.next_state.numpy(), 0
        for g, ((od, _), idxs) in enumerate(spec.groups):
            obs, act = st.obs[g].numpy(), st.act[g].numpy()
            for j, i in enumerate(idxs):
                a = spec.agents[i]
                obs[:, j] = sample[f"{a}_observations"]
                act[:, j] = sample[f"{a}_actions"]
                next_state[:, col: col + od] = sample[f"{a}_next_observations"]
                col += od
        rewards = st.rewards.numpy()
        for i, a in enumerate(spec.agents):
            rewards[:, i] = sample[f"{a}_rewards"][:, 0]

        def put(t):
            return t.to(self.device, non_blocking=True, copy=True)

        batch = VaeBatch(
            inputs=GroupedBatch(obs=tuple(put(t) for t in st.obs), actions=tuple(put(t) for t in st.act)),
            next_state=put(st.next_state),
            rewards=put(st.rewards),
        )
        if self.device.type == "cuda":
            st.event = torch.cuda.Event()
            st.event.record()
        return batch

    def run(self) -> dict:
        """Train ``train.epoch_num`` epochs of ``train_num`` steps while the
        collector thread runs; epoch e starts once the collector has made
        (e + 1) · ``sample_num`` transitions.  Returns the last epoch's
        ``loss_train``, ``wall_s``, ``host_steps``, and per epoch its wall
        (``epoch_wall_s``, ending in the one device read of its losses) and
        the seconds it waited on the collector (``collector_wait_s``)."""
        if self.train_state is None:
            self.setup()
        cfg = self.cfg
        t0 = time.time()
        self.collector.collect(max(cfg.buffer.min_size, cfg.buffer.batch_size))
        self.collector.start()
        last: dict = {}
        epoch_wall, waits = [], []
        try:
            for epoch in range(cfg.train.epoch_num):
                t_epoch = time.perf_counter()
                waits.append(self.collector.wait_for((epoch + 1) * cfg.train.sample_num))
                sums = None
                for _ in range(cfg.train.train_num):
                    batch = self.device_batch(self.buffer.sample())
                    _, outs = self.train_step(self.train_state, batch, self.streams["train"])
                    sums = torch.stack(tuple(outs)) if sums is None else sums + torch.stack(tuple(outs))
                mean = LossOutputs(*(sums / cfg.train.train_num).tolist())  # one device read
                epoch_wall.append(time.perf_counter() - t_epoch)
                self.logger.losses(mean, epoch, "Train")
                last = {"epoch": epoch, "loss_train": mean.loss}
        finally:
            self.collector.stop()
        self.logger.flush()
        last["wall_s"] = time.time() - t0
        last["host_steps"] = self.collector.steps
        last["epoch_wall_s"] = epoch_wall
        last["collector_wait_s"] = waits
        return last
