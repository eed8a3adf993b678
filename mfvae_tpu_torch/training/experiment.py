"""Experiment driver (mirror of ``mfvae_tpu/training/experiment.py``).

    exp = Experiment(cfg)            # on the CUDA card
    exp = Experiment(cfg, "cpu")     # on the CPU, only when asked
    result = exp.setup().run()

The device is a constructor argument, not a config field, so the config
tree stays field-for-field equal to the JAX package's.  Without a card,
``device="cuda"`` raises rather than carrying on on the CPU.

``run`` checkpoints and returns at the next epoch boundary after SIGTERM or
SIGINT; ``run_resilient`` rebuilds and resumes after a failure.

The tooling options: ``train.profile_epochs`` traces epochs
[start+1, start+1+profile_epochs) into ``<run_dir>/profile``, or, with
``train.epochs_per_dispatch`` K > 1, the first K epochs from the start
epoch itself, as the JAX package traces its first dispatched chunk
(``utils/profiling.py``).  ``train.debug_nans`` runs the epochs under
``utils/debug_nans.NanGuard``, on for the run and off again after it.
``train.bug_compat_rng`` starts every epoch from the streams' state at the
start of epoch 0 (``rng.py``).

``mesh.enable`` (with ``train.n_envs`` > 1, as in the JAX package, which
shards only its batched epoch) runs one rank per process over the
('data','model') mesh of ``parallel/mesh.py``: call
``parallel.init_distributed()`` first (``python -m mfvae_tpu_torch`` does
under torchrun), or run it as one process, world size 1.  Data rank d
steps envs [d·E/D, (d+1)·E/D) and holds their ring shards; with
``mesh.model_axis`` > 1 the model is tensor-parallel (``parallel/tp.py``)
and the model ranks of a data rank step the same envs.  The parameters
are broadcast from rank 0 at setup; rank 0 alone logs and writes
checkpoints, which hold the whole carry (shards gathered), so a run
resumes onto any mesh whose data axis divides n_envs.
"""

from __future__ import annotations

import contextlib
import signal
import threading
import time
from typing import Optional

import torch

from mfvae_tpu_torch.config import ExperimentConfig, save_config
from mfvae_tpu_torch.data.buffer import BufferState, ItemBuffer, tree_leaves, tree_map
from mfvae_tpu_torch.data.transitions import GroupedTransition
from mfvae_tpu_torch.envs.mpe import make
from mfvae_tpu_torch.envs.spaces import get_space_size
from mfvae_tpu_torch.models.mavae import MAVAE, AgentSpec, zero_actions_grouped
from mfvae_tpu_torch.parallel import tp
from mfvae_tpu_torch.parallel.dp import broadcast_parameters_
from mfvae_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh
from mfvae_tpu_torch.rng import make_streams
from mfvae_tpu_torch.training.checkpoint import CheckpointManager, NullCheckpointManager
from mfvae_tpu_torch.training.metrics import MetricsLogger, NullLogger
from mfvae_tpu_torch.training.popart import PopArtState
from mfvae_tpu_torch.training.trainer import (
    EnvCarry,
    EpochCarry,
    EpochMetrics,
    create_train_state,
    init_policy_carry,
    make_epoch_fn,
    shard_buffer,
    stacked_to_grouped,
)
from mfvae_tpu_torch.utils.debug_nans import NanGuard
from mfvae_tpu_torch.utils.profiling import trace


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run the port on the CPU"
        )
    return dev


def build_spec(env) -> AgentSpec:
    """Dims from the live env: Discrete -> n, Box -> flat shape."""
    obs_dim = {a: env.obs_dim(a) for a in env.agents}
    act_dim = {a: get_space_size(env.action_space(a)) for a in env.agents}
    return AgentSpec.from_dicts(env.agents, obs_dim, act_dim)


def _experiment_mesh(cfg: ExperimentConfig):
    """The run's mesh, or None: ``mesh.enable`` acts on the batched epoch
    only (with one env the JAX package ignores it)."""
    if not (cfg.mesh.enable and cfg.train.n_envs > 1):
        return None
    mesh = make_mesh(n_data=cfg.mesh.data_axis, n_model=cfg.mesh.model_axis)
    if cfg.train.n_envs % mesh.shape[DATA_AXIS]:
        raise ValueError(
            f"train.n_envs={cfg.train.n_envs} is not divisible by the mesh's data axis ({mesh.shape})"
        )
    return mesh


class Experiment:
    # fused_epoch, epochs_per_dispatch and eval_vmap shape only the JAX
    # package's XLA program and change nothing here, except that build
    # refuses epochs_per_dispatch > 1 without the fused epoch, as the JAX
    # package does, and that epochs_per_dispatch sets profile_epochs' window
    def __init__(self, cfg: ExperimentConfig, device="cuda"):
        self.cfg = cfg
        cfg.validate()
        self.device = resolve_device(device)
        self.mesh = _experiment_mesh(cfg)
        self.is_chief = self.mesh is None or self.mesh.rank == 0
        self.env = make(
            cfg.env.name,
            device=self.device,
            num_good_agents=cfg.env.num_good_agents,
            num_adversaries=cfg.env.num_adversaries,
            num_obs=cfg.env.num_obs,
            max_steps=cfg.env.max_steps,
            discrete_actions=cfg.env.discrete_actions,
        )
        self.spec = build_spec(self.env)
        # the reference's agent -> embedding index map, for create_dataset
        self.codebook = {a: i for i, a in enumerate(self.env.agents)}
        self.buffer = ItemBuffer(
            max_length=cfg.buffer.max_size,
            min_length=cfg.buffer.min_size,
            sample_batch_size=cfg.buffer.batch_size,
        )
        if cfg.train.n_envs > 1:
            # the batched epoch: one buffer shard per env
            self.buffer = shard_buffer(self.buffer, cfg, self.mesh)
        self.test_buffer = self.buffer
        self.streams = make_streams(cfg.train.seed, device=self.device, bug_compat=cfg.train.bug_compat_rng)
        self.logger: Optional[MetricsLogger] = None
        self.ckpt = None
        self._epoch_fn = None
        self.carry: Optional[EpochCarry] = None
        self.start_epoch = 0

    # ------------------------------------------------------------ lifecycle
    def setup(self):
        """``build``, then the run's logger, config snapshot and checkpoint
        manager, and the resume when ``train.resume`` is set."""
        cfg = self.cfg
        self.build()
        if self.is_chief:
            self.logger = MetricsLogger(cfg.train.log_dir, cfg.train.run_name)
            # the resolved config beside the run's metrics reproduces the run
            save_config(cfg, str(self.logger.run_dir / "config.yaml"))
        else:
            self.logger = NullLogger(cfg.train.log_dir, cfg.train.run_name)
        self.ckpt = (
            CheckpointManager(cfg.train.checkpoint_dir)
            if cfg.train.checkpoint_dir
            else NullCheckpointManager()
        )
        if cfg.train.resume:
            self._try_resume()
        # every rank decides a save from this, never from the directory,
        # which rank 0 alone writes
        self._last_saved = self.ckpt.latest_step()
        return self

    def build(self):
        """The env's first state, the model, the buffers and the epoch
        program: the carry every epoch advances, drawn from the seed's
        streams alone (``multiseed`` builds its replicas so)."""
        cfg = self.cfg
        if cfg.train.n_envs <= 1 and not cfg.train.fused_epoch and cfg.train.epochs_per_dispatch > 1:
            raise ValueError(
                "train.epochs_per_dispatch > 1 requires the fused epoch "
                "program (train.fused_epoch=true or train.n_envs > 1); "
                "the split-phase path dispatches per phase"
            )
        if cfg.model.reward_head_mode == "twohot":
            # PopArt rescales a scalar output head and K3 scores scalar
            # huber: neither is defined for categorical reward logits
            if cfg.train.mode != "Adam":
                raise ValueError(
                    "model.reward_head_mode='twohot' requires train.mode='Adam' "
                    "(ART/POPART normalize scalar reward targets; the two-hot "
                    "head is categorical)"
                )
            if cfg.model.use_pallas:
                raise ValueError(
                    "model.reward_head_mode='twohot' is incompatible with "
                    "model.use_pallas (the fused kernel scores scalar huber)"
                )
        mesh = self.mesh
        lead = (cfg.train.n_envs,) if cfg.train.n_envs > 1 else ()
        obs, env_state = self.env.reset_stacked(self.streams["reset"], batch_shape=lead)
        if mesh is not None:
            # the reset of every env, this rank's rows kept
            obs, env_state = tree_map(mesh.local_rows, (obs, env_state))
            lead = (obs[0].shape[0],)
        example = self._example_transition(obs, env_state, lead)
        model = MAVAE.from_config(
            cfg.model, self.spec, device=self.device, generator=self.streams["model"]
        )
        if mesh is not None:
            broadcast_parameters_(model, mesh)
            if mesh.shape[MODEL_AXIS] > 1:
                tp.shard_model_(model, mesh)
        self.carry = EpochCarry(
            train_state=create_train_state(model, cfg.train),
            buffer_state=self.buffer.init(example),
            test_buffer_state=self.test_buffer.init(example),
            env=EnvCarry(
                obs=obs, state=env_state,
                policy=init_policy_carry(self.env, self.spec, cfg, lead),
            ),
        )
        self._epoch_fn = make_epoch_fn(
            self.env, self.spec, self.buffer, self.test_buffer, cfg, self.streams, mesh
        )
        # bug_compat_rng: every epoch starts from the streams' state here,
        # which follows from the seed alone, so a resume rebuilds it
        self.streams.freeze()
        return self

    def run_epoch(self) -> EpochMetrics:
        """One epoch on the carry; its metrics stay on the device."""
        self.streams.rewind()
        self.carry, metrics = self._epoch_fn(self.carry)
        return metrics

    def _profile_window(self) -> Optional[range]:
        """The epochs ``train.profile_epochs`` traces, as the JAX package's
        two loops do: [start+1, start+1+profile_epochs) epoch by epoch;
        with epochs_per_dispatch K > 1 its first chunk, [start, start+K)."""
        t = self.cfg.train
        if not t.profile_epochs or self.start_epoch >= t.epoch_num:
            return None
        if t.epochs_per_dispatch > 1:
            return range(self.start_epoch, min(self.start_epoch + t.epochs_per_dispatch, t.epoch_num))
        return range(self.start_epoch + 1, self.start_epoch + 1 + t.profile_epochs)

    def _example_transition(self, obs, env_state, lead=()) -> GroupedTransition:
        """A transition of the buffer's layout, with the env axis ``lead``."""
        discrete = self.cfg.env.discrete_actions
        if discrete:
            zero_actions = torch.zeros(*lead, self.spec.n_agents, dtype=torch.int32, device=self.device)
        else:
            zero_actions = torch.zeros(*lead, self.spec.n_agents, self.spec.act_dims[0], device=self.device)
        next_obs, _, rewards, _, _ = self.env.step_stacked(env_state, zero_actions)
        return GroupedTransition(
            obs=stacked_to_grouped(self.spec, obs),
            actions=zero_actions_grouped(self.spec, lead[0] if lead else None, discrete, self.device),
            next_obs=stacked_to_grouped(self.spec, next_obs),
            rewards=rewards,
            done=torch.zeros(lead, device=self.device),
        )

    # ----------------------------------------------------------- checkpoint
    def _payload(self, epoch: int) -> dict:
        """The whole carry; under a mesh every rank takes part (the shards
        are gathered) and every rank gets it."""
        c = self.carry
        ts = c.train_state
        mesh = self.mesh

        def envs(xs):  # the env axis whole
            return [mesh.all_gather(x, DATA_AXIS, 0) for x in xs] if mesh is not None else list(xs)

        def buffer(b: BufferState):
            return {"data": envs(tree_leaves(b.data)), "cursor": b.cursor, "size": b.size}

        sharded = tp.is_sharded(ts.model)
        return {
            "epoch": epoch,
            "model": tp.full_state_dict(ts.model, mesh) if sharded else ts.model.state_dict(),
            "optimizer": tp.full_optimizer_state(ts.optimizer, ts.model, mesh) if sharded
            else ts.optimizer.state_dict(),
            "step": ts.step,
            "popart": list(ts.popart),
            "buffer": buffer(c.buffer_state),
            "test_buffer": buffer(c.test_buffer_state),
            "env_obs": envs(c.env.obs),
            "env_state": envs(c.env.state),
            "env_policy": envs(c.env.policy),
            "rng": {name: g.get_state() for name, g in self.streams.items()},
        }

    def _save(self, epoch: int):
        self._last_saved = epoch
        if self.ckpt.directory is None:
            return  # checkpointing is off: nothing to gather
        payload = self._payload(epoch)
        if self.is_chief:
            self.ckpt.save(epoch, payload)

    def _try_resume(self):
        step = self.ckpt.latest_step()
        if step is None:
            return
        p = self.ckpt.restore(step)
        c = self.carry
        ts = c.train_state
        mesh = self.mesh
        if tp.is_sharded(ts.model):
            tp.load_full_state_dict_(ts.model, p["model"], mesh)
            tp.load_full_optimizer_state_(ts.optimizer, p["optimizer"], ts.model, mesh)
        else:
            ts.model.load_state_dict(p["model"])
            ts.optimizer.load_state_dict(p["optimizer"])
        ts.step = int(p["step"])
        ts.popart = PopArtState(*(x.to(self.device) for x in p["popart"]))

        def mine(x):  # this rank's envs of the whole env axis
            return mesh.local_rows(x) if mesh is not None else x

        def buffer(b: BufferState, saved) -> BufferState:
            leaves = iter(saved["data"])
            data = tree_map(lambda buf: buf.copy_(mine(next(leaves))), b.data)
            return BufferState(data=data, cursor=int(saved["cursor"]), size=int(saved["size"]))

        def to_dev(xs):
            return [mine(x).to(self.device) for x in xs]

        self.carry = EpochCarry(
            train_state=ts,
            buffer_state=buffer(c.buffer_state, p["buffer"]),
            test_buffer_state=buffer(c.test_buffer_state, p["test_buffer"]),
            # the scenario's own obs and state NamedTuples
            env=EnvCarry(
                obs=type(c.env.obs)(*to_dev(p["env_obs"])),
                state=type(c.env.state)(*to_dev(p["env_state"])),
                # a checkpoint from before the policy carry restarts it,
                # which is where a fresh episode's policy starts too
                policy=tuple(to_dev(p["env_policy"])) if "env_policy" in p else c.env.policy,
            ),
        )
        for name, g in self.streams.items():
            g.set_state(p["rng"][name])
        self.start_epoch = int(p["epoch"]) + 1
        print(f"resumed from checkpoint step {step} (epoch {self.start_epoch})")

    # ----------------------------------------------------------------- run
    def run(self) -> dict:
        """Train ``train.epoch_num`` epochs.  Returns the last epoch's
        ``loss_train``/``loss_test``, the total ``wall_s`` and the wall
        seconds of each epoch (``epoch_wall_s``, each ending in a device
        sync when the epoch's losses are read).

        The tooling options (``train.profile_epochs``, ``debug_nans``,
        ``bug_compat_rng``) act here; see the module docstring.

        Preemption: on the main thread, SIGTERM and SIGINT only set a flag
        for the run; at the next epoch boundary the full payload is saved
        and the run returns with ``preempted_at`` (the last epoch trained),
        so a restart with ``train.resume`` continues exactly.  The previous
        handlers are restored on the way out."""
        if self.carry is None:
            self.setup()
        cfg = self.cfg
        t0 = time.time()
        last: dict = {}
        epoch_wall = []
        epoch = self.start_epoch - 1
        preempted = []
        stop = False
        old_handlers = {}
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                old_handlers[sig] = signal.signal(sig, lambda signum, frame: preempted.append(signum))
        window = self._profile_window()
        tracing = contextlib.ExitStack()
        try:
            with NanGuard(self.carry.train_state.model) if cfg.train.debug_nans else contextlib.nullcontext():
                for epoch in range(self.start_epoch, cfg.train.epoch_num):
                    if window is not None and epoch == window.start:
                        tracing.enter_context(trace(str(self.logger.run_dir / "profile")))
                    t_epoch = time.perf_counter()
                    metrics = self.run_epoch()
                    train = type(metrics.train)(*(float(x) for x in metrics.train))
                    test = type(metrics.test)(*(float(x) for x in metrics.test))
                    epoch_wall.append(time.perf_counter() - t_epoch)
                    if window is not None and epoch == window.stop - 1:
                        tracing.close()  # waits for the device, then writes the trace
                    self.logger.losses(train, epoch, "Train")
                    self.logger.losses(test, epoch, "Test")
                    last = {"epoch": epoch, "loss_train": train.loss, "loss_test": test.loss}
                    if cfg.train.checkpoint_every and (epoch + 1) % cfg.train.checkpoint_every == 0:
                        self._save(epoch)
                    # a signal may reach the ranks in different epochs: they stop together
                    stop = bool(preempted) if self.mesh is None else self.mesh.any(bool(preempted))
                    if stop:
                        print(f"preempted: checkpointing epoch {epoch}, exiting cleanly", flush=True)
                        break
        finally:
            tracing.close()
            for sig, handler in old_handlers.items():
                signal.signal(sig, handler)
        if epoch >= 0 and self._last_saved != epoch:
            self._save(epoch)
        self.ckpt.wait()
        self.logger.flush()
        last["wall_s"] = time.time() - t0
        last["epoch_wall_s"] = epoch_wall
        if stop:
            last["preempted_at"] = epoch
        return last


def run_experiment(cfg: ExperimentConfig, device="cuda") -> dict:
    """The JAX package's dispatcher on ``env.backend``: 'jax' -> the
    on-device ``Experiment``; 'host' -> ``HostExperiment`` (host envs and
    the host ring feeding the device)."""
    if cfg.env.backend == "host":
        from mfvae_tpu_torch.training.host_experiment import HostExperiment

        return HostExperiment(cfg, device).setup().run()
    return Experiment(cfg, device).setup().run()


def run_resilient(cfg: ExperimentConfig, max_restarts: int = 3, experiment_factory=Experiment,
                  device="cuda") -> dict:
    """Failure-tolerant training: on any exception the experiment is rebuilt
    with ``train.resume`` set and continues from its latest full-state
    checkpoint, up to ``max_restarts`` times.  Progress across restarts
    needs ``train.checkpoint_every`` > 0 and a ``train.checkpoint_dir``."""
    attempt = 0
    while True:
        try:
            if attempt > 0:
                cfg.train.resume = True
            return experiment_factory(cfg, device).setup().run()
        except Exception as e:  # noqa: BLE001 - every failure of an attempt is retried
            attempt += 1
            if attempt > max_restarts:
                raise
            print(f"training attempt {attempt} failed ({type(e).__name__}: {e}); "
                  "restarting from last checkpoint", flush=True)
