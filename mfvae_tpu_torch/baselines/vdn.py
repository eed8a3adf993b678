"""VDN (Value Decomposition Networks) baseline (mirror of
``mfvae_tpu/baselines/vdn.py``).

Batched env rollouts, a trajectory replay ring, recurrent per-agent
Q-networks with shared (or independent per-agent) parameters,
epsilon-greedy exploration with linear annealing, double-DQN targets over
the summed joint Q (one-step or TD(λ)), periodic hard target updates,
greedy evaluation episodes and per-update metrics.  Heterogeneous
observation widths are zero-padded to the widest and a one-hot agent id is
appended.

The JAX package runs every update inside one compiled ``lax.scan`` with
three ``lax.cond``s; each branch depends on host-known counters only, so
here the updates are a Python loop that reads nothing back from the
device: the buffer's ``cursor``/``size``, the update index and the
optimizer's step count are Python ints, so ``can_sample``, the target copy
(after the gradient step, when ``update_i % target_update_interval == 0``,
update 0 included) and the greedy test (when ``update_i % test_interval ==
0``, else the previous ``test_return`` carries) are host decisions.  The
metrics stay on the device and are read back once every ``log_chunk``
updates; ``metrics_callback(metrics, update_i)`` then fires once per
update, in order.  The JAX package's ``_host_callbacks_supported`` probes
a JAX backend for ``jax.debug.callback`` and has no counterpart here.

The optimizer is optax's ``chain(clip_by_global_norm(max_grad_norm),
adam(lr, eps=1e-5))``: the clip scales by max_norm / norm only when norm ≥
max_norm, Adam has optax's betas, and ``lr_linear_decay`` is
``linear_schedule(lr, 1e-10, num_updates)`` indexed by the optimizer's own
count, which advances only on updates that learn.

Every draw (exploration, env resets, buffer windows, the greedy test's
resets) comes from one ``torch.Generator`` per run on the run's device;
weights are drawn on the CPU from a second, so a seed gives the same
network on every device.  A run twice with the same seed is bit-equal on
the CPU.  ``num_seeds`` runs the seeds one after another.
"""

from __future__ import annotations

import copy
import json
import struct
import sys
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
import yaml
from torch import nn

from mfvae_tpu_torch.data.buffer import BufferState, TrajectoryBuffer
from mfvae_tpu_torch.envs.mpe import make as make_env
from mfvae_tpu_torch.envs.wrappers import BatchedEnv, LogWrapper
from mfvae_tpu_torch.models.convert import flatten_flax, qnet_params_to_jax
from mfvae_tpu_torch.models.qlearning import AgentRNN, eps_greedy, epsilon_by_step
from mfvae_tpu_torch.rng import stream_seed
from mfvae_tpu_torch.training.experiment import resolve_device
from mfvae_tpu_torch.training.trainer import _clip_by_global_norm


@dataclass
class VdnConfig:
    """The JAX package's ``VdnConfig``, field for field."""

    # env
    env_name: str = "MPE_simple_tag_v3"
    num_good_agents: int = 10
    num_adversaries: int = 30
    num_obs: int = 20
    max_env_steps: int = 25
    # training
    num_envs: int = 8
    num_steps: int = 25  # rollout length per update
    num_updates: int = 100
    buffer_size_time: int = 512  # per-env time-ring capacity
    min_buffer_time: int = 64
    batch_size: int = 32  # sampled sequences per update
    sample_sequence_length: int = 16
    hidden_dim: int = 64
    param_share: bool = True
    lr: float = 5e-4
    lr_linear_decay: bool = False
    max_grad_norm: float = 10.0
    gamma: float = 0.99
    # TD(lambda) targets; lambda=0 is the one-step double-DQN loss
    td_lambda_loss: bool = False
    td_lambda: float = 0.6
    num_seeds: int = 1
    # team-reward scaling before the TD target
    reward_scale: float = 1.0
    eps_start: float = 1.0
    eps_finish: float = 0.05
    eps_decay: float = 0.1  # fraction of updates over which to anneal
    target_update_interval: int = 10
    # eval
    test_during_training: bool = True
    test_interval: int = 10
    test_num_envs: int = 8
    test_num_steps: int = 25
    seed: int = 0
    # per-update metrics (JSONL/TensorBoard + optional wandb), read back
    # from the device every log_chunk updates
    log_during_training: bool = True
    log_chunk: int = 10
    log_dir: str = "results"
    run_name: str = ""
    wandb_mode: str = "disabled"
    wandb_project: str = "mfvae_tpu"
    # if set, save the trained greedy policy (first seed) as the .npz that
    # train.collect_policy="vdn:<path>" reads (baselines/collect_policy.py)
    save_policy_path: str = ""

    @classmethod
    def from_yaml(cls, path: str) -> "VdnConfig":
        with open(path) as f:
            data = yaml.safe_load(f) or {}
        return cls(**data)


class Timestep(NamedTuple):
    obs: torch.Tensor  # [B, N, D_pad + N] padded obs + one-hot id
    actions: torch.Tensor  # [B, N] int32
    rewards: torch.Tensor  # [B] team reward ([B, N] per agent under IQL)
    done: torch.Tensor  # [B] episode termination


def _pad_width(env) -> int:
    return max(env.obs_dim(a) for a in env.agents)


def _with_id(parts, d_pad: int, eye: torch.Tensor, perm=None) -> torch.Tensor:
    """Rows [..., A_k, D_k] zero-padded to ``d_pad``, joined along the
    agent axis (reordered by ``perm``), then each agent's one-hot id."""
    rows = torch.cat([F.pad(o, (0, d_pad - o.shape[-1])) for o in parts], dim=-2)
    if perm is not None:
        rows = rows[..., perm, :]
    n = eye.shape[0]
    return torch.cat([rows, eye.expand(*rows.shape[:-2], n, n)], dim=-1)


def _pack_obs(env, obs, n_agents: int, eye: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Obs -> [..., N, D_pad + N]: every agent's row zero-padded to the
    widest, then its one-hot id.  ``obs`` is the JAX package's dict
    (agent -> [..., D_a]) or the env's class tensors ([..., A_g, od] per
    class), which hold the agents in ``env.agents`` order, class after
    class; ``eye`` is a cached ``torch.eye(N)``."""
    parts = [obs[a][..., None, :] for a in env.agents] if isinstance(obs, dict) else list(obs)
    if eye is None:
        eye = torch.eye(n_agents, dtype=parts[0].dtype, device=parts[0].device)
    return _with_id(parts, _pad_width(env), eye)


def pack_grouped(spec, obs_g, eye: torch.Tensor) -> torch.Tensor:
    """``_pack_obs`` from per-group obs [..., A_g, od] in the spec's group
    order (the world model's layout), the agents put back in agent order."""
    perm = None if spec.grouped_is_identity else list(spec.perm_from_grouped)
    return _with_id(obs_g, max(spec.obs_dims), eye, perm)


class VdnNetwork(nn.Module):
    """Shared-parameter or independent per-agent recurrent Q-nets.

    Sharing: one ``AgentRNN`` over the flattened (batch x agent) rows (the
    one-hot id tells the agents apart).  Independent: every leaf has a
    leading [N] (the JAX package's ``nn.vmap`` over the agent axis).
    ``in_dim`` is D_pad + N; flax infers it from the first input."""

    def __init__(self, action_dim: int, n_agents: int, hidden_dim: int = 64, param_share: bool = True, *,
                 in_dim: int, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.action_dim, self.n_agents, self.hidden_dim = action_dim, n_agents, hidden_dim
        self.param_share = param_share
        self.agent = AgentRNN(in_dim, action_dim, hidden_dim, 0 if param_share else n_agents, device, generator)

    def forward(self, hidden, obs, done):
        """hidden [B, N, H]; obs [T, B, N, D]; done [T, B] ->
        (hidden', q [T, B, N, A])."""
        if not self.param_share:
            return self.agent(hidden, obs, done)
        t, b, n, d = obs.shape
        dn = done[:, :, None].expand(t, b, n).reshape(t, b * n)
        h, q = self.agent(hidden.reshape(b * n, self.hidden_dim), obs.reshape(t, b * n, d), dn)
        return h.reshape(b, n, self.hidden_dim), q.reshape(t, b, n, self.action_dim)


@dataclass
class Runner:
    """The training state between updates (the JAX ``Runner``): the online
    network (``train_state.params``), its optimizer and the count of steps
    it took (``train_state.step``), the target network, the buffer, the
    envs, and the run's generator."""

    network: nn.Module
    optimizer: torch.optim.Optimizer
    target: nn.Module
    buffer_state: BufferState
    env_states: tuple
    obs: torch.Tensor  # [B, N, D]
    hidden: torch.Tensor  # [B, N, H]
    update_i: int
    generator: torch.Generator
    test_return: torch.Tensor
    opt_step: int = 0


def td_lambda_targets(rewards, done, qbar_next, gamma: float, lam: float) -> torch.Tensor:
    """TD(λ) targets by the pymarl2 backward recursion: rewards [L-1, S]
    r_t, done [L, S] bool, qbar_next [L-1, S] the target net's Qbar_{t+1}:

        G_{L-1} = Qbar_{L-1} * (1 - d_{L-1})
        G_t     = r_t + gamma*(1-d_t)*[(1-lam)*Qbar_{t+1} + lam*G_{t+1}]

    Returns [L-1, S] targets for steps 0..L-2."""
    not_done = 1.0 - done[:-1].to(torch.float32)
    g = qbar_next[-1] * (1.0 - done[-1].to(torch.float32))
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        g = rewards[t] + gamma * not_done[t] * ((1.0 - lam) * qbar_next[t] + lam * g)
        out.append(g)
    return torch.stack(out[::-1])


def _linear_schedule(lr: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule(lr, end, steps) at an optimizer count."""
    def at(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (lr - end) * frac + end

    return at


def _seed_generators(seed: int, device):
    """(the CPU generator that draws the weights, the run's generator)."""
    init = torch.Generator().manual_seed(stream_seed(seed, 0))
    run = torch.Generator(device=device)
    run.manual_seed(stream_seed(seed, 1))
    return init, run


def make_train(
    config: VdnConfig,
    env=None,
    metrics_callback=None,
    *,
    reward_fn=None,
    example_reward=None,
    loss_fn_builder=None,
    imagine_fn=None,
    imagine_weight: float = 1.0,
    params_fn=None,
    greedy_test: bool = True,
    device="cuda",
):
    """The training function: ``train(seed) -> {"runner", "metrics"}``,
    metrics numpy [num_updates] each, with ``train.init_runner(seed)``,
    ``train.update_chunk(runner, n) -> (runner, metrics [n])``,
    ``train.update_step(runner) -> device metrics of one update`` and
    ``train.learn(runner, batch, imagined=None) -> loss`` (one optimizer
    step on sampled windows), ``train.env`` and ``train.buffer`` on it.
    The env is built on ``device`` (the card unless the caller asks for
    the CPU), or ``env`` is used on its own.

    Variant hooks (how IQL, QMIX and Dyna reuse this machinery):
    - reward_fn(rewards [B, A], agents) -> the stored reward [B, ...]
      (default: reward_scale * team sum); the port hands in the stacked
      rewards, the JAX package the dict;
    - example_reward(n_agents) -> the stored reward's per-step shape
      (default: a scalar);
    - loss_fn_builder(apply, init_hidden, q_of_actions, config, n_agents)
      -> loss_fn(params, target_params, seq), where ``apply(params,
      hidden, obs, done)`` runs a network module (the flax module's
      ``apply`` in the JAX package);
    - imagine_fn(params, real_batch, generator) -> Timestep windows
      [S, H, ...] (Dyna), whose loss is added with weight
      ``imagine_weight`` whenever the buffer can sample; they are made
      without grad;
    - params_fn(generator) -> the online module (QMIX's agent + mixer),
      drawn on the CPU; ``greedy_test=False`` drops the greedy test and
      its ``test_return`` metric (QMIX has neither)."""
    if env is None:
        device = resolve_device(device)
        base_env = make_env(
            config.env_name, device=device,
            num_good_agents=config.num_good_agents, num_adversaries=config.num_adversaries,
            num_obs=config.num_obs, max_steps=config.max_env_steps,
        )
    else:
        base_env, device = env, env.device
    wrapped = LogWrapper(base_env)
    n_agents = base_env.num_agents
    n_actions = base_env.action_space(base_env.agents[0]).n
    rollout = BatchedEnv(wrapped, config.num_envs)
    test_rollout = BatchedEnv(wrapped, config.test_num_envs)
    d_in = _pad_width(base_env) + n_agents
    eye = torch.eye(n_agents, device=device)
    buffer = TrajectoryBuffer(
        add_batch_size=config.num_envs,
        time_capacity=config.buffer_size_time,
        min_length_time=config.min_buffer_time,
        sample_batch_size=config.batch_size,
        sample_sequence_length=config.sample_sequence_length,
    )
    eps_decay_updates = config.eps_decay * config.num_updates
    lr_at = (_linear_schedule(config.lr, 1e-10, config.num_updates) if config.lr_linear_decay
             else (lambda count: config.lr))
    do_test = greedy_test and config.test_during_training

    def pack(obs) -> torch.Tensor:
        return _pack_obs(base_env, obs, n_agents, eye)

    def init_hidden(batch: int) -> torch.Tensor:
        return torch.zeros((batch, n_agents, config.hidden_dim), device=device)

    def q_of_actions(q, actions):
        """q [T, B, N, A], actions [T, B, N] -> [T, B, N]."""
        return torch.gather(q, -1, actions.long()[..., None])[..., 0]

    def apply(params, hidden, obs, done):
        return params(hidden, obs, done)

    def new_network(generator: torch.Generator) -> nn.Module:
        if params_fn is not None:
            return params_fn(generator).to(device)
        return VdnNetwork(n_actions, n_agents, config.hidden_dim, config.param_share, in_dim=d_in,
                          generator=generator).to(device)

    def init_runner(seed: int) -> Runner:
        g_init, g = _seed_generators(seed, device)
        obs, env_states = rollout.reset_stacked(g)
        network = new_network(g_init)
        target = copy.deepcopy(network).requires_grad_(False)
        opt = torch.optim.Adam(network.parameters(), lr=lr_at(0), betas=(0.9, 0.999), eps=1e-5)
        packed = pack(obs)
        example = Timestep(
            obs=packed[0],
            actions=torch.zeros((n_agents,), dtype=torch.int32, device=device),
            rewards=(torch.as_tensor(example_reward(n_agents), device=device) if example_reward is not None
                     else torch.zeros((), device=device)),
            done=torch.zeros((), dtype=torch.bool, device=device),
        )
        return Runner(
            network=network, optimizer=opt, target=target, buffer_state=buffer.init(example),
            env_states=env_states, obs=packed, hidden=init_hidden(config.num_envs), update_i=0,
            generator=g, test_return=torch.zeros((), device=device),
        )

    def vdn_loss_fn(params, target_params, seq: Timestep):
        """seq leaves: [S, L, ...] sampled windows (batch-major)."""
        obs_t, act_t, rew_t, done_t = (x.transpose(0, 1) for x in seq)
        s = obs_t.shape[1]
        h0 = init_hidden(s)
        # hidden resets happen *after* a done step; shift dones right so
        # the first step of each window starts fresh
        done_prev = torch.cat([torch.ones((1, s), dtype=torch.bool, device=device), done_t[:-1]], dim=0)
        _, q_online = apply(params, h0, obs_t, done_prev)
        with torch.no_grad():
            _, q_target = apply(target_params, h0, obs_t, done_prev)
        vdn_q = torch.sum(q_of_actions(q_online, act_t), dim=-1)  # [L, S]
        # double-DQN: online argmax, target evaluation
        best = torch.argmax(q_online, dim=-1)
        vdn_target_next = torch.sum(q_of_actions(q_target, best), dim=-1)
        if config.td_lambda_loss:
            targets = td_lambda_targets(rew_t[:-1], done_t, vdn_target_next[1:], config.gamma, config.td_lambda)
        else:
            not_done = 1.0 - done_t[:-1].to(torch.float32)
            targets = rew_t[:-1] + config.gamma * not_done * vdn_target_next[1:]
        td = vdn_q[:-1] - targets.detach()
        return torch.mean(td * td)

    loss_fn = (loss_fn_builder(apply, init_hidden, q_of_actions, config, n_agents)
               if loss_fn_builder is not None else vdn_loss_fn)

    def learn(runner: Runner, batch: Timestep, imagined: Optional[Timestep] = None) -> torch.Tensor:
        """One optimizer step on ``batch`` (and the imagined windows)."""
        loss = loss_fn(runner.network, runner.target, batch)
        if imagined is not None:
            loss = loss + imagine_weight * loss_fn(runner.network, runner.target, imagined)
        opt = runner.optimizer
        opt.zero_grad(set_to_none=True)
        loss.backward()
        _clip_by_global_norm(runner.network.parameters(), config.max_grad_norm)
        for group in opt.param_groups:
            group["lr"] = lr_at(runner.opt_step)
        opt.step()
        runner.opt_step += 1
        return loss.detach()

    def store_reward(rew: torch.Tensor) -> torch.Tensor:
        if reward_fn is not None:
            return reward_fn(rew, base_env.agents)
        return config.reward_scale * torch.sum(rew, dim=-1)

    @torch.no_grad()
    def greedy_return(network: nn.Module, g: torch.Generator) -> torch.Tensor:
        tobs_c, tstates = test_rollout.reset_stacked(g)
        tobs = pack(tobs_c)
        th = init_hidden(config.test_num_envs)
        no_done = torch.zeros((1, config.test_num_envs), dtype=torch.bool, device=device)
        ret = torch.zeros(config.test_num_envs, device=device)
        for _ in range(config.test_num_steps):
            th, q = network(th, tobs[None], no_done)
            acts = torch.argmax(q[0], dim=-1).to(torch.int32)
            tobs_c, tstates, rew, _, _ = test_rollout.step_stacked(g, tstates, acts)
            tobs = pack(tobs_c)
            ret = ret + torch.sum(rew, dim=-1)
        return torch.mean(ret)

    def update_step(runner: Runner) -> Dict[str, Union[torch.Tensor, float]]:
        """One update in place: rollout, buffer add, learn when the buffer
        can sample, target copy, greedy test.  Reads nothing back from the
        device; returns the update's metrics (``epsilon`` a float, the
        rest device scalars)."""
        g, network = runner.generator, runner.network
        eps = epsilon_by_step(runner.update_i, config.eps_start, config.eps_finish, eps_decay_updates)
        env_states, obs, hidden = runner.env_states, runner.obs, runner.hidden
        no_done = torch.zeros((1, config.num_envs), dtype=torch.bool, device=device)
        steps, returned = [], []
        with torch.no_grad():
            for _ in range(config.num_steps):
                hidden, q = network(hidden, obs[None], no_done)
                actions = eps_greedy(q[0], eps, g)  # [B, N]
                next_obs, env_states, rew, done, info = rollout.step_stacked(g, env_states, actions)
                done_all = torch.all(done, dim=-1)
                hidden = torch.where(done_all[:, None, None], 0.0, hidden)
                steps.append(Timestep(obs=obs, actions=actions, rewards=store_reward(rew), done=done_all))
                returned.append(info["returned_episode_returns"])
                obs = pack(next_obs)
        traj = Timestep(*(torch.stack(xs, dim=1) for xs in zip(*steps)))  # [B, T, ...] rows for the ring
        runner.buffer_state = buffer.add(runner.buffer_state, traj)
        runner.env_states, runner.obs, runner.hidden = env_states, obs, hidden

        loss = torch.zeros((), device=device)
        if buffer.can_sample(runner.buffer_state):
            batch = buffer.sample(runner.buffer_state, g).experience
            imagined = None
            if imagine_fn is not None:
                # imagined from the real batch's starts under the current
                # policy, outside the grad: only the Q-loss differentiates
                with torch.no_grad():
                    imagined = imagine_fn(network, batch, g)
            loss = learn(runner, batch, imagined)
        if runner.update_i % config.target_update_interval == 0:
            with torch.no_grad():
                for t, p in zip(runner.target.parameters(), network.parameters()):
                    t.copy_(p)
        if do_test and runner.update_i % config.test_interval == 0:
            runner.test_return = greedy_return(network, g)
        metrics = {
            "loss": loss,
            "epsilon": eps,
            "mean_reward": torch.mean(traj.rewards),
            "returned_episode_returns": torch.mean(torch.stack(returned)),
        }
        if greedy_test:
            metrics["test_return"] = runner.test_return
        runner.update_i += 1
        return metrics

    def update_chunk(runner: Runner, length: int):
        """``length`` updates; the device metrics are read back every
        ``log_chunk`` updates, then the callback fires once per update.
        Returns (runner, numpy metrics [length])."""
        out: Dict[str, List[np.ndarray]] = {}
        done = 0
        while done < length:
            n = min(max(config.log_chunk, 1), length - done)
            first = runner.update_i
            rows = [update_step(runner) for _ in range(n)]
            chunk = {}
            for k in rows[0]:
                vals = [r[k] for r in rows]
                chunk[k] = (np.asarray(vals, np.float32) if isinstance(vals[0], float)
                            else torch.stack(vals).to(torch.float32).cpu().numpy())
            if metrics_callback is not None:
                for t in range(n):
                    metrics_callback({k: v[t] for k, v in chunk.items()}, first + t)
            for k, v in chunk.items():
                out.setdefault(k, []).append(v)
            done += n
        return runner, {k: np.concatenate(v) for k, v in out.items()}

    def train(seed: int):
        runner = init_runner(seed)
        runner, metrics = update_chunk(runner, config.num_updates)
        return {"runner": runner, "metrics": metrics}

    train.init_runner = init_runner
    train.update_chunk = update_chunk
    train.update_step = update_step
    train.learn = learn
    train.env = base_env
    train.buffer = buffer
    return train


def run_seeds(train, seeds) -> dict:
    """The seeds one after another: {"runners": [...], "metrics": numpy
    [len(seeds), num_updates] each} (the JAX package vmaps them)."""
    outs = [train(s) for s in seeds]
    return {"runners": [o["runner"] for o in outs],
            "metrics": {k: np.stack([o["metrics"][k] for o in outs]) for k in outs[0]["metrics"]}}


_SAFETENSORS_DTYPES = {np.dtype(np.float32): "F32", np.dtype(np.int32): "I32", np.dtype(np.bool_): "BOOL"}


def save_safetensors(tensors: Dict[str, np.ndarray], path: str) -> None:
    """The safetensors format, written with numpy: an 8-byte little-endian
    header length, a JSON header of dtype/shape/data_offsets per name, then
    the raw little-endian bytes in the header's order."""
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        a = np.ascontiguousarray(tensors[name])
        raw = a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": _SAFETENSORS_DTYPES[a.dtype], "shape": list(a.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    head += b" " * (-len(head) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def main(
    config_path: Optional[str] = None,
    _config_cls=VdnConfig,
    _make_train=None,
    _tag: str = "vdn",
    device="cuda",
    **overrides,
):
    """The CLI entry (the JAX ``main``): YAML + keyword overrides, the logging
    sinks, the seeds, the optional collect-policy save and
    ``{tag}_params.safetensors`` (the first seed's params, flax's
    ``/``-joined keys) in the current directory.  Returns the first seed's
    {"runner", "metrics"}."""
    from mfvae_tpu_torch.training.metrics import MetricsLogger, WandbLogger

    cfg = _config_cls.from_yaml(config_path) if config_path else _config_cls()
    for k, v in overrides.items():
        setattr(cfg, k, v)
    make_train_fn = _make_train or make_train

    callback = None
    logger = wb = None
    if cfg.log_during_training:
        logger = MetricsLogger(cfg.log_dir, cfg.run_name or _tag)
        wb = WandbLogger(project=cfg.wandb_project, mode=cfg.wandb_mode)

        def callback(metrics, update_i):
            step = int(update_i)
            for k, v in metrics.items():
                logger.scalar(f"{_tag}/{k}", float(v), step)
            wb.log({f"{_tag}/{k}": float(v) for k, v in metrics.items()}, step=step)

    train = make_train_fn(cfg, metrics_callback=callback, device=device)
    out = run_seeds(train, [stream_seed(cfg.seed, 1000 + i) for i in range(cfg.num_seeds)])
    metrics = out["metrics"]
    if logger is not None:
        logger.flush()
        logger.close()
        wb.finish()
    print(
        f"final loss={metrics['loss'][:, -1].mean():.4f} "
        f"mean_return={metrics['returned_episode_returns'][:, -1].mean():.2f} "
        f"test_return={metrics['test_return'][:, -1].mean():.2f}"
    )
    runner = out["runners"][0]  # the first seed is the one saved
    if getattr(cfg, "save_policy_path", ""):
        from mfvae_tpu_torch.baselines.collect_policy import save_policy

        env = train.env
        save_policy(
            cfg.save_policy_path,
            runner.network,
            hidden_dim=cfg.hidden_dim,
            param_share=cfg.param_share,
            action_dim=env.action_space(env.agents[0]).n,
            n_agents=env.num_agents,
        )
        print(f"saved collect policy -> {cfg.save_policy_path}")
    save_safetensors(flatten_flax(qnet_params_to_jax(runner.network.state_dict())), f"{_tag}_params.safetensors")
    return {"runner": runner, "metrics": {k: v[0] for k, v in metrics.items()}}


def cli(argv, main_fn) -> None:
    """``[cfg.yaml] [key=value ...] [--device cpu]``: values parse as YAML."""
    args = list(argv)
    device = "cuda"
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i:i + 2]
    path = args.pop(0) if args and "=" not in args[0] else None
    overrides = {}
    for a in args:
        key, _, value = a.partition("=")
        overrides[key] = yaml.safe_load(value)
    main_fn(path, device=device, **overrides)


if __name__ == "__main__":
    cli(sys.argv[1:], main)
