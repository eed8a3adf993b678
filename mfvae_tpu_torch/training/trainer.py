"""Train/test steps and the epoch program (mirror of
``mfvae_tpu/training/trainer.py``), in the optimizer modes Adam, ART and
POPART.

PyTorch runs eagerly, so the JAX package's scans become Python loops and
its vmapped eval becomes one forward over every eval batch at once (the
eval steps are independent given the parameters), or one per chunk of
whole eval batches where they hold more than ``EVAL_CHUNK_ROWS`` rows.  Where each step's loss
is a mean over an equal-sized batch, the mean of the per-step means is the
mean over the joined batch, and the losses are taken over the joined
batch.  That argument stops at ``loss.contact_weight > 0``: the weighted
state loss divides by each batch's own weight sum, so there the losses are
taken per eval batch and averaged, as the JAX package does.  The train
state is updated in place: one forward and one backward per train step,
then one Adam update.

Each epoch: collect ``sample_num`` env steps under the collect policy
(uniform random actions by default: discrete, or uniform in the Box for
continuous actions) into the train buffer, run ``train_num`` train steps
on uniform samples (or on windows, under ``unroll_steps``), collect
``sample_num`` more steps into the test buffer, evaluate ``test_num``
batches.  Noise comes from named generators (``rng.make_streams``):
actions and policy draws from "act", env resets from "reset", buffer
samples from "sample", train-step eps from "train", eval samples and eps
from "eval".
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from mfvae_tpu_torch.config import ExperimentConfig, LossConfig, TrainConfig
from mfvae_tpu_torch.data.buffer import BufferState, ItemBuffer, tree_leaves, tree_map
from mfvae_tpu_torch.data.transitions import GroupedTransition, VaeBatch, vae_batch_from_grouped
from mfvae_tpu_torch.envs.mpe import tag_prey_rel_slice
from mfvae_tpu_torch.envs.policies import make_collect_policy, reset_carry
from mfvae_tpu_torch.models.losses import LossOutputs, combine_losses, elbo_losses
from mfvae_tpu_torch.models.mavae import MAVAE, AgentSpec
from mfvae_tpu_torch.ops.fused_elbo import huber_mean
from mfvae_tpu_torch.parallel import tp
from mfvae_tpu_torch.parallel.dp import average_gradients, mean_over_data
from mfvae_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
from mfvae_tpu_torch.training.popart import (
    PopArtState,
    art,
    init_popart,
    normalize,
    pop_rescale_head,
)
from mfvae_tpu_torch.utils.profiling import span


# rows of one eval forward at most (whole eval batches; at least one): the
# eval of data_parallel.yaml, 64 batches of 4,096 rows at Σobs 5,660, took
# 61.6 GiB in one forward on an H100 80GB HBM3 at 700 W, 21.0 GiB in
# chunks of this size (PERF.md §6)
EVAL_CHUNK_ROWS = 32768


def _check_mode(mode: str) -> None:
    if mode not in ("Adam", "ART", "POPART"):
        raise ValueError(f"unknown train.mode {mode!r}")


def make_lr(cfg: TrainConfig) -> Callable[[int], float]:
    """step -> learning rate, with optax's schedule semantics (the count
    is the number of updates already applied)."""
    lr, t_max, floor = cfg.lr, cfg.lr_t_max, cfg.lr * cfg.lr_min_ratio
    if cfg.lr_schedule == "constant":
        return lambda step: lr
    if cfg.lr_schedule == "cosine":
        # optax.cosine_decay_schedule(lr, decay_steps=t_max, alpha=ratio)
        def cosine(step):
            frac = min(step, t_max) / t_max
            return lr * ((1 - cfg.lr_min_ratio) * 0.5 * (1 + math.cos(math.pi * frac)) + cfg.lr_min_ratio)

        return cosine
    if cfg.lr_schedule == "cosine_periodic":
        # CosineAnnealingLR's closed form, which keeps oscillating
        t = max(t_max, 1)
        return lambda step: floor + (lr - floor) * (1.0 + math.cos(math.pi * step / t)) / 2.0
    if cfg.lr_schedule == "warmup_cosine":
        # optax.warmup_cosine_decay_schedule(0, lr, warmup, decay, end)
        warmup = max(cfg.lr_warmup_steps, 1)
        decay = max(t_max, cfg.lr_warmup_steps + 1)

        def warmup_cosine(step):
            if step < warmup:
                return lr * step / warmup
            frac = min(step - warmup, decay - warmup) / (decay - warmup)
            return floor + (lr - floor) * 0.5 * (1 + math.cos(math.pi * frac))

        return warmup_cosine
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")


@dataclass
class TrainState:
    """The model, its Adam optimizer, the count of updates applied and the
    PopArt statistics (kept in every mode, as the JAX package keeps them)."""

    model: MAVAE
    optimizer: torch.optim.Optimizer
    lr_fn: Callable[[int], float]
    popart: PopArtState
    grad_clip: float = 0.0
    step: int = 0


# the JAX package's name for the MAVAE train state
VaeTrainState = TrainState


def create_train_state(model: MAVAE, cfg: TrainConfig) -> TrainState:
    # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8, the same update rule
    lr_fn = make_lr(cfg)
    opt = torch.optim.Adam(model.parameters(), lr=lr_fn(0), betas=(0.9, 0.999), eps=1e-8)
    device = next(model.parameters()).device
    return TrainState(
        model=model, optimizer=opt, lr_fn=lr_fn,
        popart=init_popart(model.spec.n_agents, device), grad_clip=cfg.grad_clip,
    )


def _kl_scale(loss_cfg: LossConfig, step: int) -> Optional[float]:
    if loss_cfg.kl_anneal_steps and loss_cfg.kl_anneal_steps > 0:
        return min(1.0, step / loss_cfg.kl_anneal_steps)
    return None


def _clip_by_global_norm(params, max_norm: float, mesh=None, split_dims=None) -> None:
    """optax.clip_by_global_norm: scale every gradient by max_norm / norm
    when the global norm exceeds max_norm (no host sync).  Under tensor
    parallelism (a ``mesh`` with 'model' > 1 and each parameter's
    ``split_dims``, ``parallel/tp.py``) a split parameter's squares are
    summed over 'model' and a replicated one's counted once."""
    params = list(params)
    if mesh is None or mesh.shape[MODEL_AXIS] == 1:
        grads = [p.grad for p in params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    else:
        kept = [(p.grad, d is not None) for p, d in zip(params, split_dims) if p.grad is not None]
        grads = [g for g, _ in kept]
        sq = torch.stack([torch.sum(g.to(torch.float32) ** 2) for g in grads])
        split = torch.tensor([s for _, s in kept], device=sq.device)
        norm = torch.sqrt(torch.sum(sq[~split]) + mesh.all_reduce(torch.sum(sq[split]), MODEL_AXIS))
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(factor)


def apply_update(state: TrainState, loss: torch.Tensor, mesh=None) -> None:
    """One optimizer update from ``loss``: backward, the gradients averaged
    over the mesh's 'data' axis, the global-norm clip when ``grad_clip`` >
    0, Adam at the schedule's lr; counts the step.  Spans ``train.backward``
    (to the averaged gradients) and ``train.update`` (the rest)."""
    with span("train.backward"):
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
            average_gradients(state.model.parameters(), mesh)
    with span("train.update"):
        if state.grad_clip > 0:
            dims = None if mesh is None else tp.split_dims(state.model)
            _clip_by_global_norm(state.model.parameters(), state.grad_clip, mesh, dims)
        for group in state.optimizer.param_groups:
            group["lr"] = state.lr_fn(state.step)
        state.optimizer.step()
    state.step += 1


def check_pallas_loss(loss_cfg: LossConfig, s_col_weight: Optional[torch.Tensor] = None) -> None:
    """The JAX package's guards on the kernel route: the kernels score
    unweighted huber with no free bits."""
    if loss_cfg.free_bits != 0.0:
        raise ValueError("the use_pallas path has no free-bits support")
    if not loss_cfg.use_huber:
        raise ValueError("the use_pallas path implements the huber family only")
    if s_col_weight is not None or loss_cfg.contact_weight != 0.0:
        raise ValueError(
            "the use_pallas path has no weighted-state-branch support "
            "(loss.contact_weight / loss.prey_dist_weight)"
        )


def make_train_step(
    loss_cfg: LossConfig,
    mode: str = "Adam",
    popart_beta: float = 3e-4,
    use_pallas: bool = False,
    s_col_weight: Optional[torch.Tensor] = None,
    mesh=None,
) -> Callable:
    """(state, batch: VaeBatch, generator=None, eps=None, eps_shared=None)
    -> (state, LossOutputs).  The state is updated in place and returned.

    With a ``mesh`` (``parallel/mesh.py``) the batch holds this data rank's
    rows: the PopArt moments and the contact weight sum are taken over the
    global batch, the gradients averaged over 'data' before the clip, and
    the losses averaged over 'data' (``parallel/dp.py``); the model may be
    tensor-parallel (``parallel/tp.py``).  At one rank every collective is
    skipped and the step computes what the step without a mesh does.

    Under ART and POPART the PopArt stats take one ``art`` update from the
    batch's rewards; POPART then rescales the reward head from the old
    stats to the new (Adam's moments are left as they are, as optax leaves
    them); the reward target is the rewards normalized by the new stats.

    ``use_pallas`` routes the forward through ``MAVAE.fused_call`` (kernels
    K1/K2) and the reconstruction losses through ``huber_mean`` (K3), under
    the JAX package's guards.  ``s_col_weight`` ([Σobs], from
    ``build_s_col_weight``) weights the state branch's columns.  Both
    routes draw eps from ``generator`` in the same way, or take ``eps``
    [B, A, F] (grouped order) and ``eps_shared`` [B, S] as given."""
    _check_mode(mode)
    use_art = mode in ("ART", "POPART")
    use_pop = mode == "POPART"
    if use_pallas:
        check_pallas_loss(loss_cfg, s_col_weight)
    if use_art and loss_cfg.contact_weight != 0.0:
        raise ValueError(
            "loss.contact_weight reads raw reward targets; ART/POPART "
            "normalization is unsupported — use train.mode='Adam'"
        )

    dp = mesh if mesh is not None and mesh.shape[DATA_AXIS] > 1 else None

    def train_step(state: TrainState, batch: VaeBatch, generator=None, eps=None, eps_shared=None):
        model = state.model
        reward_targets = batch.rewards
        with span("train.forward"):
            if use_art:
                pa_new = art(state.popart, batch.rewards, popart_beta, dp)
                if use_pop:
                    pop_rescale_head(model, state.popart, pa_new)
                state.popart = pa_new
                reward_targets = normalize(pa_new, batch.rewards)
            if use_pallas:
                recon_s, recon_r, kl_rows = model.fused_call(batch.inputs, None, generator, eps, eps_shared)
            else:
                recon_s, recon_r, mu, logvar = model(batch.inputs, None, generator, eps, eps_shared)
        kl_scale = _kl_scale(loss_cfg, state.step)
        with span("train.loss"):
            if use_pallas:
                s_loss = huber_mean(batch.next_state, recon_s, loss_cfg.huber_delta)
                r_loss = huber_mean(reward_targets, recon_r, loss_cfg.huber_delta)
                kl_loss = torch.mean(torch.sum(kl_rows, dim=1))
                out = combine_losses(s_loss, r_loss, kl_loss, loss_cfg, kl_scale)
            else:
                out = elbo_losses(
                    recon_s, recon_r, batch.next_state, reward_targets, mu, logvar,
                    loss_cfg, kl_scale=kl_scale, s_col_weight=s_col_weight, mesh=dp,
                )
        apply_update(state, out.loss, mesh)
        out = LossOutputs(*(x.detach() for x in out))
        return state, out if dp is None else mean_over_data(out, dp)

    return train_step


def make_test_step(
    loss_cfg: LossConfig, mode: str = "Adam", s_col_weight: Optional[torch.Tensor] = None, mesh=None,
) -> Callable:
    """Eval step: forward + losses, no gradient.  Under ART/POPART the
    reward target is normalized by the state's PopArt stats.

    ``test_step(state, batch, generator=None, eps=None, eps_shared=None,
    n_batches=1)``: ``batch`` may join ``n_batches`` equal eval batches.
    One forward covers them all; under ``loss.contact_weight`` the losses
    are taken per batch and averaged, elsewhere over the joined batch
    (the same number; see the module docstring).  With a ``mesh`` of
    several data ranks the batch holds this rank's rows of every eval batch
    and the losses are the global batch's, as in ``make_train_step``."""
    _check_mode(mode)
    use_art = mode in ("ART", "POPART")
    per_batch = loss_cfg.contact_weight > 0.0
    dp = mesh if mesh is not None and mesh.shape[DATA_AXIS] > 1 else None

    @torch.no_grad()
    def test_step(state: TrainState, batch: VaeBatch, generator=None, eps=None, eps_shared=None,
                  n_batches: int = 1) -> LossOutputs:
        reward_targets = batch.rewards
        if use_art:
            reward_targets = normalize(state.popart, batch.rewards)
        recon_s, recon_r, mu, logvar = state.model(batch.inputs, None, generator, eps, eps_shared)
        parts = (recon_s, recon_r, batch.next_state, reward_targets, mu, logvar)
        if not per_batch or n_batches == 1:
            out = elbo_losses(*parts, loss_cfg, s_col_weight=s_col_weight, mesh=dp)
        else:
            outs = [
                elbo_losses(*chunk, loss_cfg, s_col_weight=s_col_weight, mesh=dp)
                for chunk in zip(*(x.chunk(n_batches) for x in parts))
            ]
            out = LossOutputs(*(torch.stack(xs).mean() for xs in zip(*outs)))
        return out if dp is None else mean_over_data(out, dp)

    return test_step


def build_s_col_weight(spec: AgentSpec, cfg: ExperimentConfig, device=None) -> Optional[torch.Tensor]:
    """Column weights [Σobs] for ``loss.prey_dist_weight``: each
    adversary's relative-prey observation columns (``tag_prey_rel_slice``)
    count (1 + prey_dist_weight)x in the state branch.  None when the lever
    is off."""
    if cfg.loss.prey_dist_weight <= 0.0:
        return None
    if "simple_tag" not in cfg.env.name:
        raise ValueError(
            f"loss.prey_dist_weight knows the simple_tag obs layout only, got env {cfg.env.name!r}"
        )
    n_adv = cfg.env.num_adversaries
    od_adv = spec.obs_dims[0]
    sl = tag_prey_rel_slice(cfg.env.num_obs, n_adv, cfg.env.num_good_agents)
    w = torch.ones(sum(spec.obs_dims), dtype=torch.float32)
    for a in range(n_adv):
        base = a * od_adv
        w[base + sl.start : base + sl.stop] += cfg.loss.prey_dist_weight
    return w.to(device)


# ---------------------------------------------------------------------------
# Epoch program: collect -> train -> test-collect -> test-eval
# ---------------------------------------------------------------------------


class EnvCarry(NamedTuple):
    obs: tuple  # the env's class-tensor obs NamedTuple, from env.reset_stacked
    state: tuple  # the env's state NamedTuple
    policy: tuple = ()  # the collect policy's carry; () when it keeps none


class EpochCarry(NamedTuple):
    train_state: TrainState
    buffer_state: BufferState
    test_buffer_state: BufferState
    env: EnvCarry


class EpochMetrics(NamedTuple):
    train: LossOutputs
    test: LossOutputs


def stacked_to_grouped(spec: AgentSpec, stacked_obs) -> Tuple[torch.Tensor, ...]:
    """An env's class-tensor obs (one tensor per agent class) in the spec's
    group order; valid where classes and groups coincide, as in every MPE
    scenario: one class (spread), two (tag, adversary) or three
    (world_comm: the leader, whose 20 actions set it apart, the other
    adversaries and the good agents)."""
    fields = tuple(stacked_obs)
    if len(fields) != len(spec.groups):
        raise ValueError(f"env has {len(fields)} agent classes but spec has {len(spec.groups)} groups")
    for t, ((obs_dim, _), idxs) in zip(fields, spec.groups):
        if tuple(t.shape[-2:]) != (len(idxs), obs_dim):
            raise ValueError(f"class tensor {tuple(t.shape)} vs group ({len(idxs)}, {obs_dim})")
    return fields


def make_action_sampler(env, spec: AgentSpec):
    """Uniform random actions: discrete, each agent within its own range,
    or continuous, uniform in the Box bounds.

    Returns ``(sample, group_actions)``: ``sample(generator, leading=())``
    -> int32 [*leading, A] or float32 [*leading, A, act_dim];
    ``group_actions(actions)`` -> per-group tuple along the agent axis."""
    device = env.device
    group_idx = [torch.tensor(idxs, device=device) for _, idxs in spec.groups]
    if getattr(env, "discrete_actions", True):
        act_dims = torch.tensor(spec.act_dims, dtype=torch.float32, device=device)

        def sample(generator, leading=()):
            u = torch.rand(*leading, spec.n_agents, generator=generator, device=device)
            return torch.minimum((u * act_dims).to(torch.int32), act_dims.to(torch.int32) - 1)

        def group_actions(actions):
            return tuple(actions.index_select(-1, idx) for idx in group_idx)

        return sample, group_actions

    if len(set(spec.act_dims)) != 1:
        raise ValueError(f"continuous stepping needs one common act_dim, got {spec.act_dims}")
    act_dim = spec.act_dims[0]
    space = env.action_space(env.agents[0])
    lo, hi = float(space.low), float(space.high)

    def sample(generator, leading=()):
        u = torch.rand(*leading, spec.n_agents, act_dim, generator=generator, device=device)
        return u * (hi - lo) + lo

    def group_actions(actions):
        return tuple(actions.index_select(-2, idx) for idx in group_idx)

    return sample, group_actions


def _resolve_collect_policy(env, spec: AgentSpec, cfg: ExperimentConfig, sample_fn):
    """None for the reference's random rollouts, a learned Q-policy for
    ``vdn:<path.npz>`` (``baselines/collect_policy.py``), else a scripted
    policy (``envs/policies.py``); the mixtures draw from ``sample_fn``."""
    name = cfg.train.collect_policy
    if name.startswith("vdn:"):
        from mfvae_tpu_torch.baselines.collect_policy import load_collect_policy  # it imports this module

        return load_collect_policy(name[len("vdn:"):], env, spec, cfg.train.collect_epsilon, sample_fn)
    return make_collect_policy(
        env, spec, name, cfg.train.collect_epsilon, sample_fn, mix_frac=cfg.train.collect_mix_frac
    )


def init_policy_carry(env, spec: AgentSpec, cfg: ExperimentConfig, lead: tuple = ()) -> tuple:
    """The initial ``EnvCarry.policy`` of a fresh experiment: () for
    stateless collection, else the policy's ``init_carry(lead)``, with
    ``lead`` the env axes ([n_envs] on the batched path, this rank's envs
    under a mesh)."""
    sample_fn, _ = make_action_sampler(env, spec)
    policy = _resolve_collect_policy(env, spec, cfg, sample_fn)
    if not hasattr(policy, "init_carry"):
        return ()
    return policy.init_carry(lead)


def shard_buffer(buffer: ItemBuffer, cfg: ExperimentConfig, mesh=None) -> ItemBuffer:
    """The batched epoch's buffer (``train.n_envs`` > 1): one shard per
    env, splitting the capacity (a full one per shard would multiply the
    device memory by n_envs), each giving batch_size / n_envs items to
    every global batch.  With a ``mesh`` of D data ranks this rank holds
    its n_envs / D envs' shards and draws for all n_envs."""
    e = cfg.train.n_envs
    if cfg.buffer.batch_size % e:
        raise ValueError(
            f"train.n_envs={e} needs buffer.batch_size ({cfg.buffer.batch_size}) divisible by n_envs"
        )
    local_bs = cfg.buffer.batch_size // e
    d = mesh.shape[DATA_AXIS] if mesh is not None else 1
    return ItemBuffer(
        max_length=max(buffer.max_length // e, local_bs),
        min_length=max(buffer.min_length // e, 1),
        sample_batch_size=local_bs,
        shards=e // d,
        global_shards=e if d > 1 else 0,
        first_shard=mesh.index(DATA_AXIS) * (e // d) if d > 1 else 0,
    )


def make_phase_fns(
    env,
    spec: AgentSpec,
    buffer: ItemBuffer,
    test_buffer: ItemBuffer,
    cfg: ExperimentConfig,
    streams: Dict[str, torch.Generator],
    mesh=None,
):
    """(collect, train_phase, test_phase) closures over the run's streams.

    With ``train.n_envs`` = E > 1 this is the JAX package's batched epoch
    (``make_batched_epoch_fn``): the buffers are sharded
    (``shard_buffer``), the env carry has a leading [E] axis, the E envs
    step in lockstep and each env auto-resets on its own through
    ``torch.where``, with no host sync per step.  With
    ``train.unroll_steps`` = W > 1 each train step is the multi-step
    objective (``training/unroll.py``) on windows that never straddle a
    collection phase.

    With a ``mesh`` (``mesh.enable``, batched only) data rank d of D holds
    envs [d·E/D, (d+1)·E/D): their env and policy carries and both rings'
    shards.  Every draw of the epoch (actions, resets, samples, eps) is
    taken at its global shape from the same generator state on every rank
    and the rank keeps its rows, so the D ranks together compute the
    unsharded batched epoch, up to the order of the sums over ranks."""
    s_col_weight = build_s_col_weight(spec, cfg, env.device)
    W, E = cfg.train.unroll_steps, cfg.train.n_envs
    D = mesh.shape[DATA_AXIS] if mesh is not None else 1
    if W > 1:
        from mfvae_tpu_torch.training.unroll import make_unroll_train_step  # it imports this module

        if buffer.max_length % cfg.train.sample_num:
            what = (
                f"the per-shard capacity ({buffer.max_length} = max(max_size // n_envs, "
                f"batch_size // n_envs)) with n_envs={E}" if buffer.shards
                else f"buffer.max_size ({buffer.max_length})"
            )
            raise ValueError(
                f"unroll_steps > 1 needs {what} divisible by train.sample_num "
                f"({cfg.train.sample_num}) so windows never straddle collection phases"
            )
        unroll_step = make_unroll_train_step(
            spec, cfg.loss, W, cfg.train.mode,
            use_pallas=cfg.model.use_pallas,
            stop_gradient=cfg.train.unroll_stop_gradient,
            mean_feedback=cfg.train.unroll_mean_feedback,
            s_col_weight=s_col_weight,
            mesh=mesh,
        )
    else:
        train_step = make_train_step(
            cfg.loss, cfg.train.mode, cfg.train.popart_beta,
            use_pallas=cfg.model.use_pallas, s_col_weight=s_col_weight, mesh=mesh,
        )
    test_step = make_test_step(cfg.loss, cfg.train.mode, s_col_weight=s_col_weight, mesh=mesh)
    sample_actions, group_actions = make_action_sampler(env, spec)
    policy = _resolve_collect_policy(env, spec, cfg, sample_actions)
    stateful = hasattr(policy, "init_carry")
    lead = (E // D,) if E > 1 else ()
    global_lead = (E,) if E > 1 else ()

    def rows(tree, n_batches: int = 1):
        """This rank's rows of a draw over every env (or over every row of
        n_batches batches)."""
        return tree if D == 1 else tree_map(lambda x: mesh.local_rows(x, n_batches=n_batches), tree)

    def draw_eps(model: MAVAE, generator, n_rows: int, n_batches: int = 1):
        """(eps, eps_shared) of this rank's rows of a forward over n_rows
        rows of the run (n_batches blocks), drawn as that forward would."""
        eps, eps_s = model.draw_eps(generator, n_rows)
        return rows(eps, n_batches), None if eps_s is None else rows(eps_s, n_batches)

    def act(env_c: EnvCarry, pol_c):
        if policy is None:
            return pol_c, rows(sample_actions(streams["act"], global_lead))
        noise = rows(policy.draw_noise(streams["act"], global_lead))
        if stateful:
            return policy.step(pol_c, env_c.obs, env_c.state, streams["act"], noise=noise)
        return pol_c, policy(env_c.state, streams["act"], noise=noise)

    def collect(env_c: EnvCarry, buf_state: BufferState, which_buffer: ItemBuffer):
        with span("collect"):
            # the policy carry resumes from the previous phase or epoch, so an
            # episode spanning a phase boundary keeps its policy state
            pol_c = env_c.policy if env_c.policy or not stateful else policy.init_carry(lead)
            for _ in range(cfg.train.sample_num):
                pol_c, actions = act(env_c, pol_c)
                next_obs, next_state, rewards, done, _ = env.step_stacked(env_c.state, actions)
                tr = GroupedTransition(
                    obs=stacked_to_grouped(spec, env_c.obs),
                    actions=group_actions(actions),
                    next_obs=stacked_to_grouped(spec, next_obs),
                    rewards=rewards,
                    done=torch.amax(done.to(torch.float32), dim=-1),
                )
                buf_state = which_buffer.add(buf_state, tr)
                if E > 1:
                    # every env's reset is drawn and chosen on the device
                    done_all = torch.all(done, dim=-1)

                    def pick(a, b):
                        return torch.where(done_all.reshape(lead + (1,) * (a.dim() - 1)), a, b)

                    reset_obs, reset_state = rows(env.reset_stacked(streams["reset"], batch_shape=global_lead))
                    env_c = EnvCarry(tree_map(pick, reset_obs, next_obs), tree_map(pick, reset_state, next_state))
                    if stateful:
                        pol_c = reset_carry(policy, pol_c, done_all)
                elif bool(torch.all(done)):
                    # auto-reset at episode end; reading the flag waits for the step
                    env_c = EnvCarry(*env.reset_stacked(streams["reset"]))
                    if stateful:
                        pol_c = policy.init_carry()
                else:
                    env_c = EnvCarry(obs=next_obs, state=next_state)
            return env_c._replace(policy=pol_c), buf_state

    def window_eps(model: MAVAE):
        """``draw_eps`` of each of an unroll window's W steps, stacked."""
        steps = [draw_eps(model, streams["train"], cfg.buffer.batch_size) for _ in range(W)]
        eps_s = [s for _, s in steps]
        return torch.stack([e for e, _ in steps]), None if eps_s[0] is None else torch.stack(eps_s)

    def train_phase(train_state: TrainState, buf_state: BufferState):
        with span("train_phase"):
            outs = []
            for _ in range(cfg.train.train_num):
                if W > 1:
                    with span("train.sample"):
                        wb = buffer.sample_window(buf_state, streams["sample"], W, block=cfg.train.sample_num)
                    with span("train.eps"):
                        eps, eps_s = window_eps(train_state.model)
                    train_state, o = unroll_step(train_state, wb.experience, streams["train"], eps, eps_s)
                else:
                    with span("train.sample"):
                        batch = buffer.sample(buf_state, streams["sample"])
                        vb = vae_batch_from_grouped(spec, batch.experience)
                    with span("train.eps"):
                        eps, eps_s = draw_eps(train_state.model, streams["train"], cfg.buffer.batch_size)
                    train_state, o = train_step(train_state, vb, streams["train"], eps, eps_s)
                outs.append(o)
            return train_state, LossOutputs(*(torch.stack(xs).mean() for xs in zip(*outs)))

    # the reference divides the test phase's sums by train_num
    # (jax_ver/main.py:228-231); the JAX package keeps that under
    # bug_compat_rng on its single-env test phase
    test_scale = cfg.train.test_num / cfg.train.train_num if cfg.train.bug_compat_rng and E == 1 else None

    n_eval = cfg.train.test_num

    def test_phase(train_state: TrainState, buf_state: BufferState) -> LossOutputs:
        # the test_num eval batches as one forward, or as forwards over
        # chunks of whole batches past EVAL_CHUNK_ROWS rows (see the module
        # docstring); the draws are those of one forward: every sample, then
        # every eps
        with span("test_phase"):
            n = n_eval * test_buffer.sample_batch_size
            sampled = test_buffer.sample(buf_state, streams["eval"], batch_size=n).experience
            batch_rows = tree_leaves(sampled)[0].shape[0] // n_eval  # this rank's rows of one eval batch
            chunk = max(1, EVAL_CHUNK_ROWS // batch_rows)
            eps, eps_s = draw_eps(train_state.model, streams["eval"], n_eval * batch_rows * D, n_eval)
            outs = []
            for lo in range(0, n_eval, chunk):
                k = min(chunk, n_eval - lo)
                part = slice(lo * batch_rows, (lo + k) * batch_rows)
                vb = vae_batch_from_grouped(spec, tree_map(lambda x: x[part], sampled))
                o = test_step(train_state, vb, None, eps[part], None if eps_s is None else eps_s[part], n_batches=k)
                outs.append((o, k))
            if len(outs) == 1:
                out = outs[0][0]
            else:  # a mean over equal batches: the chunks' means weighted by their batch counts
                out = LossOutputs(*(sum(o[i] * k for o, k in outs) / n_eval for i in range(len(LossOutputs._fields))))
            if test_scale is not None:
                # the sum of the test_num per-batch means over train_num
                out = LossOutputs(*(x * test_scale for x in out))
            return out

    return collect, train_phase, test_phase


def make_epoch_fn(
    env,
    spec: AgentSpec,
    buffer: ItemBuffer,
    test_buffer: ItemBuffer,
    cfg: ExperimentConfig,
    streams: Dict[str, torch.Generator],
    mesh=None,
):
    """One epoch: EpochCarry -> (EpochCarry, EpochMetrics); batched when
    ``train.n_envs`` > 1, and sharded over ``mesh`` (see ``make_phase_fns``)."""
    collect, train_phase, test_phase = make_phase_fns(env, spec, buffer, test_buffer, cfg, streams, mesh)

    def epoch(carry: EpochCarry) -> Tuple[EpochCarry, EpochMetrics]:
        env_c, buf_state = collect(carry.env, carry.buffer_state, buffer)
        train_state, train_metrics = train_phase(carry.train_state, buf_state)
        env_c, test_buf_state = collect(env_c, carry.test_buffer_state, test_buffer)
        test_metrics = test_phase(train_state, test_buf_state)
        new_carry = EpochCarry(
            train_state=train_state,
            buffer_state=buf_state,
            test_buffer_state=test_buf_state,
            env=env_c,
        )
        return new_carry, EpochMetrics(train=train_metrics, test=test_metrics)

    return epoch
