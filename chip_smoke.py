#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (each exits non-zero on failure; nothing is caught and passed over):

1. Device: a CUDA card must be present; prints the card's name and power
   limit (nvidia-smi) and turns TF32 off for matmul and cuDNN.
2. Build: compiles ops/csrc/fused_elbo.cu and ops/csrc/lookup_grad.cu for
   sm_90a (cached by content).
3. Kernels against their plain PyTorch versions on the card, at the main
   path's shapes and at ragged ones, with times (CUDA events, median of
   30 loops of 20 back-to-back calls queued behind a device sleep, so host
   launch gaps are not counted; inputs are L2-warm).  The launch floor is
   the same median for an empty kernel (torch.cuda._sleep(0)).  K3 is also
   run in bf16 and f16, on misaligned views, at n = 1 and 3 and at its
   single-block threshold +-1; each case twice, bit-equal.  torch.profiler
   must show exactly one device kernel per K3 call at both branches' n.
   A sweep times K3 on one block against its multi-block grid, for the
   threshold's crossover.  K4 (the embedding lookups' backward) at the
   b4,096 lookups' shapes, [4,096, 30, 64] and [4,096, 10, 64] bf16, fixed
   positions in a 40-row table and 5 action bins: against its plain
   version (within 2^-19 of the magnitudes summed), twice bit-equal, timed
   as K1-K3 beside the library call it replaces (the cast to f32 and
   index_put_(accumulate=True)).
4. The main path with the kernels: the default ExperimentConfig (simple_tag
   30 adversaries + 10 good agents + 20 obstacles, batch 128, bf16,
   full widths) with model.use_pallas=true for 2 epochs, through
   Experiment(...).setup().run(); the launch counts must be K1 = K2 =
   train_num per epoch and K3 = 2 * train_num per epoch; K4 runs in each
   forward's backward of a use_pallas model, once a group for the
   agent-index embedding and once a group for discrete actions of at most
   8 (k4_per_step: 4 a step on simple_tag).
5. The same config on plain ops (use_pallas=false) for 1 epoch; no kernel
   may launch.
6. One train step by both routes from the same state, batch and generator
   state; the losses must agree within rtol 1e-4.
7. World model: examples/world_model.yaml at full width (det_features 128,
   residual_state, state_skip, decoder_layernorm, unfused decoders over a
   15,900-wide input, loss.s_weight 300, bf16) with model.use_pallas=true
   for 2 epochs (launches K1 = K2 = 20, K3 = 40), on plain ops for 1 epoch
   (no launches), and one train step by both routes (rtol 1e-4).
8. PopArt: examples/torch_popart.yaml (POPART, torch loss family,
   cosine_periodic lr, popart head, train_num 4) with the kernels for 2
   epochs (K1 = K2 = 8, K3 = 16); sigma must have moved off 1 and be
   finite; one train step by both routes (rtol 1e-4); and the PopArt
   invariant on the card: the denormalized reward prediction of the head,
   in float32 on a real batch's head input, before and after one
   pop_rescale_head, within rtol 1e-5 of its largest value.
9. examples/det_quality.yaml with latent_structure=shared_private, with
   the kernels for 1 epoch (K1 = K2 = 10, K3 = 20): the shared latent's
   noise and KL column on the card.
10. Plain-only options, 1 epoch each at full width, no launches, finite
   losses: the two-hot head with reward_head_input=pred_state and
   action_delta_head; examples/continuous_tag.yaml; loss.contact_weight=1
   with loss.prey_dist_weight=1.
11. Batched pursuit: examples/pursuit_collection.yaml with train.n_envs=4
   (4 envs in lockstep, buffer shards [4, 2,500, ...], no host sync per
   env step) with the kernels for 2 epochs (K1 = K2 = 20, K3 = 40), on
   plain ops for 1 epoch (no launches), one train step by both routes
   (rtol 1e-4), and the share of contact transitions in the train buffer
   beside a random-collection run of the same shape.
12. examples/episode_mix_collection.yaml with train.n_envs=4 and the
   kernels for 1 epoch (K1 = K2 = 10, K3 = 20); the per-env policy carry
   must be there afterwards.
13. examples/world_model_control.yaml (sticky 0.95, unroll_steps 8,
   grad_clip 10, action_delta_head, decoders over a 15,900-wide input) on
   plain ops for 2 epochs, and with model.use_pallas=true for 1 epoch,
   where the JAX package refuses it: K1 = K2 = 8 a train step (80), K3w =
   2 a step (20), K3 = 0.
14. examples/world_model_unroll.yaml with model.use_pallas=true for 1
   epoch (K1 = K2 = 80, K3w = 20, K3 = 0); with train.n_envs=4 on plain
   ops for 1 epoch: per-shard capacity 2,560, divisible by sample_num 128.
15. Serving the model of phase 13: WorldModel.predict on a buffer batch
   bit-equal to model.mean_call; a T = 25, B = 256 rollout, finite, whose
   first step is bit-equal to predict (and its time by CUDA events);
   rollout_accuracy at horizons (1, 5, 25), n_starts 256, burn_in 32,
   under random and pursuit collection, every metric finite.
16. The other scenarios at the default population (30 adversaries, 10 good
   agents, 20 obstacles, as the experiment passes them to make):
   simple_spread (one group of 10, obs 60), simple_adversary (1 + 10,
   obs 40/42) and simple_world_comm (the leader with 20 actions, 29
   adversaries, 10 good agents: obs 156/164/150, Σobs 6,412), each with
   the kernels for 1 epoch (K1 = K2 = 10, K3 = 20), on plain ops for 1
   epoch (no launches) and one train step by both routes (rtol 1e-4).
   K3 against its plain version at world_comm's state n = 820,736, twice
   bit-equal, timed as in phase 3.
17. Pursuit on simple_adversary: pursuit_collection.yaml with n_envs=4
   and the kernels for 1 epoch (K1 = K2 = 10, K3 = 20); every stored
   transition of each buffer shard shows its env's own goal (the good
   agents' goal channel equals exactly one landmark's offset).
18. Planning: through the control model of phase 13 (simple_tag, 40
   agents) factorized repeat MPC and CEM (iters 3) with N = 64 candidates
   of horizon H = 8, scored by the 30 adversaries' distance to the nearest
   prey; the same two actors through the true dynamics (EnvDynamicsModel)
   on simple_tag, and factorized MPC through it on simple_world_comm.
   Each serves E = 8 episodes of T = 25 steps through eval_joint_policy,
   the good agents at random; the adversary return beside a random
   policy's on the same episodes, and ms per served step (CUDA events).
   Every return finite; true-dynamics MPC beats random on simple_tag; an
   [E]-batched call of each true-dynamics actor equals E per-episode calls
   with the same draws.
19. Behavior learned in imagination: examples/behavior_policy.yaml at full
   width (40 agents, det_features 128, unfused decoders, sticky 0.9,
   unroll 8) trained on plain ops for 2 epochs; then train_behavior for 10
   updates each of distill (the recipe's 32 starts x (1 + 3 visited) x 24
   rollouts x 5 actions, horizon 8), reinforce and actor_critic (256
   starts x 16 rollouts): finite metrics, no kernel launch, ms per update
   (CUDA events, median of 6 more updates), the device time of one distill
   update (torch.profiler); save_policy -> load_policy with equal weights
   and actions; the adversary return of the sampled policy and of random
   actions over 32 episodes of 128 steps; one epoch collecting with
   imagination:<the saved policy>; a continuous actor_critic on
   examples/continuous_tag.yaml whose policy grads are finite and nonzero
   while the world model's grads stay as training left them; one update of each trainer on a
   tiny float32 model, card against CPU at the CPU tests' tolerances; the
   phase's peak device memory.
20. The Q-learning baselines at the YAMLs' full widths (simple_tag 30/10/20,
   40 agents, hidden 64): VDN on mfvae_tpu_torch/baselines/config/
   vdn_tuned.yaml (16 envs, batch 64, windows of 16, ring 2,048) for 30
   updates, with td_lambda_loss and with independent params for 10 each,
   IQL on iql.yaml for 20, QMIX at vdn_tuned's widths (mixing 32,
   hypernet 64) for 20, Dyna (horizon 8) through phase 19's world model
   for 10: ms per learning update (CUDA events, median), the learn step
   alone and the rest, finite metrics, a learn step by update 3, no kernel
   launch; the device-busy ms of one VDN update (torch.profiler);
   save_policy -> load_collect_policy acting as the trained network;
   self-play through phase 19's world model with the prey-distance scores
   of scripts/selfplay_study.py, 5 updates per team, the frozen team
   untouched; one epoch of examples/reference_parity.yaml collecting with
   vdn:<the saved policy> with the kernels (K1 = K2 = 10, K3 = 20) and one
   with train.n_envs=4 on plain ops; one update of each baseline and
   self-play team on a tiny float32 config, card against CPU within 1e-6;
   the phase's peak device memory and wall.
21. The host backend and the VAE families.  HostExperiment (env.backend=
   host) at the default config's widths (simple_tag 30/10/20, batch 128,
   sample_num 128, train_num 10): one host env with random actions and
   model.use_pallas=true for 2 epochs (no kernel launches, as in the JAX
   package; the native engine and the native ring resolved), 16 native
   envs (NativeBatchedCollector) under pursuit for 2 epochs, under
   vdn:<phase 20's policy> for 1, and simple_world_comm at the default
   population for 1.  Each prints its epoch walls, the ms each epoch
   waited on the collector, a train step's ms with the collector stopped
   and running, a host batch's sample and assembly+H2D ms, the host steps
   per second of a synchronous collect(2048) and the device-busy ms of one
   epoch's train steps (torch.profiler).  One train step on one host batch
   by the card and by the CPU: within 1e-6 at a tiny float32 config,
   within rtol 1e-4 of the losses at full width in float32 (the bf16
   difference printed beside it).  Then the VAE families at
   VaeExperimentConfig's defaults, 1,000 steps each (mlp, conv in bf16,
   factorized, and mlp with kl_anneal_steps 500 and free_bits 0.02): ms a
   step, the first and final loss (the final must be lower; with free
   bits, at least the KL floor free_bits * latent_dim), and one step
   card against CPU: its losses and each leaf's grads (over the leaf's
   largest) within 1e-6 in float32, 2^-7 for conv in bf16.  The params
   after the step are printed, not gated: Adam's first step moves every
   param by about lr whatever its grad's size, so a grad that cancels to
   about Adam's eps differs between the two by far more than 1e-6 after
   it.
22. The tooling of M20 at full width (simple_tag 30/10/20, 40 agents,
   Σobs 5,660) with model.use_pallas=true, printed beside the card's name
   and power limit.  run_multiseed on reference_parity.yaml for seeds
   0-3 and 2 epochs (K1 = K2 = 80, K3 = 160) beside a single Experiment at
   seed 0: replica 0's losses within rtol 1e-5 of the single run's, the
   lockstep epoch wall and the peak device memory.  profile_epochs=1 for 3
   epochs: the trace's device kernels named like K1-K3 must equal the
   launch counters of the traced epoch (10/10/20); the traced and an
   untraced epoch's wall.  debug_nans for 1 epoch (10/10/20), its wall
   beside the guard-off one; then an encoder weight set to NaN must raise
   FloatingPointError naming the module, and the guard must be off after.
   remat: one train step in float32 from the same state with and without
   it, fused and unfused decoders, grads within rtol 1e-5, each step's
   peak memory.  rng_mode=reference for 1 epoch (10/10/20) and one step by
   both routes from one generator state (rtol 1e-4).
   bug_compat_replication.yaml for 2 epochs (20/20/40): the actions
   stored in epochs 0 and 1 equal, and loss_test equal to the sum of the
   eval batches' losses over train_num (rtol 1e-5).  Import of a
   full-width reference-structure tree built in numpy (unfused decoders,
   float32): the card's mean_call within 1e-5 of the CPU's (over the
   largest output), export -> import and the numpy pickle round trip
   bit-equal, a pickle of another class refused.
23. (Run after phase 14, on its kernel run's trained state and ring.) One
   unroll train step of examples/world_model_unroll.yaml at full width, W
   = 8 over B = 256 windows with episode ends, by each route from one
   state, windows and eps: at float32 compute the losses within rtol 1e-5
   (tests/test_torch_cuda.py's route tolerance) and each leaf's gradient
   within 1e-5 of its norm (tests/test_torch_unroll.py holds it at 1e-6 on
   the CPU), at the recipe's bf16 the losses within rtol 1e-4 (phase 6's);
   the kernel route launches K1 = K2 = 8, K3w = 2, K4 = 32 and no K3, the
   plain route (its model without use_pallas) nothing; each route's step timed (CUDA events, median of 5).  K3w against its plain version at the
   tag_unroll.train_w8 cell's shapes (32,768 rows of 5,660 and of 40, f32;
   rtol 1e-5, twice bit-equal), timed as in phase 3 beside its bytes bound.
24. Scale-out at full width (simple_tag 30/10/20, 40 agents), printed
   beside the card's name and power limit.  (a) examples/data_parallel.yaml
   (8 envs, batch 4,096) with model.use_pallas=true for 2 epochs through
   Experiment at world size 1 over NCCL (launches K1 = K2 = 20, K3 = 40),
   its losses, every train step's loss and every epoch's eval bit-equal to
   the same config with mesh.enable=false; the epoch walls and the peak
   device memory above the phase's start.  (b) Two ranks sharing the card
   over gloo, one spawned process each, the kernels built once before:
   data parallel (mesh.data_axis=2, 4 envs a rank, 1 epoch, 10/10/20 per
   rank), each loss within rtol 2e-3 of (a)'s first epoch (the first train
   step's gap printed on its own) and the parameters bit-equal across the
   ranks; tensor parallel (mesh.model_axis=2) one float32 train step with
   TF32 off, its loss within rtol 1e-5 and every gradient within rtol 1e-5
   (atol 1e-5 of its leaf's largest) of the unsharded step, then one bf16
   epoch with the kernels (10/10/20 per rank), each loss within rtol 2e-3
   of (a)'s first epoch; the pipeline (pipelined_mlp,
   2 stages, 4 microbatches) through a 40-agent model with a uniform
   1,024-wide decoder body, its loss and gradients within atol 1e-5 of the
   unpipelined model.  The collectives that gloo refuses for CUDA tensors,
   staged through pinned host memory, are printed.  Each rank and each
   process group has a timeout; a rank that dies or hangs fails the script.
25. The reference-style path at full width (the default config:
   simple_tag 30/10/20, batch 128, bf16, model.use_pallas=true): the port's
   data/compat.py TransitionBuffer filled from the card's env with random
   actions, sampled, and create_dataset's per-agent dicts built with the
   Experiment's codebook.  (a) model(idx_state, actions, g) bit-equal to
   model(*group_dict_batch(...), g) from the same generator state.  (b) 3
   Adam steps on fused_call(*group_dict_batch(...)) with K3 on both losses;
   before each, a step of the plain dict call from a copy of the same
   state and generator state; each step's losses within rtol 1e-4.  (c) A permuted codebook (agent i reads
   id 39 - i from its data): fused_call's forward on the card against the
   CPU's (recon_state within 2^-7 of its largest, the losses within rtol
   2^-7, the model's bf16 tolerance), and unlike the positional forward.
   Launches K1 = 5, K2 = 3, K3 = 10, K4 = 12 (the actions' lookups in both
   routes' steps; the ids from the data keep the agent-index gather).
26. The b4096 step and shapes.  (d) det128 b4096 on simple_tag 30/10/20
   (the model from build_spec and MAVAE.from_config, a batch drawn on the
   card from seed 26), one train step by the plain route and one by K1-K3
   from copies of one state and one generator state: the losses within
   rtol 1e-4.  Launches: K1 = K2 = 1, K3 = 2 (the kernel route's one step;
   its model has no use_pallas, so no K4).  (e) K3 alone at n = 4,096 x
   5,660 = 23,183,360 in float32 and bfloat16 against its plain version
   (rtol 1e-5, atol 0, as phase 3), twice bit-equal.  (f) K1-K3 at the
   b4096 shapes ([163,840, 64] latents, the state and reward branches of
   K3): each held against its plain version on the same tensors with
   phase 3's gates, then timed as in phase 3.
27. The kernel list as one JSON line (K1-K3, K3w at phase 23's state
   shape, K4 at phase 3's shapes), the card, and the result line.  Every
   phase's launch counts cover K1-K4.

Phases 4-22 and 24-26 print their epoch walls, launches and losses.
"""

import copy
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# K1-K4's launch counters (mfvae_tpu_torch/utils/profiling.py) and the kernel each counts
KERNEL_COUNTERS = {"k1.launches": "reparam_kl_fwd_kernel", "k2.launches": "reparam_kl_bwd_kernel",
                   "k3.launches": "huber_mean_kernel", "k3w.launches": "huber_rows_wsum_kernel",
                   "k4.launches": "lookup_grad_kernel"}


def launch_counts() -> dict:
    """K1-K4's launch counters since the last ``reset_counters``, 0 where
    a kernel has not launched."""
    from mfvae_tpu_torch.utils import profiling

    counted = profiling.counters()
    return {k: counted.get(k, 0) for k in KERNEL_COUNTERS}


def k4_per_step(spec, model_cfg) -> int:
    """K4's launches in the backward of one forward of a model built with
    ``model.use_pallas`` and no ids from the data: the agent-index
    embedding's once a group, and the action embeddings' once a group
    whose discrete actions fit K4's bins (the routing of models/layers.py)."""
    from mfvae_tpu_torch.models.mavae import DTYPES
    from mfvae_tpu_torch.ops import lookup_grad

    dtype = DTYPES[model_cfg.compute_dtype]
    fixed = lookup_grad.supports(model_cfg.idx_features, 1, dtype)
    bins = sum(lookup_grad.supports(model_cfg.action_features, ad, dtype) for (_, ad), _ in spec.groups)
    return len(spec.groups) * fixed + (bins if model_cfg.discrete_act else 0)


def _to(x, dev):
    """Tensors, lists and (named) tuples of them, on ``dev``."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, list):
        return [_to(v, dev) for v in x]
    if isinstance(x, tuple):
        moved = [_to(v, dev) for v in x]
        return type(x)(*moved) if hasattr(x, "_fields") else tuple(moved)
    return x


def imagination_card_vs_cpu(dev) -> dict:
    """One update of each imagination trainer on a tiny float32 simple_tag
    world model (2 adversaries, 1 good agent, 1 obstacle), on the card and
    on the CPU from the same weights, starts and draws (drawn on the CPU):
    the tolerances the CPU tests hold the port to JAX with, params after
    the Adam step within rtol 1e-5 / atol 1e-7 and the continuous
    actor-critic's grads within rtol 1e-4 (atol 1e-4 of the leaf's
    largest).  Returns the largest param difference of each case."""
    import torch

    from mfvae_tpu_torch import imagination as imag
    from mfvae_tpu_torch.config import ModelConfig
    from mfvae_tpu_torch.envs.mpe import make
    from mfvae_tpu_torch.inference import WorldModel
    from mfvae_tpu_torch.models.mavae import MAVAE
    from mfvae_tpu_torch.training.experiment import build_spec

    plan, h, s, n = (0, 1), 4, 3, 2

    def world(device, discrete):
        env = make("MPE_simple_tag_v3", device=device, num_good_agents=1, num_adversaries=2, num_obs=1,
                   max_steps=16, discrete_actions=discrete)
        spec = build_spec(env)
        cfg = ModelConfig(discrete_act=discrete, idx_features=8, obs_features=8, action_features=8,
                          encoder_hidden=(16,), decoder_hidden=(32,), compute_dtype="float32")
        model = MAVAE.from_config(cfg, spec, device="cpu", generator=torch.Generator().manual_seed(0))
        return env, spec, WorldModel(model.to(device))

    def trainer(kind, wm, env, spec):
        """(init_fn, update_fn)"""
        kw = dict(horizon=h, hidden=(16,), learning_rate=1e-3)
        if kind == "reinforce":
            return imag.make_imagination_trainer(wm, env, spec, plan, n_rollouts=n, **kw)
        if kind.startswith("actor_critic"):
            ema = 0.1 if "target_ema" in kind else 0.0
            return imag.make_actor_critic_trainer(wm, env, spec, plan, n_rollouts=n, target_ema=ema, **kw)
        return imag.make_distillation_trainer(wm, env, spec, plan, visit_steps=2, teacher_mode="enumerated",
                                              m_rollouts=3, **kw)

    def modules(params):
        return params if isinstance(params, dict) else {"pi": params}

    worst = {}
    for kind, discrete in (("reinforce", True), ("actor_critic target_ema", True), ("distill enumerated", True),
                           ("actor_critic continuous", False)):
        g = torch.Generator().manual_seed(1)
        env, spec, wm = world("cpu", discrete)
        obs = tuple(torch.randn(s, len(i), od, generator=g) for (od, _), i in spec.groups)
        if kind.startswith("distill"):
            noise = imag.DistillNoise(
                imag.ImaginationRollout(wm, env, spec, plan, 2).draw_noise(g, s),
                imag.EnumeratedTeacher(wm, env, spec, plan, horizon=h, m_rollouts=3).draw_noise(g, 3 * s))
        else:
            noise = imag.ImaginationRollout(wm, env, spec, plan, h).draw_noise(g, s * n)
        after, init = {}, None
        for device in ("cpu", dev):
            env_d, spec_d, wm_d = (env, spec, wm) if init is None else world(device, discrete)
            init_fn, update_fn = trainer(kind, wm_d, env_d, spec_d)
            params, opt = init_fn(torch.Generator(device=device).manual_seed(2))
            if init is None:
                init = {k: {name: v.clone() for name, v in m.state_dict().items()} for k, m in modules(params).items()}
            else:
                for k, m in modules(params).items():
                    m.load_state_dict(init[k])
            update_fn(params, opt, _to(obs, device), noise=_to(noise, device))
            after[device] = modules(params)
            check(all(p.grad is None for p in wm_d.model.parameters()), f"{kind}: the world model took a grad")
        worst[kind] = 0.0
        for k, m in after["cpu"].items():
            for (name, p), q in zip(m.named_parameters(), after[dev][k].parameters()):
                q_cpu = q.detach().cpu()
                worst[kind] = max(worst[kind], float((q_cpu - p.detach()).abs().max()))
                check(torch.allclose(q_cpu, p.detach(), rtol=1e-5, atol=1e-7),
                      f"{kind}: {k}.{name} after the update differs between the card and the CPU")
                if not discrete and p.grad is not None:
                    gc = p.grad
                    check(torch.allclose(q.grad.cpu(), gc, rtol=1e-4, atol=1e-4 * float(gc.abs().max())),
                          f"{kind}: {k}.{name} grad differs between the card and the CPU")
    return worst


def behavior_phase(drive, examples: Path, tmp: str, dev):
    """Phase 19: behavior learned in imagination at the recipe's widths.
    ``drive(cfg, use_pallas, epochs, tmp, phase, label)`` trains a world
    model as phases 4-18 do.  Returns the phase's numbers and the trained
    behavior_policy.yaml experiment."""
    import torch

    from mfvae_tpu_torch import behavior
    from mfvae_tpu_torch.config import BehaviorConfig, load_config
    from mfvae_tpu_torch.imagination import make_policy_actor
    from mfvae_tpu_torch.inference import WorldModel
    from mfvae_tpu_torch.utils import profiling

    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    recipe = str(examples / "behavior_policy.yaml")
    exp, wall, _ = drive(load_config(recipe, []), False, 2, f"{tmp}/behavior", "19", "behavior_policy")
    c, m, b = exp.cfg, exp.cfg.model, exp.cfg.behavior
    check(exp.spec.n_agents == 40 and m.det_features == 128 and not m.fused_decoders
          and c.train.unroll_steps == 8 and c.train.collect_policy == "sticky" and c.train.collect_mix_frac == 0.9
          and (b.n_starts, b.m_rollouts, b.horizon, b.visit_steps) == (32, 24, 8, 3),
          "behavior_policy.yaml is not the configuration this phase names")
    out = {"world_model_epoch_wall_ms": wall}

    def timed_updates(exp, n):
        """n updates of exp.cfg.behavior's algorithm through a fresh
        WorldModel: (median ms per update by CUDA events, all ms, wm,
        params, update closure for one more)."""
        wm = WorldModel(exp.carry.train_state.model)
        plan = behavior.resolve_plan_agents(exp, exp.cfg.behavior)
        init_fn, update_fn = behavior.make_behavior_trainer(exp, wm, plan)
        g = torch.Generator(device=dev).manual_seed(19)
        pool = behavior.collect_start_states(exp, exp.cfg.behavior, g)
        params, opt = init_fn(g)
        k = min(exp.cfg.behavior.n_starts, exp.cfg.behavior.start_pool)

        def one():
            rows = torch.randperm(pool[0].shape[0], generator=g, device=dev)[:k]
            return update_fn(params, opt, tuple(o[rows] for o in pool), g)

        times = []
        for _ in range(n):
            if on_card:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                metrics = one()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                metrics = one()
                times.append(1e3 * (time.perf_counter() - t0))
            check(all(math.isfinite(float(v)) for v in metrics.values()), f"non-finite update metrics {metrics}")
        return statistics.median(times), times, wm, params, one

    results, out["launches"] = {}, {}
    for algo in ("distill", "reinforce", "actor_critic"):
        b.algo = algo
        b.updates = 10
        if algo != "distill":  # the config defaults, not the distill recipe's 32 starts
            b.n_starts = BehaviorConfig().n_starts
        profiling.reset_counters()
        t0 = time.perf_counter()
        result = behavior.train_behavior(exp)
        wall_s = time.perf_counter() - t0
        launches = launch_counts()
        check(not any(launches.values()), f"behavior {algo} launched kernels: {launches}")
        out["launches"] = {k: out["launches"].get(k, 0) + v for k, v in launches.items()}
        final = result.curve[-1]
        check(all(math.isfinite(v) for row in result.curve for v in row.values()), f"{algo}: non-finite {final}")
        ms, times, _, _, one = timed_updates(exp, 6)
        out[algo] = {"ms_per_update": ms, "ms_all": [round(x, 3) for x in times], "train_behavior_s": wall_s,
                     "n_starts": b.n_starts, "final": final}
        print(f"[19] {algo}: 10 updates through train_behavior in {wall_s:.2f} s, final {json.dumps(final)}; "
              f"ms per update {ms:.3f} (median of 6, CUDA events; all {out[algo]['ms_all']}); "
              f"launches {launches}", flush=True)
        if algo == "distill" and on_card:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                one()
                torch.cuda.synchronize()
            rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)]
            check(bool(rows), "torch.profiler recorded no device time for a distill update")
            out[algo]["device_busy_ms"] = sum(e.self_device_time_total for e in rows) / 1e3
            out[algo]["device_kernels"] = sum(e.count for e in rows)
            top = sorted(rows, key=lambda e: -e.self_device_time_total)[:8]
            out[algo]["top_kernels_ms"] = [(e.key[:80], e.count, e.self_device_time_total / 1e3) for e in top]
            print(f"[19] distill: one update keeps the device busy {out[algo]['device_busy_ms']:.3f} ms "
                  f"in {out[algo]['device_kernels']} kernels (torch.profiler); the largest (name, calls, ms): "
                  f"{json.dumps(out[algo]['top_kernels_ms'])}", flush=True)
        results[algo] = result

    # save -> load -> the served actor acts alike under the same draws
    result = results["distill"]
    b.algo = "distill"
    path = f"{tmp}/behavior/policy.pt"
    obs_dim = exp.spec.obs_dims[0]
    behavior.save_policy(path, result, b, obs_dim=obs_dim, act_dim=exp.spec.act_dims[0])
    policy, meta = behavior.load_policy(path, device=dev)
    same = all(torch.equal(policy.state_dict()[k], v) for k, v in result.policy.state_dict().items())
    check(same and meta["plan_agents"] == list(result.plan_agents), "the loaded policy differs from the saved one")
    obs, _ = exp.env.reset_stacked(torch.Generator(device=dev).manual_seed(20), batch_shape=(8,))
    for greedy in (True, False):
        a = make_policy_actor(result.policy, exp.env, exp.spec, result.plan_agents, greedy)
        z = make_policy_actor(policy, exp.env, exp.spec, result.plan_agents, greedy)
        noise = a.draw_noise(torch.Generator(device=dev).manual_seed(21), (8,))
        check(torch.equal(a(obs, noise=noise), z(obs, noise=noise)), f"greedy={greedy}: loaded policy acts otherwise")
    print(f"[19] save_policy -> load_policy: weights and actions (greedy and sampled, 8 envs) equal; "
          f"sidecar {json.dumps(meta)}", flush=True)

    # real-env return, policy against random, on the same 32 episodes
    t0 = time.perf_counter()
    out["returns"] = behavior.eval_returns(exp, result, 32, 128)
    check(all(math.isfinite(v) for v in out["returns"].values()), f"non-finite returns {out['returns']}")
    print(f"[19] adversary return over 32 episodes of 128 steps ({time.perf_counter() - t0:.2f} s): "
          f"{json.dumps(out['returns'])}", flush=True)
    wm_exp = exp  # phase 20's Dyna and self-play run through this world model
    del exp, results, result

    # the Dreamer loop's collection leg: one epoch with the saved policy
    cfg = load_config(recipe, [f"train.collect_policy=imagination:{path}"])
    exp, out["imagination_collect_epoch_wall_ms"], _ = drive(cfg, False, 1, f"{tmp}/imag_collect", "19",
                                                             "behavior_policy, imagination: collection")
    prev, fresh = exp.carry.env.policy
    check(tuple(prev.shape) == (exp.spec.n_agents,) and fresh.dtype == torch.bool, "no imagination policy carry")
    del exp

    # continuous actions: the critic's grads reach the policy through the world model
    cfg = load_config(str(examples / "continuous_tag.yaml"), ["behavior.algo=actor_critic"])
    exp, _, _ = drive(cfg, False, 1, f"{tmp}/continuous", "19", "continuous_tag")
    wm_grads = [None if p.grad is None else p.grad.clone() for p in exp.carry.train_state.model.parameters()]
    ms, times, wm, params, _ = timed_updates(exp, 5)
    grads = [p.grad for p in params["pi"].parameters()]
    check(all(gr is not None and bool(torch.isfinite(gr).all()) for gr in grads), "continuous: policy grad missing")
    norm = float(sum(gr.abs().sum() for gr in grads))
    check(norm > 0 and math.isfinite(norm), f"continuous: policy grad sum {norm}")
    check(all((p.grad is None) if g0 is None else torch.equal(p.grad, g0)
              for p, g0 in zip(wm.model.parameters(), wm_grads)),
          "continuous: the behavior updates moved the world model's grads")
    out["actor_critic continuous"] = {"ms_per_update": ms, "ms_all": [round(x, 3) for x in times],
                                      "policy_grad_abs_sum": norm}
    print(f"[19] continuous actor_critic: ms per update {ms:.3f} (median of 5), policy grad |sum| {norm:.6g}, "
          f"the world model's grads untouched", flush=True)
    del exp, wm, params

    out["card_vs_cpu_max_abs_diff"] = imagination_card_vs_cpu(dev)
    print(f"[19] one update of each trainer, card against CPU (tiny float32 model, the same draws): "
          f"largest param difference {json.dumps(out['card_vs_cpu_max_abs_diff'])}", flush=True)
    if on_card:
        out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["phase_wall_s"] = time.perf_counter() - t_phase
    print(f"[19] behavior summary: {json.dumps(out)}")
    print(f"[19] phase wall {out['phase_wall_s']:.1f} s", flush=True)
    return out, wm_exp


def baselines_card_vs_cpu(dev) -> dict:
    """One update of the baselines on tiny float32 configs (simple_tag, 2
    adversaries, 1 good agent, 1 obstacle), on the card and on the CPU from
    the same weights, windows and draws (made on the CPU): one clip + Adam
    step of VDN, VDN TD(lambda) with independent params, IQL and QMIX;
    Dyna's imagined windows through a tiny world model; one self-play
    update of each team.  Returns the largest difference of each case;
    params must agree within 1e-6."""
    import torch

    from mfvae_tpu_torch import imagination as imag
    from mfvae_tpu_torch.baselines import dyna, iql, qmix, vdn
    from mfvae_tpu_torch.config import ModelConfig
    from mfvae_tpu_torch.envs.mpe import make
    from mfvae_tpu_torch.inference import WorldModel
    from mfvae_tpu_torch.models.mavae import MAVAE
    from mfvae_tpu_torch.training.experiment import build_spec

    tiny = dict(num_good_agents=1, num_adversaries=2, num_obs=1, max_env_steps=5, num_envs=2, num_steps=8,
                num_updates=4, buffer_size_time=64, min_buffer_time=8, batch_size=4, sample_sequence_length=4,
                hidden_dim=16, test_during_training=False, log_during_training=False)
    worst = {}

    def largest(a, b):
        return max(float((x.detach().cpu() - y.detach()).abs().max()) for x, y in zip(a, b))

    for name, mod, cfg in (
        ("vdn", vdn, vdn.VdnConfig(**tiny)),
        ("vdn td_lambda independent", vdn, vdn.VdnConfig(td_lambda_loss=True, param_share=False, **tiny)),
        ("iql", iql, iql.IqlConfig(reward_scale=0.05, **tiny)),
        ("qmix", qmix, qmix.QmixConfig(mixing_dim=8, hypernet_dim=16, **tiny)),
    ):
        trains = {d: mod.make_train(cfg, device=d) for d in ("cpu", dev)}
        warm = trains["cpu"].init_runner(0)
        trains["cpu"].update_step(warm)  # fills the ring; its params are the start of the compared step
        batch = trains["cpu"].buffer.sample(warm.buffer_state, torch.Generator().manual_seed(1)).experience
        after = {}
        for d, train in trains.items():
            runner = train.init_runner(0)  # a fresh Adam on each side
            runner.network.load_state_dict(warm.network.state_dict())
            runner.target.load_state_dict(warm.target.state_dict())
            train.learn(runner, _to(batch, d))
            after[d] = list(runner.network.parameters())
        worst[name] = largest(after[dev], after["cpu"])
        check(worst[name] <= 1e-6, f"{name}: one update differs between the card and the CPU by {worst[name]}")

    def world(device):
        env = make("MPE_simple_tag_v3", device=device, num_good_agents=1, num_adversaries=2, num_obs=1,
                   max_steps=16)
        spec = build_spec(env)
        cfg = ModelConfig(idx_features=8, obs_features=8, action_features=8, encoder_hidden=(16,),
                          decoder_hidden=(32,), compute_dtype="float32")
        model = MAVAE.from_config(cfg, spec, device="cpu", generator=torch.Generator().manual_seed(0))
        return env, spec, WorldModel(model.to(device))

    # Dyna's imagined windows
    cfg = vdn.VdnConfig(**tiny)
    g = torch.Generator().manual_seed(2)
    d = max(world("cpu")[1].obs_dims) + 3  # padded obs + one-hot id
    net = vdn.VdnNetwork(5, 3, 16, in_dim=d, generator=g)
    real = vdn.Timestep(torch.randn(4, 2, 3, d, generator=g), torch.zeros(4, 2, 3, dtype=torch.int32),
                        torch.zeros(4, 2), torch.zeros(4, 2, dtype=torch.bool))
    windows = {}
    for d in ("cpu", dev):
        _, _, wm = world(d)
        imagine = dyna.make_imagine_fn(wm, cfg, horizon=3, imagine_eps=0.3)
        noise = imagine.draw_noise(torch.Generator().manual_seed(3), 4) if d == "cpu" else _to(noise, d)
        with torch.no_grad():
            windows[d] = imagine(net.to(d), _to(real, d), noise=noise)
    check(torch.equal(windows[dev].actions.cpu(), windows["cpu"].actions), "dyna: actions differ card/CPU")
    worst["dyna windows"] = largest((windows[dev].obs, windows[dev].rewards),
                                    (windows["cpu"].obs, windows["cpu"].rewards))
    check(torch.allclose(windows[dev].obs.cpu(), windows["cpu"].obs, rtol=1e-5, atol=1e-6)
          and torch.allclose(windows[dev].rewards.cpu(), windows["cpu"].rewards, rtol=1e-5, atol=1e-6),
          "dyna: imagined windows differ between the card and the CPU")

    # one self-play update of each team
    def score_a(states, rewards):
        return rewards[..., :2].sum(0)

    def score_b(states, rewards):
        return rewards[..., 2:].sum(0)

    for team in ("a", "b"):
        after, init = {}, None
        for d in ("cpu", dev):
            env, spec, wm = world(d)
            _, _, init_fn, up_a, up_b = imag.make_selfplay_trainer(wm, env, spec, score_a, score_b, horizon=3,
                                                                    n_rollouts=2, learning_rate=1e-3, hidden=(16,))
            (pa, opt_a), (pb, opt_b) = init_fn(torch.Generator(device=d).manual_seed(4))
            if init is None:
                init = [{k: v.clone() for k, v in m.state_dict().items()} for m in (pa, pb)]
                obs = tuple(torch.randn(3, len(i), od, generator=g) for (od, _), i in spec.groups)
                noise = imag.SelfplayRollout(wm, env, spec, 3).draw_noise(g, 6)
            pa.load_state_dict(init[0])
            pb.load_state_dict(init[1])
            if team == "a":
                up_a(pa, opt_a, pb, _to(obs, d), noise=_to(noise, d))
            else:
                up_b(pb, opt_b, pa, _to(obs, d), noise=_to(noise, d))
            after[d] = list(pa.parameters()) + list(pb.parameters())
        worst[f"selfplay team {team}"] = largest(after[dev], after["cpu"])
        check(worst[f"selfplay team {team}"] <= 1e-6, f"self-play team {team}: card and CPU differ")
    return worst


def baselines_phase(drive, examples: Path, tmp: str, dev, wm_exp) -> dict:
    """Phase 20: the Q-learning baselines at the YAMLs' full widths, Dyna
    and self-play over phase 19's behavior world model (``wm_exp``), and
    the vdn: collect policy.  Returns the phase's numbers."""
    import torch

    from mfvae_tpu_torch import imagination as imag
    from mfvae_tpu_torch.baselines import collect_policy, dyna, iql, qmix, vdn
    from mfvae_tpu_torch.behavior import collect_start_states
    from mfvae_tpu_torch.config import load_config
    from mfvae_tpu_torch.inference import WorldModel
    from mfvae_tpu_torch.training.experiment import build_spec
    from mfvae_tpu_torch.training.trainer import make_action_sampler
    from mfvae_tpu_torch.utils import profiling

    cfg_dir = Path(__file__).resolve().parent / "mfvae_tpu_torch" / "baselines" / "config"
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    out = {"launches": {}}

    def timed(fn, n):
        """n calls of fn, each between two CUDA events and synchronised:
        (median ms, all ms, the last result)."""
        times, res = [], None
        for _ in range(n):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            res = fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times), times, res

    def run(label, train, updates, cfg):
        """``updates`` updates of ``train``, timed one by one; learn timed
        alone on fresh windows.  Checks finite losses, a learn step by
        update 3 and no kernel launch."""
        profiling.reset_counters()
        t0 = time.perf_counter()
        runner = train.init_runner(cfg.seed)
        rows, times = [], []
        for i in range(updates):
            _, (ms,), m = timed(lambda: train.update_step(runner), 1)
            times.append(ms)
            rows.append({k: float(v) for k, v in m.items()})
            if i == 2:
                check(runner.opt_step >= 1, f"{label}: no learn step ran by update 3 (ring size "
                                            f"{runner.buffer_state.size})")
        wall_s = time.perf_counter() - t0
        check(all(math.isfinite(v) for r in rows for v in r.values()), f"{label}: non-finite metrics {rows[-1]}")
        launches = launch_counts()
        check(not any(launches.values()), f"{label} launched kernels: {launches}")
        g = torch.Generator(device=dev).manual_seed(20)
        batch = train.buffer.sample(runner.buffer_state, g).experience
        learn_ms, learn_all, _ = timed(lambda: train.learn(runner, batch), 5)
        # the updates that learn and run no greedy test
        learning = [ms for i, ms in enumerate(times) if i >= 3 and not (cfg.test_during_training
                                                                        and i % cfg.test_interval == 0)]
        ms = statistics.median(learning)
        res = {"updates": updates, "ms_per_update": ms, "ms_all": [round(x, 3) for x in times],
               "learn_ms": learn_ms, "rollout_ms": ms - learn_ms, "wall_s": wall_s, "final": rows[-1],
               "opt_steps": runner.opt_step}
        print(f"[20] {label}: {updates} updates in {wall_s:.2f} s; ms per learning update {ms:.3f} (median of "
              f"{len(learning)}, CUDA events), learn alone {learn_ms:.3f} (median of 5), rollout and the rest "
              f"{ms - learn_ms:.3f}; final {json.dumps(rows[-1])}; launches {launches}", flush=True)
        return res, runner

    # ----------------------------------------------------------- VDN family
    tuned = str(cfg_dir / "vdn_tuned.yaml")
    base = dict(num_updates=1500, log_during_training=False)

    def vdn_cfg(cls=vdn.VdnConfig, path=tuned, **kw):
        cfg = cls.from_yaml(path)
        for k, v in {**base, **kw}.items():
            setattr(cfg, k, v)
        return cfg

    cfg = vdn_cfg()
    check((cfg.num_good_agents, cfg.num_adversaries, cfg.num_obs, cfg.hidden_dim, cfg.num_envs, cfg.batch_size,
           cfg.sample_sequence_length, cfg.buffer_size_time) == (10, 30, 20, 64, 16, 64, 16, 2048),
          "vdn_tuned.yaml is not the configuration this phase names")
    train = vdn.make_train(cfg, device=dev)
    out["vdn"], runner = run("vdn (vdn_tuned.yaml)", train, 30, cfg)

    # device-busy time of one learning VDN update
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train.update_step(runner)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    check(bool(rows), "torch.profiler recorded no device time for a VDN update")
    out["vdn"]["device_busy_ms"] = sum(e.self_device_time_total for e in rows) / 1e3
    out["vdn"]["device_kernels"] = sum(e.count for e in rows)
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    out["vdn"]["top_kernels_ms"] = [(e.key[:60], e.count, e.self_device_time_total / 1e3) for e in top]
    print(f"[20] vdn: one learning update keeps the device busy {out['vdn']['device_busy_ms']:.3f} ms in "
          f"{out['vdn']['device_kernels']} kernels (torch.profiler); the largest (name, calls, ms): "
          f"{json.dumps(out['vdn']['top_kernels_ms'])}", flush=True)

    # save -> load: the reloaded policy acts greedily as the trained network
    path = f"{tmp}/vdn_policy.npz"
    env = train.env
    collect_policy.save_policy(path, runner.network, hidden_dim=cfg.hidden_dim, param_share=cfg.param_share,
                               action_dim=5, n_agents=env.num_agents)
    spec = build_spec(env)
    g_act = torch.Generator(device=dev).manual_seed(23)
    pol = collect_policy.load_collect_policy(path, env, spec, 0.0, make_action_sampler(env, spec)[0])
    obs, state = env.reset_stacked(torch.Generator(device=dev).manual_seed(21), batch_shape=(8,))
    carry = pol.init_carry((8,))
    h = torch.zeros(8, env.num_agents, cfg.hidden_dim, device=dev)
    for _ in range(4):
        carry, acts = pol.step(carry, obs, state, g_act)
        with torch.no_grad():
            h, q = runner.network(h, vdn._pack_obs(env, obs, env.num_agents)[None],
                                  torch.zeros(1, 8, dtype=torch.bool, device=dev))
        check(torch.equal(acts, torch.argmax(q[0], -1).to(torch.int32)), "the reloaded policy acts otherwise")
        obs, state, *_ = env.step_stacked(state, acts)
    print(f"[20] save_policy -> load_policy: greedy actions of 8 envs over 4 steps equal ({path})", flush=True)
    del runner, train

    for label, kw, n in (("vdn td_lambda", dict(td_lambda_loss=True), 10),
                         ("vdn independent params", dict(param_share=False), 10)):
        c = vdn_cfg(**kw)
        out[label], _ = run(label, vdn.make_train(c, device=dev), n, c)
    c = vdn_cfg(iql.IqlConfig, str(cfg_dir / "iql.yaml"))
    out["iql"], _ = run("iql (iql.yaml)", iql.make_train(c, device=dev), 20, c)
    c = vdn_cfg(qmix.QmixConfig, mixing_dim=32, hypernet_dim=64)
    out["qmix"], _ = run("qmix (vdn_tuned widths, mixing 32, hypernet 64)", qmix.make_train(c, device=dev), 20, c)

    # ---------------------------------------------- Dyna over phase 19's model
    wm = WorldModel(wm_exp.carry.train_state.model)
    wm_grads = [None if p.grad is None else p.grad.clone() for p in wm.model.parameters()]
    check(wm.spec.n_agents == 40, "the behavior world model is not simple_tag's 40 agents")
    c = vdn_cfg()
    out["dyna"], _ = run("dyna (vdn_tuned, horizon 8, behavior world model)",
                         dyna.make_dyna_train(c, wm, horizon=8, device=dev), 10, c)

    # ------------------------------------------------- self-play, same model
    exp = wm_exp
    n_adv, n_good = exp.cfg.env.num_adversaries, exp.cfg.env.num_good_agents
    od_adv = exp.spec.obs_dims[0]
    prey_off = 4 + 2 * exp.cfg.env.num_obs + 2 * (n_adv - 1)

    def pair_dists(states):  # [H, B, Σobs] -> [H, B, adv, good] (scripts/selfplay_study.py:70-77)
        hh, bb = states.shape[:2]
        adv = states[:, :, : n_adv * od_adv].reshape(hh, bb, n_adv, od_adv)
        rel = adv[..., prey_off: prey_off + 2 * n_good].reshape(hh, bb, n_adv, n_good, 2)
        return torch.sqrt(torch.sum(rel * rel, dim=-1) + 1e-12)

    def score_adv(states, rewards):
        return -torch.sum(torch.amin(pair_dists(states), dim=-1), dim=0)

    def score_prey(states, rewards):
        return torch.sum(torch.amin(pair_dists(states), dim=-2), dim=0)

    g = torch.Generator(device=dev).manual_seed(22)
    bcfg = copy.deepcopy(exp.cfg.behavior)
    bcfg.start_pool = 4096
    pool = collect_start_states(exp, bcfg, g)
    _, _, init_fn, up_a, up_b = imag.make_selfplay_trainer(wm, exp.env, exp.spec, score_adv, score_prey,
                                                            horizon=8, n_rollouts=16)
    (pa, opt_a), (pb, opt_b) = init_fn(g)

    def starts():
        idx = torch.randint(0, pool[0].shape[0], (16,), generator=g, device=dev)
        return tuple(o[idx] for o in pool)

    profiling.reset_counters()
    sp = {}
    for team, update, mine, opt, other in (("a", up_a, pa, opt_a, pb), ("b", up_b, pb, opt_b, pa)):
        frozen = {k: v.clone() for k, v in other.state_dict().items()}
        ms, times, m = timed(lambda: update(mine, opt, other, starts(), g)[2], 5)
        check(all(p.grad is None for p in other.parameters())
              and all(torch.equal(v, frozen[k]) for k, v in other.state_dict().items()),
              f"self-play: the frozen team moved or took a grad while team {team} trained")
        check(all(math.isfinite(float(v)) for v in m.values()), f"self-play team {team}: non-finite {m}")
        sp[team] = {"ms_per_update": ms, "ms_all": [round(x, 3) for x in times],
                    "final": {k: float(v) for k, v in m.items()}}
    launches = launch_counts()
    check(not any(launches.values()), f"self-play launched kernels: {launches}")
    check(all((p.grad is None) if g0 is None else torch.equal(p.grad, g0)
              for p, g0 in zip(wm.model.parameters(), wm_grads)),
          "Dyna or self-play moved the world model's grads")
    out["selfplay"] = sp
    print(f"[20] self-play (16 starts x 16 rollouts, horizon 8, prey-distance scores): ms per update, adversaries "
          f"{sp['a']['ms_per_update']:.3f}, prey {sp['b']['ms_per_update']:.3f} (median of 5, CUDA events); "
          f"final {json.dumps({t: sp[t]['final'] for t in sp})}; frozen team untouched", flush=True)
    del exp, wm, pool

    # ------------------------------------------- vdn: collection, both paths
    recipe = str(examples / "reference_parity.yaml")
    for label, overrides, use_pallas in (("vdn: collection", [], True),
                                         ("vdn: collection, n_envs=4", ["train.n_envs=4"], False)):
        c = load_config(recipe, [f"train.collect_policy=vdn:{path}", *overrides])
        exp, wall, launches = drive(c, use_pallas, 1, f"{tmp}/vdn_collect_{len(overrides)}", "20",
                                    f"reference_parity, {label}")
        (hidden,) = exp.carry.env.policy
        check(tuple(hidden.shape) == ((4,) if overrides else ()) + (40, cfg.hidden_dim), "no vdn: policy carry")
        out["launches"][label] = launches
        out[label] = {"epoch_wall_ms": wall}
        del exp

    out["card_vs_cpu_max_abs_diff"] = baselines_card_vs_cpu(dev)
    print(f"[20] one update of each baseline and self-play team, card against CPU (tiny float32, the same "
          f"draws): largest difference {json.dumps(out['card_vs_cpu_max_abs_diff'])}", flush=True)
    out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["phase_wall_s"] = time.perf_counter() - t_phase
    print(f"[20] baselines summary: {json.dumps(out)}")
    print(f"[20] peak device memory {out['peak_memory_gib']:.3f} GiB; phase wall {out['phase_wall_s']:.1f} s",
          flush=True)
    return out


def host_step_card_vs_cpu(exp, dev, seed: int, compute_dtype=None) -> dict:
    """One train step on one host batch of ``exp`` (on the card) by the card
    and by the CPU, from the same params, fresh Adam and the same eps (made
    on the CPU), in ``compute_dtype`` (default: the config's).  Returns the
    losses' largest relative difference and the params' largest absolute
    difference."""
    import torch

    from mfvae_tpu_torch.models.mavae import MAVAE
    from mfvae_tpu_torch.training.trainer import create_train_state, make_train_step

    cfg, spec = exp.cfg, exp.spec
    model_cfg = copy.deepcopy(cfg.model)
    model_cfg.compute_dtype = compute_dtype or model_cfg.compute_dtype
    init = {k: v.detach().cpu() for k, v in exp.train_state.model.state_dict().items()}
    batch = exp.device_batch(exp.buffer.sample())
    eps = torch.randn(cfg.buffer.batch_size, spec.n_agents, cfg.model.obs_features,
                      generator=torch.Generator().manual_seed(seed))
    res = {}
    for d in ("cpu", dev):
        model = MAVAE.from_config(model_cfg, spec, device=d)
        model.load_state_dict(init)
        state = create_train_state(model, cfg.train)
        step = make_train_step(cfg.loss, cfg.train.mode, cfg.train.popart_beta)
        _, outs = step(state, _to(batch, d), eps=eps.to(d))
        res[d] = ([float(x) for x in outs], [p.detach().cpu() for p in model.parameters()])
    (l_cpu, p_cpu), (l_dev, p_dev) = res["cpu"], res[dev]
    return {"loss_rel": max(abs(a - b) / max(abs(a), 1e-30) for a, b in zip(l_cpu, l_dev)),
            "param_abs": max(float((a - b).abs().max()) for a, b in zip(p_cpu, p_dev))}


def host_phase(tmp: str, dev, policy: str) -> dict:
    """Phase 21, part 1: HostExperiment at the default config's widths.
    ``policy`` is phase 20's vdn: policy file.  Returns the phase's numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mfvae_tpu_torch.config import ExperimentConfig, apply_overrides
    from mfvae_tpu_torch.envs import native_engine as ne
    from mfvae_tpu_torch.envs.host_adapter import NativeBatchedCollector
    from mfvae_tpu_torch.training.host_experiment import HostExperiment
    from mfvae_tpu_torch.utils import profiling

    out = {"launches": {}}
    t_phase = time.perf_counter()

    def train_steps(exp, n):
        """ms of each of n train steps on fresh host batches, synchronised."""
        times = []
        for _ in range(n):
            t = time.perf_counter()
            exp.train_step(exp.train_state, exp.device_batch(exp.buffer.sample()), exp.streams["train"])
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t))
        return times

    runs = (
        ("n_host_envs=1, random, use_pallas=true", ["model.use_pallas=true"], 2),
        ("n_host_envs=16, pursuit", ["env.n_host_envs=16", "train.collect_policy=pursuit"], 2),
        ("n_host_envs=16, vdn:", ["env.n_host_envs=16", f"train.collect_policy=vdn:{policy}"], 1),
        ("simple_world_comm, n_host_envs=16", ["env.name=MPE_simple_world_comm_v3", "env.n_host_envs=16"], 1),
    )
    for i, (label, overrides, epochs) in enumerate(runs):
        cfg = ExperimentConfig()
        apply_overrides(cfg, ["env.backend=host", f"train.epoch_num={epochs}", *overrides])
        cfg.train.log_dir = f"{tmp}/host{i}/results"
        check((cfg.env.num_adversaries, cfg.env.num_good_agents, cfg.env.num_obs, cfg.buffer.batch_size,
               cfg.train.sample_num, cfg.train.train_num) == (30, 10, 20, 128, 128, 10),
              "the host runs are not at the default config's widths")
        exp = HostExperiment(cfg).setup()
        check(isinstance(exp.env, ne.NativeHostEnv), f"host {label}: {type(exp.env).__name__} resolved, "
                                                      "not the native engine")
        check(exp.buffer.buffer.backend == "native", f"host {label}: the {exp.buffer.buffer.backend} ring "
                                                      "resolved, not the native one")
        if cfg.env.n_host_envs > 1:
            check(type(exp.collector) is NativeBatchedCollector,
                  f"host {label}: {type(exp.collector).__name__} resolved, not NativeBatchedCollector")
        if "world_comm" in label:
            check(exp.spec.n_agents == 40 and exp.spec.act_dims[0] == 20 and len(exp.spec.groups) == 3,
                  "simple_world_comm is not at the default population")
        profiling.reset_counters()
        exp.result = result = exp.run()
        torch.cuda.synchronize()
        launches = launch_counts()
        out["launches"][f"host: {label}"] = launches
        check(not any(launches.values()), f"host {label} launched kernels: {launches}")
        check(math.isfinite(result["loss_train"]), f"host {label}: non-finite loss {result}")
        check(result["host_steps"] >= epochs * cfg.train.sample_num, f"host {label}: {result['host_steps']} steps")
        r = {"epoch_wall_ms": [1e3 * x for x in result["epoch_wall_s"]],
             "collector_wait_ms": [1e3 * x for x in result["collector_wait_s"]],
             "loss_train": result["loss_train"], "host_steps": result["host_steps"]}
        r["train_step_ms_stopped"] = statistics.median(train_steps(exp, 6))
        sample_ms, assemble_ms = [], []
        for _ in range(10):
            t = time.perf_counter()
            sample = exp.buffer.sample()
            t1 = time.perf_counter()
            exp.device_batch(sample)
            torch.cuda.synchronize()
            sample_ms.append(1e3 * (t1 - t))
            assemble_ms.append(1e3 * (time.perf_counter() - t1))
        r["sample_ms"], r["assemble_h2d_ms"] = statistics.median(sample_ms), statistics.median(assemble_ms)
        s0, t = exp.collector.steps, time.perf_counter()
        exp.collector.collect(2048)
        r["collect_steps_per_s"] = (exp.collector.steps - s0) / (time.perf_counter() - t)
        exp.collector.start()
        try:
            time.sleep(0.05)
            r["train_step_ms_running"] = statistics.median(train_steps(exp, 6))
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                train_steps(exp, cfg.train.train_num)
                r["profiled_epoch_ms"] = 1e3 * (time.perf_counter() - t)
        finally:
            exp.collector.stop()
        rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
        check(bool(rows), f"host {label}: torch.profiler recorded no device time")
        r["device_busy_ms"] = sum(e.self_device_time_total for e in rows) / 1e3
        r["device_kernels"] = sum(e.count for e in rows)
        out[label] = r
        print(f"[21] host {label}: epoch wall ms {[round(x, 3) for x in r['epoch_wall_ms']]}, waited on the "
              f"collector ms {[round(x, 3) for x in r['collector_wait_ms']]}; train step ms (median of 6) collector "
              f"stopped {r['train_step_ms_stopped']:.3f}, running {r['train_step_ms_running']:.3f}; host batch: "
              f"sample {r['sample_ms']:.3f} ms, assembly + H2D {r['assemble_h2d_ms']:.3f} ms; collect(2048) "
              f"{r['collect_steps_per_s']:.1f} host steps/s; one epoch's {cfg.train.train_num} train steps keep "
              f"the device busy {r['device_busy_ms']:.3f} of {r['profiled_epoch_ms']:.3f} ms in "
              f"{r['device_kernels']} kernels; {result['host_steps']} host steps; loss_train "
              f"{result['loss_train']:.6f}; launches {launches}", flush=True)
        if i == 0:
            full = host_step_card_vs_cpu(exp, dev, 3, "float32")
            bf16 = host_step_card_vs_cpu(exp, dev, 3)
            out["card_vs_cpu_full_width"] = {"float32": full, "bfloat16": bf16}
            print(f"[21] one host train step at full width, card against CPU: float32 losses rel "
                  f"{full['loss_rel']:.3e} (rtol 1e-4), params |diff| {full['param_abs']:.3e}; the config's bf16 "
                  f"(not gated: each side rounds its own products) losses rel {bf16['loss_rel']:.3e}, params "
                  f"|diff| {bf16['param_abs']:.3e}", flush=True)
            check(full["loss_rel"] <= 1e-4, "host: card and CPU losses differ beyond rtol 1e-4 at full width")
        del exp

    cfg = ExperimentConfig()
    apply_overrides(cfg, ["env.backend=host", "env.num_good_agents=1", "env.num_adversaries=2", "env.num_obs=1",
                          "model.compute_dtype=float32", "model.idx_features=8", "model.obs_features=8",
                          "model.action_features=8", "model.encoder_hidden=[16]", "model.decoder_hidden=[32]",
                          "buffer.batch_size=8"])
    cfg.train.log_dir = f"{tmp}/host_tiny/results"
    exp = HostExperiment(cfg).setup()
    exp.collector.collect(64)
    tiny = host_step_card_vs_cpu(exp, dev, 4)
    out["card_vs_cpu_tiny"] = tiny
    print(f"[21] one host train step at a tiny float32 config, card against CPU: losses rel {tiny['loss_rel']:.3e}, "
          f"params |diff| {tiny['param_abs']:.3e} (1e-6)", flush=True)
    check(tiny["param_abs"] <= 1e-6 and tiny["loss_rel"] <= 1e-6, "host: card and CPU differ at a tiny config")
    out["phase_wall_s"] = time.perf_counter() - t_phase
    return out


def vae_phase(tmp: str, dev) -> dict:
    """Phase 21, part 2: the VAE families at VaeExperimentConfig's defaults,
    1,000 steps each, and one step card against CPU."""
    import torch

    from mfvae_tpu_torch.training import vae_experiment as ve
    from mfvae_tpu_torch.training.vae_trainer import create_vae_state, make_vae_train_step
    from mfvae_tpu_torch.utils import profiling

    out = {}
    t_phase = time.perf_counter()
    runs = (("mlp", {}), ("conv", {}), ("factorized", {}), ("mlp beta", {"kl_anneal_steps": 500, "free_bits": 0.02}))
    for label, kw in runs:
        cfg = ve.VaeExperimentConfig(family=label.split()[0], log_dir=f"{tmp}/vae", run_name=label.replace(" ", "_"),
                                     **kw)
        profiling.reset_counters()
        r = ve.run_vae_experiment(cfg)
        check(not any(launch_counts().values()), f"vae {label} launched kernels: {launch_counts()}")
        check(math.isfinite(r["final_loss"]), f"vae {label}: non-finite loss ({r})")
        if cfg.free_bits:
            # the anneal starts the KL weight at 0 and the free bits floor the
            # KL at free_bits * latent_dim, above the first chunk's loss
            floor = cfg.free_bits * cfg.latent_dim
            check(r["final_loss"] >= floor, f"vae {label}: final loss under the free-bits floor {floor} ({r})")
        else:
            check(r["final_loss"] < r["first_loss"], f"vae {label}: the loss did not fall ({r})")
        r["ms_per_step"] = 1e3 * r["wall_s"] / cfg.steps
        out[label] = r
        print(f"[21] vae {label} ({cfg.steps} steps, batch {cfg.batch_size}): {r['ms_per_step']:.3f} ms a step; "
              f"first loss {r['first_loss']:.6f}, final {r['final_loss']:.6f}", flush=True)

    worst = {}
    for family in ("mlp", "conv", "factorized"):
        cfg = ve.VaeExperimentConfig(family=family)
        model, gen = ve.build(cfg, "cpu", torch.Generator().manual_seed(5))
        init = model.state_dict()
        batch = gen(torch.Generator().manual_seed(6))
        g = torch.Generator().manual_seed(7)
        if family == "factorized":
            eps = [torch.randn(cfg.batch_size, n, generator=g)
                   for n in (cfg.shared_latent, cfg.private_latent, cfg.private_latent)]
        else:
            eps = torch.randn(cfg.batch_size, cfg.latent_dim, generator=g)
        res = {}
        for d in ("cpu", dev):
            m, _ = ve.build(cfg, d, torch.Generator(device=d).manual_seed(5))
            m.load_state_dict(init)
            step = make_vae_train_step(kl_weight=cfg.kl_weight, use_huber=cfg.use_huber)
            _, loss = step(create_vae_state(m, cfg.lr), _to(batch, d), None, _to(eps, d))
            res[d] = ([float(x) for x in loss], [p.grad.cpu() for p in m.parameters()],
                      [p.detach().cpu() for p in m.parameters()])
        (l_cpu, g_cpu, p_cpu), (l_dev, g_dev, p_dev) = res["cpu"], res[dev]
        worst[family] = {
            "loss_rel": max(abs(a - b) / max(abs(a), 1e-30) for a, b in zip(l_cpu, l_dev)),
            # each leaf's grad difference over its largest grad
            "grad_rel": max(float((a - b).abs().max() / a.abs().max().clamp(min=1e-30)) for a, b in zip(g_cpu, g_dev)),
            "param_abs": max(float((a - b).abs().max()) for a, b in zip(p_cpu, p_dev)),
        }
        tol = 2.0 ** -7 if family == "conv" else 1e-6  # conv computes in bf16
        check(worst[family]["loss_rel"] <= tol and worst[family]["grad_rel"] <= tol,
              f"vae {family}: one step differs between the card and the CPU: {worst[family]}")
    out["card_vs_cpu"] = worst
    print(f"[21] vae one step, card against CPU: {json.dumps(worst)}", flush=True)
    out["phase_wall_s"] = time.perf_counter() - t_phase
    return out


def _trace_kernel_counts(trace_dir: Path) -> dict:
    """Device kernels named like K1-K4 in the one torch.profiler trace
    under ``trace_dir`` (the Chrome trace's "kernel" events)."""
    files = list(trace_dir.glob("*.pt.trace.json"))
    check(len(files) == 1, f"expected one trace file under {trace_dir}, found {[f.name for f in files]}")
    events = json.loads(files[0].read_text())["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    check(bool(names), f"the trace {files[0].name} holds no device kernel events")
    return {counter: sum(kernel in n for n in names)
            for counter, kernel in KERNEL_COUNTERS.items()} | {"all_kernels": len(names)}


def tooling_phase(drive, both_routes, examples: Path, tmp: str, dev, smi: str) -> dict:
    """Phase 22: the tooling options of M20 at full width (simple_tag
    30/10/20, 40 agents, Σobs 5,660) with model.use_pallas=true.  Returns
    the phase's numbers and the launches of each path."""
    import collections
    import pickle

    import numpy as np
    import torch

    from mfvae_tpu_torch.config import ExperimentConfig, load_config
    from mfvae_tpu_torch.data.transitions import vae_batch_from_grouped
    from mfvae_tpu_torch.models import import_reference as ref
    from mfvae_tpu_torch.models.losses import LossOutputs, elbo_losses
    from mfvae_tpu_torch.models.mavae import MAVAE, GroupedBatch
    from mfvae_tpu_torch.ops import fused_elbo as ops
    from mfvae_tpu_torch.training.experiment import Experiment
    from mfvae_tpu_torch.training.multiseed import run_multiseed
    from mfvae_tpu_torch.training.trainer import create_train_state, make_train_step
    from mfvae_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    print(f"[22] card: {smi}", flush=True)
    out, launches = {}, {}
    want1 = {"k1.launches": 10, "k2.launches": 10, "k3.launches": 20, "k3w.launches": 0, "k4.launches": 40}

    def full_width(cfg):
        check((cfg.env.name, cfg.env.num_adversaries, cfg.env.num_good_agents, cfg.env.num_obs)
              == ("MPE_simple_tag_v3", 30, 10, 20), "phase 22 runs simple_tag 30/10/20")
        return cfg

    # ------------------------------------------------------------ multiseed
    parity = str(examples / "reference_parity.yaml")
    exp, single_wall, _ = drive(full_width(load_config(parity)), True, 2, f"{tmp}/ms_single", "22",
                                "multiseed: the single run at seed 0")
    check(sum(exp.spec.obs_dims) == 5660 and exp.spec.n_agents == 40, "reference_parity is not 40 agents, Σobs 5,660")
    single = exp.result
    del exp
    cfg = load_config(parity)
    cfg.model.use_pallas, cfg.train.epoch_num = True, 2
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    profiling.reset_counters()
    ms = run_multiseed(cfg, [0, 1, 2, 3], device=dev)
    torch.cuda.synchronize()
    launches["tooling: multiseed x4, 2 epochs"] = launch_counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    want = {k: 8 * v for k, v in want1.items()}
    print(f"[22] multiseed seeds {ms['seeds']}: loss_train {ms['loss_train']} loss_test {ms['loss_test']}")
    print(f"[22] multiseed launches {launches['tooling: multiseed x4, 2 epochs']} (expected {want})")
    check(launches["tooling: multiseed x4, 2 epochs"] == want, "multiseed: launch counts")
    for name in ("loss_train", "loss_test"):
        gap = abs(ms[name][0] - single[name]) / abs(single[name])
        print(f"[22] multiseed replica 0 {name} {ms[name][0]:.7f} vs the single run {single[name]:.7f}: rel gap {gap:.3e}")
        check(gap <= 1e-5, f"multiseed replica 0's {name} differs from the single run beyond rtol 1e-5")
    check(len(set(ms["loss_train"])) == 4, "multiseed: two replicas gave the same loss_train")
    out["multiseed_epoch_wall_ms"] = [1e3 * w for w in ms["epoch_wall_s"]]
    out["single_epoch_wall_ms"] = single_wall
    out["multiseed_peak_gib"] = peak
    print(f"[22] multiseed x4 lockstep epoch wall ms {[round(w, 3) for w in out['multiseed_epoch_wall_ms']]}")
    print(f"[22] multiseed x4 per replica-epoch ms {[round(w / 4, 3) for w in out['multiseed_epoch_wall_ms']]}")
    print(f"[22] single run epoch wall ms {single_wall}")
    print(f"[22] multiseed x4 peak device memory above the phase's baseline: {peak:.3f} GiB")

    # -------------------------------------------------------- profile_epochs
    cfg = full_width(load_config(parity, ["train.profile_epochs=1"]))
    exp, wall, launches["tooling: profile_epochs=1, 3 epochs"] = drive(cfg, True, 3, f"{tmp}/profile", "22",
                                                                        "profile_epochs=1")
    counts = _trace_kernel_counts(exp.logger.run_dir / "profile")
    per_epoch = {k: v // 3 for k, v in launches["tooling: profile_epochs=1, 3 epochs"].items()}
    print(f"[22] profile_epochs=1: device kernels in the trace of epoch 1 {counts}; counters per epoch {per_epoch}")
    check({k: counts[k] for k in want1} == want1 == per_epoch,
          "profile_epochs: the trace's K1-K3 kernels differ from the launch counters of the traced epoch")
    out["profile_traced_epoch_ms"], out["profile_untraced_epoch_ms"] = wall[1], wall[2]
    print(f"[22] profile_epochs=1: traced epoch wall {wall[1]:.3f} ms, untraced epoch {wall[2]:.3f} ms")
    del exp

    # ------------------------------------------------------------ debug_nans
    cfg = full_width(load_config(parity, ["train.debug_nans=true"]))
    exp, wall, launches["tooling: debug_nans, 1 epoch"] = drive(cfg, True, 1, f"{tmp}/nans", "22", "debug_nans")
    out["debug_nans_epoch_ms"] = wall[0]
    print(f"[22] debug_nans: epoch wall {wall[0]:.3f} ms with the guard, {single_wall[1]:.3f} ms without "
          f"(the single run's second epoch)")
    model = exp.carry.train_state.model
    with torch.no_grad():
        model.encoders[0].fc0.kernel[0, 0] = float("nan")
    try:
        exp.run()
        fail("debug_nans: a NaN encoder weight raised nothing")
    except FloatingPointError as e:
        print(f"[22] debug_nans: the poisoned encoder weight raised FloatingPointError: {e}")
        check("encoders.0.fc0" in str(e), "debug_nans: the error does not name the poisoned module")
    check(not torch.is_anomaly_enabled() and ops._NAN_CHECK is None, "debug_nans: the guard outlived the run")
    del exp, model

    # ----------------------------------------------------------------- remat
    fused_cfg = load_config(parity, ["model.compute_dtype=float32"])
    fused_cfg.train.log_dir, fused_cfg.train.checkpoint_dir = f"{tmp}/remat/results", ""
    exp = Experiment(fused_cfg, dev).build()
    exp.run_epoch()  # a real buffer to draw the batch from
    batch = vae_batch_from_grouped(exp.spec, exp.buffer.sample(
        exp.carry.buffer_state, torch.Generator(device=dev).manual_seed(1)).experience)
    profiling.reset_counters()
    for fused in (True, False):
        mcfg = copy.deepcopy(fused_cfg.model)
        mcfg.fused_decoders = fused
        models = {}
        for remat in (False, True):
            mcfg.remat = remat
            models[remat] = MAVAE.from_config(mcfg, exp.spec, device=dev)
        models[True].load_state_dict(models[False].state_dict())
        grads, peaks = {}, {}
        for remat, model in models.items():
            state = create_train_state(model, fused_cfg.train)
            step = make_train_step(fused_cfg.loss, use_pallas=True)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            step(state, batch, torch.Generator(device=dev).manual_seed(2))
            torch.cuda.synchronize()
            peaks[remat] = (torch.cuda.max_memory_allocated() - base) / 2**20
            grads[remat] = {n: p.grad.clone() for n, p in model.named_parameters()}
        worst = max(float(((grads[True][n] - g).abs() / g.abs().max().clamp_min(1e-30)).max())
                    for n, g in grads[False].items())
        ok = all(torch.allclose(grads[True][n], g, rtol=1e-5, atol=1e-5 * float(g.abs().max()))
                 for n, g in grads[False].items())
        label = "fused" if fused else "unfused"
        out[f"remat_{label}_peak_mib"] = peaks[True]
        out[f"plain_{label}_peak_mib"] = peaks[False]
        print(f"[22] remat, {label} decoders, float32: grads vs without remat, largest gap over the leaf's "
              f"largest {worst:.3e} (rtol 1e-5)")
        print(f"[22] remat, {label} decoders: one train step's peak device memory above its start "
              f"{peaks[True]:.3f} MiB with remat, {peaks[False]:.3f} MiB without")
        check(ok, f"remat changed the gradients of one train step ({label} decoders)")
    launches["tooling: remat, 4 train steps"] = launch_counts()
    # the models' own model.use_pallas is off (the recipe's default): no K4
    check(launches["tooling: remat, 4 train steps"] == {k: 4 * v // 10 for k, v in want1.items()} | {"k4.launches": 0},
          "remat: the 4 train steps with use_pallas did not launch K1-K3 4/4/8 times and K4 none")
    del exp, models, batch

    # ---------------------------------------------------- rng_mode=reference
    cfg = full_width(load_config(parity, ["model.rng_mode=reference"]))
    exp, _, launches["tooling: rng_mode=reference, 1 epoch"] = drive(cfg, True, 1, f"{tmp}/rng_ref", "22",
                                                                     "rng_mode=reference")
    both_routes(exp, "22", "rng_mode=reference")
    del exp

    # ------------------------------------------------------------- bug_compat
    cfg = load_config(str(examples / "bug_compat_replication.yaml"))
    check(cfg.train.bug_compat_rng, "bug_compat_replication.yaml does not set train.bug_compat_rng")
    exp, _, launches["tooling: bug_compat_replication, 2 epochs"] = drive(
        full_width(cfg), True, 2, f"{tmp}/bug_compat", "22", "bug_compat_replication")
    s = cfg.train.sample_num
    same = all(torch.equal(a[:s], a[s : 2 * s]) for a in exp.carry.buffer_state.data.actions)
    differ = any(not torch.equal(a[:s], a[s : 2 * s]) for a in exp.carry.buffer_state.data.next_obs)
    print(f"[22] bug_compat: the actions stored in epochs 0 and 1 equal: {same}; their next_obs differ: {differ}")
    check(same, "bug_compat: epochs 0 and 1 collected different actions")
    # the last test phase again: the eval stream starts every epoch from
    # the snapshot and is drawn only in the test phase
    exp.streams.rewind()
    eval_g = exp.streams["eval"]
    tn, n_test = cfg.train.train_num, cfg.train.test_num
    state = exp.carry.train_state
    with torch.no_grad():
        batch = vae_batch_from_grouped(exp.spec, exp.test_buffer.sample(
            exp.carry.test_buffer_state, eval_g, batch_size=n_test * cfg.buffer.batch_size).experience)
        recon_s, recon_r, mu, logvar = state.model(batch.inputs, None, eval_g)
        per_batch = [elbo_losses(*chunk, cfg.loss) for chunk in zip(*(
            x.chunk(n_test) for x in (recon_s, recon_r, batch.next_state, batch.rewards, mu, logvar)))]
    summed = LossOutputs(*(float(sum(xs)) / tn for xs in zip(*per_batch)))
    got = exp.result["loss_test"]
    print(f"[22] bug_compat: loss_test {got:.7f}; the sum of the {n_test} eval batches' losses over "
          f"train_num {tn}: {summed.loss:.7f} (rel {abs(got - summed.loss) / abs(summed.loss):.3e})")
    check(abs(got - summed.loss) <= 1e-5 * abs(summed.loss), "bug_compat: loss_test is not the sum over train_num")
    del exp, state, batch, recon_s, recon_r, mu, logvar

    # ---------------------------------------------------------- import/export
    rng = np.random.default_rng(22)
    mcfg = ExperimentConfig().model
    mcfg.fused_decoders, mcfg.compute_dtype = False, "float32"
    spec = Experiment(load_config(parity), dev).spec
    n, f, af = spec.n_agents, mcfg.obs_features, mcfg.action_features

    def dense(n_in, n_out):
        return {"kernel": (rng.standard_normal((n_in, n_out), np.float32) / np.sqrt(n_in)),
                "bias": rng.standard_normal(n_out, np.float32)}

    tree = {"idx_emb": {"embedding": rng.standard_normal((n, mcfg.idx_features), np.float32)},
            "reward_linear": dense(n, n)}
    for a, od, ad in zip(spec.agents, spec.obs_dims, spec.act_dims):
        w = [mcfg.idx_features + od, *mcfg.encoder_hidden]
        tree[f"encoders_{a}"] = {f"fc{i}": dense(w[i], w[i + 1]) for i in range(len(w) - 1)}
        tree[f"encoders_{a}"]["Dense_0"] = dense(w[-1], 2 * f)
        tree[f"action_encoders_{a}"] = {"embedding": rng.standard_normal((ad, af), np.float32)}
    for dec, width in (("state_decoder", sum(spec.obs_dims)), ("reward_decoder", n)):
        w = [n * (f + af), *mcfg.decoder_hidden, width]
        tree[dec] = {f"Dense_{i}": dense(w[i], w[i + 1]) for i in range(len(w) - 1)}
    imported = ref.import_reference_params(tree, spec)
    card = MAVAE.from_config(mcfg, spec, device=dev)
    card.load_state_dict(imported)
    cpu = MAVAE.from_config(mcfg, spec, device="cpu")
    cpu.load_state_dict(imported)
    b = 128
    obs = [rng.standard_normal((b, len(i), od), np.float32) for (od, _), i in spec.groups]
    act = [rng.integers(0, ad, (b, len(i))).astype(np.int32) for (_, ad), i in spec.groups]
    with torch.no_grad():
        on_card = card.mean_call(GroupedBatch(tuple(torch.from_numpy(x).to(dev) for x in obs),
                                              tuple(torch.from_numpy(x).to(dev) for x in act)))
        on_cpu = cpu.mean_call(GroupedBatch(tuple(map(torch.from_numpy, obs)), tuple(map(torch.from_numpy, act))))
    for name, x, y in zip(("recon_state", "recon_reward"), on_card, on_cpu):
        rel = float((x.cpu() - y).abs().max() / y.abs().max())
        print(f"[22] import: a reference-structure tree at full width ({sum(v.numel() for v in imported.values()):,} "
              f"params), mean_call {name} {tuple(x.shape)} on the card vs the CPU: max gap over the largest {rel:.3e}")
        check(rel <= 1e-5 and bool(torch.isfinite(x).all()), f"import: the card's {name} differs from the CPU's")
    back = ref.import_reference_params(ref.export_reference_params(card, spec), spec)
    sd = card.state_dict()
    check(set(back) == set(sd) and all(torch.equal(back[k], sd[k].cpu()) for k in sd),
          "export -> import is not bit-equal")
    path = f"{tmp}/model_state.pkl"
    ref.save_reference_pickle(card, spec, path)
    loaded = ref.load_reference_pickle(path, spec)
    check(all(torch.equal(loaded[k], sd[k].cpu()) for k in sd), "the numpy pickle round trip is not bit-equal")
    print("[22] import: export -> import and the numpy pickle round trip bit-equal")
    with open(f"{tmp}/refused.pkl", "wb") as fh:
        pickle.dump({"idx_emb": {"embedding": collections.OrderedDict(a=1)}}, fh)
    try:
        ref.load_reference_pickle(f"{tmp}/refused.pkl", spec)
        fail("a pickle of a non-numpy class was loaded")
    except ValueError as e:
        print(f"[22] import: a pickle of a non-numpy class refused: {e}")
    del card, cpu

    for path_name, n_launch in launches.items():
        print(f"[22] launches, {path_name}: {n_launch}")
    for path_name in ("tooling: debug_nans, 1 epoch", "tooling: rng_mode=reference, 1 epoch"):
        check(launches[path_name] == want1, f"{path_name}: launches {launches[path_name]}, expected {want1}")
    out["launches"] = launches
    out["phase_wall_s"] = time.perf_counter() - t_phase
    print(f"[22] phase wall {out['phase_wall_s']:.1f} s", flush=True)
    return out


# ----------------------------------------------------------------- 24. scale-out
SCALEOUT_TIMEOUT_S = 600  # the two ranks of phase 24 together, and each collective


def _record_train_steps(sink: list):
    """Wrap ``trainer.make_train_step`` so every train step's loss lands in
    ``sink``; returns the function that undoes it."""
    from mfvae_tpu_torch.training import trainer

    orig = trainer.make_train_step

    def make(*a, **k):
        step = orig(*a, **k)

        def recorded(state, batch, *r, **kw):
            state, o = step(state, batch, *r, **kw)
            sink.append(o.loss)
            return state, o

        return recorded

    trainer.make_train_step = make
    return lambda: setattr(trainer, "make_train_step", orig)


def _dp_config(examples: Path, tmp: str, epochs: int, **over):
    """examples/data_parallel.yaml with the kernels, at full width."""
    from mfvae_tpu_torch.config import load_config

    cfg = load_config(str(examples / "data_parallel.yaml"))
    check((cfg.env.name, cfg.env.num_adversaries, cfg.env.num_good_agents, cfg.env.num_obs,
           cfg.train.n_envs, cfg.buffer.batch_size) == ("MPE_simple_tag_v3", 30, 10, 20, 8, 4096),
          "phase 24 runs data_parallel.yaml: simple_tag 30/10/20, 8 envs, batch 4,096")
    cfg.model.use_pallas = True
    cfg.train.epoch_num = epochs
    cfg.train.log_dir, cfg.train.checkpoint_dir = f"{tmp}/results", ""
    for key, value in over.items():
        section, name = key.split("__")
        setattr(getattr(cfg, section), name, value)
    return cfg


def _fixed_step(exp) -> dict:
    """One float32 train step from the state after setup on a batch and eps
    drawn from seed 11 on the card (grad_clip 0): the loss and the whole
    gradients on the CPU (split parameters gathered over 'model')."""
    import torch

    from mfvae_tpu_torch.data.transitions import VaeBatch
    from mfvae_tpu_torch.models.mavae import GroupedBatch
    from mfvae_tpu_torch.parallel import tp
    from mfvae_tpu_torch.training.trainer import make_train_step

    cfg, spec, dev = exp.cfg, exp.spec, exp.device
    g = torch.Generator(device=dev).manual_seed(11)
    b = cfg.buffer.batch_size
    inputs = GroupedBatch(
        obs=tuple(torch.randn(b, len(i), od, generator=g, device=dev) for (od, _), i in spec.groups),
        actions=tuple(torch.randint(0, 5, (b, len(i)), generator=g, device=dev, dtype=torch.int32)
                      for _, i in spec.groups),
    )
    batch = VaeBatch(inputs=inputs, next_state=torch.randn(b, sum(spec.obs_dims), generator=g, device=dev),
                     rewards=torch.randn(b, spec.n_agents, generator=g, device=dev))
    eps = torch.randn(b, spec.n_agents, cfg.model.obs_features, generator=g, device=dev)
    state = exp.carry.train_state
    state.grad_clip = 0.0
    _, o = make_train_step(cfg.loss, cfg.train.mode, use_pallas=cfg.model.use_pallas, mesh=exp.mesh)(
        state, batch, None, eps)
    dims = tp.split_dims(state.model)
    grads = {n: (p.grad if d is None else exp.mesh.all_gather(p.grad, "model", d)).cpu()
             for (n, p), d in zip(state.model.named_parameters(), dims)}
    return {"loss": float(o.loss), "grads": grads}


def _digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _pp_check(mesh, dev) -> dict:
    """simple_tag 30/10/20 with unfused decoders of a uniform 1,024-wide
    body (fc0, fc1-fc4 over the 2 stages, out), float32: the loss and every
    gradient of the model with both decoders through ``pipelined_mlp``
    (4 microbatches) against the unpipelined forward on the same eps."""
    import torch

    from mfvae_tpu_torch.config import LossConfig, ModelConfig
    from mfvae_tpu_torch.envs.mpe import make
    from mfvae_tpu_torch.models.losses import elbo_losses
    from mfvae_tpu_torch.models.mavae import MAVAE, GroupedBatch
    from mfvae_tpu_torch.parallel.pp import pipelined_mlp
    from mfvae_tpu_torch.training.experiment import build_spec

    spec = build_spec(make("MPE_simple_tag_v3", device=dev, num_good_agents=10, num_adversaries=30, num_obs=20))
    mc = ModelConfig(compute_dtype="float32", fused_decoders=False, decoder_hidden=(1024,) * 5)
    model = MAVAE.from_config(mc, spec, device=dev, generator=torch.Generator(device=dev).manual_seed(3))
    g = torch.Generator(device=dev).manual_seed(4)
    b = 256
    batch = GroupedBatch(
        obs=tuple(torch.randn(b, len(i), od, generator=g, device=dev) for (od, _), i in spec.groups),
        actions=tuple(torch.randint(0, 5, (b, len(i)), generator=g, device=dev) for _, i in spec.groups))
    nxt = torch.randn(b, sum(spec.obs_dims), generator=g, device=dev)
    rew = torch.randn(b, spec.n_agents, generator=g, device=dev)
    eps = torch.randn(b, spec.n_agents, mc.obs_features, generator=g, device=dev)

    def layers(mlp):
        names = [f"fc{i}" for i in range(mlp.n_hidden)] + ["out"]
        return {n: {"kernel": getattr(mlp, n).kernel, "bias": getattr(mlp, n).bias} for n in names}

    def piped():
        mu, lv, aemb, _, _ = model.encode(batch)
        z = model.reparameterize(mu, lv, eps)
        mu, lv, aemb, z = model._to_agent_order(mu, lv, aemb, z)
        flat = torch.cat([z.reshape(b, -1), aemb.reshape(b, -1)], dim=-1)
        rs = pipelined_mlp(layers(model.state_decoder), flat, mesh, 4)
        rr = model.reward_linear(pipelined_mlp(layers(model.reward_decoder), flat, mesh, 4))
        return rs, rr, mu.reshape(b, -1), lv.reshape(b, -1)

    out = {}
    for name, fwd in (("pipelined", piped), ("unpipelined", lambda: model(batch, eps=eps))):
        model.zero_grad(set_to_none=True)
        rs, rr, mu, lv = fwd()
        loss = elbo_losses(rs, rr, nxt, rew, mu, lv, LossConfig()).loss
        loss.backward()
        out[name] = (loss.item(), {n: p.grad.detach().clone() for n, p in model.named_parameters()})
    (lp, gp), (lu, gu) = out["pipelined"], out["unpipelined"]
    err = max(float((gp[n] - gu[n]).abs().max()) for n in gu)
    return {"loss": lp, "loss_unpipelined": lu, "loss_err": abs(lp - lu), "grad_max_abs_err": err,
            "params": sum(p.numel() for p in model.parameters())}


def _scaleout_rank(rank: int, port: int, out_dir: str, examples: str) -> None:
    """One of phase 24's two ranks sharing the card over gloo: the
    data-parallel epoch, the tensor-parallel step and epoch, the pipeline.
    Writes its numbers to ``out_dir/rank<r>.json`` (rank 0 also its whole
    float32 gradients); any failure exits non-zero."""
    import torch
    import torch.distributed as dist

    from mfvae_tpu_torch.parallel.mesh import init_distributed
    from mfvae_tpu_torch.parallel.pp import make_pipe_mesh
    from mfvae_tpu_torch.training.experiment import Experiment
    from mfvae_tpu_torch.utils import profiling

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    examples = Path(examples)
    init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo", timeout_s=SCALEOUT_TIMEOUT_S)
    res = {"device": str(torch.device("cuda", torch.cuda.current_device()))}
    staged = set()
    try:
        # data parallel: 4 envs a rank, the kernels on each rank's rows
        steps = []
        undo = _record_train_steps(steps)
        exp = Experiment(_dp_config(examples, f"{out_dir}/dp{rank}", 1, mesh__data_axis=2)).setup()
        undo()
        check(exp.mesh.shape == {"data": 2, "model": 1} and exp.carry.env.obs[0].shape[0] == 4,
              f"rank {rank}: mesh {exp.mesh.shape}, {exp.carry.env.obs[0].shape[0]} envs")
        torch.cuda.reset_peak_memory_stats()
        profiling.reset_counters()
        r = exp.run()
        torch.cuda.synchronize()
        res["dp"] = {"launches": launch_counts(), "loss_train": r["loss_train"], "loss_test": r["loss_test"],
                     "steps": [float(x) for x in steps], "epoch_wall_ms": [1e3 * s for s in r["epoch_wall_s"]],
                     "params_sha256": _digest(exp.carry.train_state.model.parameters()),
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        staged |= exp.mesh.staged
        del exp
        torch.cuda.empty_cache()

        # tensor parallel: one float32 step, then a bf16 epoch with the kernels
        exp = Experiment(_dp_config(examples, f"{out_dir}/tp{rank}", 1, model__compute_dtype="float32",
                                    mesh__model_axis=2)).setup()
        check(exp.mesh.shape == {"data": 1, "model": 2}, f"rank {rank}: mesh {exp.mesh.shape}")
        step = _fixed_step(exp)
        res["tp_step"] = {"loss": step["loss"], "grads_sha256": _digest(step["grads"][n] for n in sorted(step["grads"])),
                          "split": sum(d is not None for d in exp.carry.train_state.model.tp_dims.values())}
        if rank == 0:
            torch.save(step["grads"], f"{out_dir}/tp_grads.pt")
        staged |= exp.mesh.staged
        del exp, step
        torch.cuda.empty_cache()
        exp = Experiment(_dp_config(examples, f"{out_dir}/tpe{rank}", 1, mesh__model_axis=2)).setup()
        torch.cuda.reset_peak_memory_stats()
        profiling.reset_counters()
        r = exp.run()
        torch.cuda.synchronize()
        res["tp"] = {"launches": launch_counts(), "loss_train": r["loss_train"], "loss_test": r["loss_test"],
                     "epoch_wall_ms": [1e3 * s for s in r["epoch_wall_s"]],
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        staged |= exp.mesh.staged
        del exp
        torch.cuda.empty_cache()

        # the pipeline: 2 stages
        mesh = make_pipe_mesh(2)
        res["pp"] = _pp_check(mesh, torch.device("cuda"))
        staged |= mesh.staged
        res["staged"] = sorted(staged)
    finally:
        dist.destroy_process_group()
    with open(f"{out_dir}/rank{rank}.json", "w") as f:
        json.dump(res, f)


def scaleout_phase(examples: Path, tmp: str, dev, smi: str) -> dict:
    """Phase 24: scale-out at full width (simple_tag 30/10/20, 40 agents).
    (a) examples/data_parallel.yaml through Experiment at world size 1 over
    NCCL, against the same config with mesh.enable=false; (b) two ranks
    sharing the card over gloo, spawned here.  Returns the phase's numbers
    and the launches of each path."""
    import gc
    import multiprocessing
    import socket

    import torch
    import torch.distributed as dist

    from mfvae_tpu_torch.parallel.mesh import init_distributed
    from mfvae_tpu_torch.training.experiment import Experiment
    from mfvae_tpu_torch.utils import profiling

    def free_port() -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    def epoch_losses(exp) -> list:
        rows = [json.loads(line) for line in open(exp.logger.run_dir / "metrics.jsonl")]
        return [[r["value"] for r in rows if r["tag"] == tag] for tag in ("Loss/Train", "Loss/Test")]

    t_phase = time.perf_counter()
    print(f"[24] card: {smi}", flush=True)
    out, launches = {}, {}
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()

    # (a) world size 1 over NCCL, then the same config unsharded
    runs = {}
    for enable in (True, False):
        if enable:
            init_distributed(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl", timeout_s=SCALEOUT_TIMEOUT_S)
        steps = []
        undo = _record_train_steps(steps)
        cfg = _dp_config(examples, f"{tmp}/dp1_{enable}", 2, mesh__enable=enable)
        exp = Experiment(cfg).setup()
        undo()
        check((exp.mesh is not None) == enable, f"mesh.enable={enable}: mesh {exp.mesh}")
        torch.cuda.reset_peak_memory_stats()
        profiling.reset_counters()
        r = exp.run()
        torch.cuda.synchronize()
        name = "world 1 (NCCL)" if enable else "unsharded"
        runs[name] = {
            "launches": launch_counts(), "losses": epoch_losses(exp), "steps": [float(x) for x in steps],
            "epoch_wall_ms": [round(1e3 * s, 3) for s in r["epoch_wall_s"]],
            "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
        }
        if enable:
            check(dist.get_backend() == "nccl" and dist.get_world_size() == 1, "world 1 is not an NCCL group")
            dist.destroy_process_group()
        print(f"[24] data_parallel.yaml, {name}, 2 epochs: losses {runs[name]['losses']} "
              f"epoch wall ms {runs[name]['epoch_wall_ms']} launches {runs[name]['launches']} "
              f"peak above the phase's start {runs[name]['peak_gib']:.3f} GiB", flush=True)
        del exp
        gc.collect()
        torch.cuda.empty_cache()
    w1, plain = runs["world 1 (NCCL)"], runs["unsharded"]
    want2 = {"k1.launches": 20, "k2.launches": 20, "k3.launches": 40, "k3w.launches": 0, "k4.launches": 80}
    check(w1["launches"] == want2 and plain["launches"] == want2,
          f"data_parallel.yaml launches {w1['launches']}, {plain['launches']}, expected {want2}")
    check(w1["losses"] == plain["losses"] and w1["steps"] == plain["steps"],
          "world 1 over NCCL is not bit-equal to the unsharded batched run")
    launches["data_parallel world 1 (NCCL)"] = w1["launches"]
    out["world1"] = runs

    # the reference of the tensor-parallel float32 step
    exp = Experiment(_dp_config(examples, f"{tmp}/ref_step", 1, model__compute_dtype="float32",
                                mesh__enable=False)).setup()
    ref_step = _fixed_step(exp)
    del exp
    gc.collect()
    torch.cuda.empty_cache()

    # (b) two ranks on the card over gloo, each in its own process
    ctx = multiprocessing.get_context("spawn")
    rank_dir = f"{tmp}/ranks"
    Path(rank_dir).mkdir()
    port = free_port()
    t_ranks = time.perf_counter()
    procs = [ctx.Process(target=_scaleout_rank, args=(r, port, rank_dir, str(examples))) for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SCALEOUT_TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    check(not hung, f"phase 24: ranks {hung} did not finish within {SCALEOUT_TIMEOUT_S} s")
    check([p.exitcode for p in procs] == [0, 0], f"phase 24: rank exit codes {[p.exitcode for p in procs]}")
    ranks = [json.load(open(f"{rank_dir}/rank{r}.json")) for r in range(2)]
    out["ranks_wall_s"] = time.perf_counter() - t_ranks

    want1 = {"k1.launches": 10, "k2.launches": 10, "k3.launches": 20, "k3w.launches": 0, "k4.launches": 40}
    gaps = {}
    for r, res in enumerate(ranks):
        dp, tpe = res["dp"], res["tp"]
        check(dp["launches"] == want1 and tpe["launches"] == want1,
              f"rank {r}: launches dp {dp['launches']} tp {tpe['launches']}, expected {want1} each")
        launches[f"data_parallel 2 ranks (gloo), rank {r}"] = dp["launches"]
        launches[f"tensor parallel 2 ranks (gloo), rank {r}"] = tpe["launches"]
        first = w1["losses"][0][0], w1["losses"][1][0]  # (a)'s first epoch: train, test
        gaps[f"dp rank {r}"] = {
            "first_step": abs(dp["steps"][0] - w1["steps"][0]) / abs(w1["steps"][0]),
            "loss_train": abs(dp["loss_train"] - first[0]) / abs(first[0]),
            "loss_test": abs(dp["loss_test"] - first[1]) / abs(first[1]),
        }
        gaps[f"tp rank {r}"] = {
            "loss_train": abs(tpe["loss_train"] - first[0]) / abs(first[0]),
            "loss_test": abs(tpe["loss_test"] - first[1]) / abs(first[1]),
            "step_loss_float32": abs(res["tp_step"]["loss"] - ref_step["loss"]) / abs(ref_step["loss"]),
        }
        print(f"[24] rank {r} on {res['device']}: dp {dp['loss_train']:.7f}/{dp['loss_test']:.7f} "
              f"epoch wall ms {dp['epoch_wall_ms']} peak {dp['peak_gib']:.3f} GiB; "
              f"tp {tpe['loss_train']:.7f}/{tpe['loss_test']:.7f} epoch wall ms {tpe['epoch_wall_ms']} "
              f"peak {tpe['peak_gib']:.3f} GiB; first train step gap to world 1 {gaps[f'dp rank {r}']['first_step']:.3e}",
              flush=True)
        for key, gap in gaps[f"dp rank {r}"].items():
            check(gap <= 2e-3, f"rank {r}: data-parallel {key} differs from world 1 by {gap:.3e} (rtol 2e-3)")
        for key in ("loss_train", "loss_test"):
            check(gaps[f"tp rank {r}"][key] <= 2e-3,
                  f"rank {r}: tensor-parallel {key} differs from world 1 by {gaps[f'tp rank {r}'][key]:.3e} (rtol 2e-3)")
        check(gaps[f"tp rank {r}"]["step_loss_float32"] <= 1e-5, f"rank {r}: the float32 TP step's loss beyond rtol 1e-5")
        pp = res["pp"]
        print(f"[24] rank {r} pipeline, 2 stages, 4 microbatches, {pp['params']:,} params: loss {pp['loss']:.7f} "
              f"unpipelined {pp['loss_unpipelined']:.7f} |loss err| {pp['loss_err']:.3e} "
              f"max |grad err| {pp['grad_max_abs_err']:.3e} (atol 1e-5)", flush=True)
        check(pp["loss_err"] <= 1e-5 and pp["grad_max_abs_err"] <= 1e-5, f"rank {r}: the pipeline beyond atol 1e-5")
    check(ranks[0]["dp"]["params_sha256"] == ranks[1]["dp"]["params_sha256"],
          "the data-parallel ranks' parameters differ after the epoch")
    check(ranks[0]["tp_step"]["grads_sha256"] == ranks[1]["tp_step"]["grads_sha256"],
          "the tensor-parallel ranks gathered different gradients")
    tp_grads = torch.load(f"{rank_dir}/tp_grads.pt")
    grad_err = 0.0
    for n, want in ref_step["grads"].items():
        scale = float(want.abs().max())
        err = float((tp_grads[n] - want).abs().max())
        grad_err = max(grad_err, err / max(scale, 1e-30))
        check(torch.allclose(tp_grads[n], want, rtol=1e-5, atol=1e-5 * scale),
              f"tensor-parallel gradient {n} beyond rtol 1e-5 (atol 1e-5 of its largest): {err:.3e} of {scale:.3e}")
    print(f"[24] tensor-parallel float32 step ({ranks[0]['tp_step']['split']} split parameters): loss gap "
          f"{gaps['tp rank 0']['step_loss_float32']:.3e}, largest gradient gap over its leaf's largest "
          f"{grad_err:.3e} (rtol 1e-5)")
    staged = sorted(set(ranks[0]["staged"]) | set(ranks[1]["staged"]))
    print(f"[24] collectives staged through pinned host memory (gloo refuses CUDA tensors for them): {staged}; "
          f"all_reduce and broadcast ran on the card's tensors")
    out.update(gaps=gaps, tp_grad_gap=grad_err, staged=staged, ranks=ranks)
    for r in ranks:
        r.pop("pp", None)
    out["phase_wall_s"] = time.perf_counter() - t_phase
    out["launches"] = launches
    print(f"[24] the ranks' wall {out['ranks_wall_s']:.1f} s; phase wall {out['phase_wall_s']:.1f} s", flush=True)
    return out


# ------------------------------------------------- 25. the reference's dicts
REFERENCE_STEPS = 3  # Adam steps by each route in phase 25
BF16_RTOL = 2.0 ** -7  # the model's standing bfloat16 tolerance (tests/test_torch_model.py)


def reference_dicts_phase(dev) -> dict:
    """Phase 25: the reference-style path at full width (the default
    config: simple_tag 30/10/20, batch 128, bf16, use_pallas=true).  The
    port's TransitionBuffer filled from the card's env, create_dataset's
    dicts into the model.  Returns the phase's numbers and its launches."""
    import torch

    from mfvae_tpu_torch.config import ExperimentConfig
    from mfvae_tpu_torch.data.compat import TransitionBuffer
    from mfvae_tpu_torch.data.transitions import create_dataset
    from mfvae_tpu_torch.models.losses import combine_losses, elbo_losses
    from mfvae_tpu_torch.models.mavae import MAVAE, group_dict_batch
    from mfvae_tpu_torch.ops import fused_elbo as ops
    from mfvae_tpu_torch.training.experiment import Experiment
    from mfvae_tpu_torch.training.trainer import apply_update, create_train_state, make_action_sampler
    from mfvae_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    cfg = ExperimentConfig()
    cfg.model.use_pallas = True
    exp = Experiment(cfg, dev)  # the env, the spec and the codebook; no run
    env, spec, loss_cfg = exp.env, exp.spec, cfg.loss
    b = cfg.buffer.batch_size
    check((cfg.env.name, cfg.env.num_adversaries, cfg.env.num_good_agents, cfg.env.num_obs, b,
           cfg.model.compute_dtype, spec.n_agents, sum(spec.obs_dims))
          == ("MPE_simple_tag_v3", 30, 10, 20, 128, "bfloat16", 40, 5660),
          "phase 25 runs the default config: simple_tag 30/10/20, batch 128, bf16, 40 agents, Σobs 5,660")
    out = {}
    profiling.reset_counters()

    # the reference's buffer, filled from the card's env with random actions
    g = torch.Generator(device=dev).manual_seed(25)
    sample_actions, _ = make_action_sampler(env, spec)
    buf = TransitionBuffer(max_length=4 * b, min_length=b, batch_size=b)
    obs, state = env.reset(g)
    t0 = time.perf_counter()
    for t in range(b + 32):
        acts = sample_actions(g)
        act = {a: acts[i] for i, a in enumerate(env.agents)}
        nobs, state, rew, done, _ = env.step(state, act)
        (buf.add_trans if t else buf.init_buffer)(obs, rew, act, nobs, done)
        obs = nobs
    torch.cuda.synchronize()
    out["fill_s"] = time.perf_counter() - t0
    check(buf.can_sample() is True, "the TransitionBuffer cannot sample after its fill")
    rows = [buf.sample(g).experience for _ in range(REFERENCE_STEPS)]
    data = [create_dataset(r, exp.codebook) for r in rows]
    idx_state, actions, rewards, next_states = data[0]
    check(idx_state[env.agents[0]].device.type == "cuda", "create_dataset's dicts are not on the card")

    init = MAVAE.from_config(cfg.model, spec, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    init_sd = {k: v.detach().clone() for k, v in init.state_dict().items()}

    def fresh(device=dev):
        model = MAVAE.from_config(cfg.model, spec, device=device)
        model.load_state_dict(init_sd)
        return model

    # (a) the dict call against the grouped call on group_dict_batch's ids
    with torch.no_grad():
        out_d = init(idx_state, actions, torch.Generator(device=dev).manual_seed(1))
        out_g = init(*group_dict_batch(spec, idx_state, actions), torch.Generator(device=dev).manual_seed(1))
    check(all(torch.equal(x, y) for x, y in zip(out_d, out_g)),
          "the dict call differs from the grouped call on group_dict_batch's ids")
    check(tuple(out_d[0].shape) == (b, 5660) and tuple(out_d[1].shape) == (b, 40)
          and tuple(out_d[2].shape) == (b, 40 * cfg.model.obs_features)
          and all(bool(torch.isfinite(x).all()) for x in out_d), "the dict call's outputs: shapes or values")
    print(f"[25] TransitionBuffer filled with {b + 32} card env steps in {out['fill_s']:.2f} s; "
          f"model(idx_state, actions, g) bit-equal to model(*group_dict_batch(...), g)", flush=True)

    # (b) Adam steps by the kernel route (fused_call on the dicts' ids, K3);
    # before each, the plain route's step from a copy of the same state and
    # generator state.  Held per step, as the main path's routes are: two
    # trajectories drift apart, since Adam's first updates are about
    # lr * sign(g), and a gradient near 0 takes either sign by route (a
    # 3-step trajectory's s_loss reached 9.3e-5 on the card)
    def step(state, d, gen, use_pallas: bool):
        idx, act, rew, nxt = d
        if use_pallas:
            rs, rr, kl_rows = state.model.fused_call(*group_dict_batch(spec, idx, act), gen)
            o = combine_losses(ops.huber_mean(nxt, rs, loss_cfg.huber_delta),
                               ops.huber_mean(rew, rr, loss_cfg.huber_delta),
                               torch.mean(torch.sum(kl_rows, dim=1)), loss_cfg)
        else:
            rs, rr, mu, lv = state.model(idx, act, gen)
            o = elbo_losses(rs, rr, nxt, rew, mu, lv, loss_cfg)
        apply_update(state, o.loss)
        return [float(x.detach()) for x in o]

    losses = {False: [], True: []}
    state = create_train_state(fresh(), cfg.train)
    gen = torch.Generator(device=dev).manual_seed(2)
    for d in data:
        twin, twin_gen = copy.deepcopy(state), torch.Generator(device=dev)
        twin_gen.set_state(gen.get_state())
        losses[False].append(step(twin, d, twin_gen, False))
        losses[True].append(step(state, d, gen, True))
    del twin
    gap = max(abs(p - q) / abs(p) for sp, sq in zip(losses[False], losses[True]) for p, q in zip(sp, sq))
    out["adam_losses"] = {"plain": losses[False], "kernels": losses[True], "max_rel_gap": gap}
    print(f"[25] {REFERENCE_STEPS} Adam steps on the dicts, each by both routes from one state, loss by step: plain "
          f"{[round(s[0], 7) for s in losses[False]]} kernels {[round(s[0], 7) for s in losses[True]]}; "
          f"largest relative gap over loss, s_loss, r_loss, kl_loss {gap:.3e} (rtol 1e-4)", flush=True)
    check(gap <= 1e-4, f"the dict path's kernel and plain routes differ by {gap:.3e} (rtol 1e-4)")

    # (c) a permuted codebook: the ids read from the data differ from the
    # positions; the kernel route's forward on the card against the CPU's
    n = spec.n_agents
    permuted = {a: n - 1 - i for i, a in enumerate(env.agents)}
    idx_p, act_p, rew_p, nxt_p = create_dataset(rows[0], permuted)
    batch_p, ids_p = group_dict_batch(spec, idx_p, act_p)
    want_ids = [[n - 1 - i for i in idxs] for _, idxs in spec.groups]
    check([i[0].tolist() for i in ids_p] == want_ids, "group_dict_batch did not read the permuted ids")
    eps = torch.randn(b, n, cfg.model.obs_features, generator=torch.Generator().manual_seed(3))

    def forward(model, batch, ids, rew, nxt, device):
        with torch.no_grad():
            rs, rr, kl_rows = model.fused_call(_to(batch, device), _to(ids, device), eps=eps.to(device))
            o = combine_losses(ops.huber_mean(nxt.to(device), rs, loss_cfg.huber_delta),
                               ops.huber_mean(rew.to(device), rr, loss_cfg.huber_delta),
                               torch.mean(torch.sum(kl_rows, dim=1)), loss_cfg)
        return rs.float().cpu(), [float(x) for x in o]

    rs_card, l_card = forward(init, batch_p, ids_p, rew_p, nxt_p, dev)
    rs_cpu, l_cpu = forward(fresh("cpu"), batch_p, ids_p, rew_p, nxt_p, "cpu")
    batch_0, _ = group_dict_batch(spec, idx_state, actions)
    rs_pos, l_pos = forward(init, batch_0, None, rewards, next_states, dev)
    state_gap = float((rs_card - rs_cpu).abs().max()) / float(rs_cpu.abs().max())
    loss_gap = max(abs(p - q) / abs(q) for p, q in zip(l_card, l_cpu))
    moved = float((rs_card - rs_pos).abs().max()) / float(rs_pos.abs().max())
    out["permuted"] = {"card_vs_cpu_state_over_largest": state_gap, "card_vs_cpu_loss_rel": loss_gap,
                       "vs_positional_state_over_largest": moved, "loss_card": l_card, "loss_cpu": l_cpu,
                       "loss_positional": l_pos}
    print(f"[25] permuted codebook (agent i -> id {n - 1} - i): card vs CPU recon_state |diff| over its largest "
          f"{state_gap:.3e}, losses rel {loss_gap:.3e} (rtol 2^-7); against the positional ids the recon_state "
          f"moved {moved:.3e} of its largest", flush=True)
    check(state_gap <= BF16_RTOL and loss_gap <= BF16_RTOL,
          f"permuted ids: card and CPU differ beyond 2^-7 ({state_gap:.3e}, {loss_gap:.3e})")
    check(moved > BF16_RTOL, "permuted ids gave the positional result: the ids read from the data were not used")

    torch.cuda.synchronize()
    launches = launch_counts()
    # K4: the action embeddings' backward in both routes' steps (the model's
    # use_pallas); the ids come from the data, so the agent-index
    # embedding keeps the gather
    want = {"k1.launches": REFERENCE_STEPS + 2, "k2.launches": REFERENCE_STEPS,
            "k3.launches": 2 * REFERENCE_STEPS + 4, "k3w.launches": 0,
            "k4.launches": 2 * REFERENCE_STEPS * len(spec.groups)}
    print(f"[25] launches {launches} (the kernel route's {REFERENCE_STEPS} steps and 2 forwards; K4 in both "
          f"routes' steps)", flush=True)
    check(launches == want, f"phase 25: launch counts {launches}, expected {want}")
    out["launches"] = {"reference dicts: Adam steps + permuted ids": launches}
    out["phase_wall_s"] = time.perf_counter() - t_phase
    print(f"[25] phase wall {out['phase_wall_s']:.1f} s", flush=True)
    return out


# ------------------------------------------ 23. the unroll step by both routes
UNROLL_B = 256  # windows of phase 23's step
K3W_ROWS = 8 * 4096  # K3w's rows in the tag_unroll.train_w8 cell: W·B


def unroll_routes_phase(exp, dev, median_ms, bound) -> dict:
    """Phase 23 (the module docstring): one unroll step by each route from
    ``exp``'s trained state on windows of its ring, then K3w alone at the
    unroll cell's shapes.  Returns the phase's numbers."""
    import copy
    import dataclasses

    import torch

    from mfvae_tpu_torch.models.mavae import MAVAE
    from mfvae_tpu_torch.ops import fused_elbo as ops
    from mfvae_tpu_torch.training.trainer import create_train_state
    from mfvae_tpu_torch.training.unroll import make_unroll_loss_fn, make_unroll_train_step
    from mfvae_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    cfg, spec = exp.cfg, exp.spec
    w = cfg.train.unroll_steps
    check(w == 8 and cfg.model.det_features == 128 and not cfg.model.fused_decoders and cfg.train.grad_clip == 10.0,
          "phase 23 runs world_model_unroll.yaml: W 8, det 128, unfused decoders, clip 10")
    buffer = dataclasses.replace(exp.buffer, sample_batch_size=UNROLL_B)
    g = torch.Generator(device=dev).manual_seed(6)
    windows = buffer.sample_window(exp.carry.buffer_state, g, w, block=cfg.train.sample_num).experience
    done = windows.done.clone()
    done[::7, 2] = 1.0  # episode ends inside some windows, so the masks weigh
    windows = windows._replace(done=done)
    eps = torch.randn(w, UNROLL_B, spec.n_agents, cfg.model.obs_features, generator=g, device=dev)
    trained = exp.carry.train_state.model.state_dict()
    out = {"windows": UNROLL_B, "unroll_steps": w}
    k4 = k4_per_step(spec, cfg.model)
    for dtype in ("float32", "bfloat16"):
        res = {}
        for use_pallas in (False, True):
            # the plain route on a model without the layers' kernel (K4)
            model = MAVAE.from_config(dataclasses.replace(cfg.model, compute_dtype=dtype, use_pallas=use_pallas),
                                      spec, device=dev)
            model.load_state_dict(trained)
            opts = dict(use_pallas=use_pallas, stop_gradient=cfg.train.unroll_stop_gradient,
                        mean_feedback=cfg.train.unroll_mean_feedback)
            m = copy.deepcopy(model)
            o = make_unroll_loss_fn(spec, cfg.loss, w, **opts)(m, windows, eps=eps)
            o.loss.backward()
            grads = {n: p.grad for n, p in m.named_parameters()}
            step = make_unroll_train_step(spec, cfg.loss, w, **opts)
            state = create_train_state(copy.deepcopy(model), cfg.train)
            profiling.reset_counters()
            state, _ = step(state, windows, eps=eps)
            torch.cuda.synchronize()
            res[use_pallas] = ([float(x.detach()) for x in o], grads, profiling.counters())
            del m
            times = []
            for _ in range(5):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                step(state, windows, eps=eps)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            out[f"{dtype}_{'kernels' if use_pallas else 'plain'}_step_ms"] = statistics.median(times)
        (lp, pp, cp), (lk, pk, ck) = res[False], res[True]
        check(cp == {} and ck == {"k1.launches": w, "k2.launches": w, "k3w.launches": 2, "k4.launches": k4 * w},
              f"phase 23 {dtype}: launches plain {cp}, kernels {ck}")
        rel = [abs(a - b) / abs(a) for a, b in zip(lp, lk)]
        out[f"{dtype}_loss_rel_gaps"] = rel
        print(f"[23] {dtype}: losses plain {lp} kernels {lk} rel {['%.3e' % r for r in rel]}; "
              f"launches kernels {ck}; step ms plain {out[f'{dtype}_plain_step_ms']:.3f} "
              f"kernels {out[f'{dtype}_kernels_step_ms']:.3f}", flush=True)
        if dtype == "float32":
            check(max(rel) <= 1e-5, f"phase 23 float32: losses differ between the routes beyond rtol 1e-5: {rel}")
            worst = max(float(torch.linalg.vector_norm(pk[n] - g) / torch.linalg.vector_norm(g)) for n, g in pp.items())
            out["float32_worst_leaf_grad_gap"] = worst
            print(f"[23] float32: worst leaf's gradient gap {worst:.3e} of its norm", flush=True)
            check(worst <= 1e-5, f"phase 23 float32: a leaf's gradient differs beyond 1e-5 of its norm ({worst:.3e})")
        else:
            check(max(rel) <= 1e-4, f"phase 23 bfloat16: losses differ between the routes beyond rtol 1e-4: {rel}")
    # K3w at the cell's shapes, f32, against its plain version, then timed
    k3w = {}
    for name, d in (("state", sum(spec.obs_dims)), ("reward", spec.n_agents)):
        gx = torch.Generator(device=dev).manual_seed(7)
        x = 2 * torch.randn(K3W_ROWS, d, generator=gx, device=dev)
        y = torch.randn(K3W_ROWS, d, generator=gx, device=dev)
        wt = (torch.rand(K3W_ROWS, generator=gx, device=dev) < 0.72).float()
        h, want = ops.huber_rows_wsum(x, y, wt), ops._huber_rows_wsum_plain(x, y, wt)
        err = abs(float(h) - float(want)) / abs(float(want))
        check(err <= 1e-5 and torch.equal(ops.huber_rows_wsum(x, y, wt), h),
              f"K3w {name} ({K3W_ROWS} x {d}): relative error {err:.3e} or not bit-equal")
        nbytes = 2 * x.numel() * 4 + 4 * K3W_ROWS + 4
        bound_ms, bound_by = bound(nbytes, 6 * x.numel())
        k3w[name] = {"rows": K3W_ROWS, "d": d, "rel_err": err, "bound_ms": bound_ms, "bound_by": bound_by,
                     "ms": median_ms(lambda: ops.huber_rows_wsum(x, y, wt)),
                     "plain_ms": median_ms(lambda: ops._huber_rows_wsum_plain(x, y, wt))}
        print(f"[23] K3w {name} [{K3W_ROWS}, {d}]: {json.dumps(k3w[name])}", flush=True)
        del x, y
    out["k3w"] = k3w
    out["phase_wall_s"] = time.perf_counter() - t_phase
    print(f"[23] phase wall {out['phase_wall_s']:.1f} s", flush=True)
    return out


# ----------------------------------------------- 26. the b4096 step and shapes
K3_B4096_N = 4096 * 5660  # K3's state tensor at det128 b4096


def b4096_phase(dev, median_ms, bound) -> dict:
    """Phase 26: one det128 b4096 train step by each route, then K3 alone
    at b4096's state size, and K1-K3 timed at b4096's shapes.  Returns the
    phase's numbers and its launches."""
    import torch
    import torch.nn.functional as F

    from mfvae_tpu_torch.config import LossConfig, ModelConfig, TrainConfig
    from mfvae_tpu_torch.data.transitions import VaeBatch
    from mfvae_tpu_torch.envs.mpe import make
    from mfvae_tpu_torch.models.mavae import MAVAE, GroupedBatch
    from mfvae_tpu_torch.ops import fused_elbo as ops
    from mfvae_tpu_torch.training.experiment import build_spec
    from mfvae_tpu_torch.training.trainer import create_train_state, make_train_step
    from mfvae_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    out = {}
    profiling.reset_counters()

    # (d) det128 b4096 on simple_tag 30/10/20: one train step by each route
    # from copies of one state and one generator state
    spec = build_spec(make("MPE_simple_tag_v3", device="cpu"))
    model = MAVAE.from_config(ModelConfig(det_features=128), spec, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(0))
    draw, b = torch.Generator(device=dev).manual_seed(26), 4096
    inputs = GroupedBatch(
        obs=tuple(torch.randn(b, len(i), od, generator=draw, device=dev) for (od, _), i in spec.groups),
        actions=tuple(torch.randint(0, ad, (b, len(i)), generator=draw, device=dev, dtype=torch.int32)
                      for (_, ad), i in spec.groups),
    )
    batch = VaeBatch(inputs=inputs, next_state=torch.randn(b, sum(spec.obs_dims), generator=draw, device=dev),
                     rewards=torch.randn(b, spec.n_agents, generator=draw, device=dev))
    state = create_train_state(model, TrainConfig())
    gen = torch.Generator(device=dev).manual_seed(2)
    losses = {}
    for use_pallas in (False, True):
        twin, twin_gen = copy.deepcopy(state), torch.Generator(device=dev)
        twin_gen.set_state(gen.get_state())
        _, o = make_train_step(LossConfig(), use_pallas=use_pallas)(twin, batch, twin_gen)
        losses[use_pallas] = [float(x) for x in o]
    del twin, state, model, batch, inputs
    gap = max(abs(p - q) / abs(p) for p, q in zip(losses[False], losses[True]))
    out["b4096_routes"] = {"plain": losses[False], "kernels": losses[True], "max_rel_gap": gap}
    print(f"[26] det128 b4096 one step: loss plain {losses[False][0]:.7f} kernels {losses[True][0]:.7f}; "
          f"largest relative gap over loss, s_loss, r_loss, kl_loss {gap:.3e} (rtol 1e-4)", flush=True)
    check(gap <= 1e-4, f"det128 b4096: the routes differ by {gap:.3e} (rtol 1e-4)")

    torch.cuda.synchronize()
    launches = launch_counts()
    # the kernel route's one step; its model has no use_pallas, so no K4
    want = {"k1.launches": 1, "k2.launches": 1, "k3.launches": 2, "k3w.launches": 0, "k4.launches": 0}
    print(f"[26] launches {launches}: the b4096 step of each route", flush=True)
    check(launches == want, f"phase 26: launch counts {launches}, expected {want}")
    out["launches"] = {"b4096: det128 routes": launches}

    # (e) K3 alone at n = 4,096 x 5,660 (the multi-block grid, its arrival
    # ticket over 528 partials on 132 SMs) in f32 and bf16, against its plain
    # version; rtol 1e-5, atol 0: another summation order, as in phase 3
    g = torch.Generator(device=dev).manual_seed(26)
    out["k3_b4096"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = (2 * torch.randn(K3_B4096_N, generator=g, device=dev)).to(dtype)
        y = torch.randn(K3_B4096_N, generator=g, device=dev).to(dtype)
        h, hp = ops._huber_mean_cuda(x, y, 1.0), ops._huber_mean_plain(x, y, 1.0)
        err = float((h - hp).abs())
        same = bool(torch.equal(ops._huber_mean_cuda(x, y, 1.0), h))
        geo = ops.huber_geometry(x.data_ptr(), y.data_ptr(), K3_B4096_N, x.element_size(),
                                 ops._huber_workspace(torch.cuda.current_stream().cuda_stream).numel() - 1)
        name = str(dtype).removeprefix("torch.")
        print(f"[26] K3 {name} n={K3_B4096_N} ({geo.blocks} blocks, vec {geo.vec}): {h.item():.7f} plain "
              f"{hp.item():.7f} |err| {err:.3e} (rtol 1e-5); second call bit-equal {same}", flush=True)
        check(err <= 1e-5 * abs(hp.item()), f"K3 {name} at n={K3_B4096_N} disagrees with its plain version")
        check(same, f"K3 {name} at n={K3_B4096_N} gave two results")
        out["k3_b4096"][name] = {"max_abs_err": err, "blocks": geo.blocks}

    # (f) K1-K3 at the b4096 shapes: latents [4,096 x 40, 64]; K3 on the
    # state branch (f32, as the step hands it) and the reward branch.  Each
    # kernel's outputs are first held against its plain version on the same
    # tensors with phase 3's gates (z, dmu, dlv rtol/atol 1e-6; the KL rtol
    # 1e-5, atol 1e-6, another sum order; K3 rtol 1e-5, atol 0), then timed
    r, f = 4096 * 40, 64
    mu, lv, eps, gz = (torch.randn(r, f, generator=g, device=dev) for _ in range(4))
    gkl = torch.randn(r, generator=g, device=dev)
    xs, ys = 2 * torch.randn(K3_B4096_N, generator=g, device=dev), torch.randn(K3_B4096_N, generator=g, device=dev)
    xr, yr = 2 * torch.randn(r, generator=g, device=dev), torch.randn(r, generator=g, device=dev)
    cases = {  # kernel, plain, library, gates (rtol, atol) per output, bytes, operations
        "K1": (lambda: ops._reparam_kl_fwd_cuda(mu, lv, eps), lambda: ops._fwd_rows_plain(mu, lv, eps), None,
               {"z": (1e-6, 1e-6), "kl": (1e-5, 1e-6)}, 4 * (3 * r * f + r * f + r), 11 * r * f),
        "K2": (lambda: ops._reparam_kl_bwd_cuda(mu, lv, eps, gz, gkl),
               lambda: ops._bwd_rows_plain(mu, lv, eps, gz, gkl), None,
               {"dmu": (1e-6, 1e-6), "dlv": (1e-6, 1e-6)}, 4 * (4 * r * f + r + 2 * r * f), 12 * r * f),
        "K3": (lambda: ops._huber_mean_cuda(xs, ys, 1.0), lambda: ops._huber_mean_plain(xs, ys, 1.0),
               lambda: F.huber_loss(xs, ys, reduction="mean", delta=1.0), {"mean": (1e-5, 0.0)},
               4 * (2 * K3_B4096_N + 1), 8 * K3_B4096_N),
        "K3_reward": (lambda: ops._huber_mean_cuda(xr, yr, 1.0), lambda: ops._huber_mean_plain(xr, yr, 1.0),
                      lambda: F.huber_loss(xr, yr, reduction="mean", delta=1.0), {"mean": (1e-5, 0.0)},
                      4 * (2 * r + 1), 8 * r),
    }
    out["kernels_b4096"] = {}
    for name, (kernel, plain, library, gates, nbytes, nops) in cases.items():
        got, want = kernel(), plain()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        errs = {}
        for (what, (rtol, atol)), a, b in zip(gates.items(), got, want):
            errs[what] = float((a - b).abs().max())
            check(bool(torch.allclose(a, b, rtol=rtol, atol=atol)),
                  f"{name} at b4096: {what} disagrees with its plain version by {errs[what]:.3e} "
                  f"(rtol {rtol}, atol {atol})")
        del got, want
        bound_ms, bound_by = bound(nbytes, nops)
        k = {"max_abs_err": max(errs.values()), "ms": median_ms(kernel), "plain_ms": median_ms(plain),
             "library_ms": None if library is None else median_ms(library), "bound_ms": bound_ms, "bound_by": bound_by}
        out["kernels_b4096"][name] = k
        lib_us = "-" if k["library_ms"] is None else f"{1e3 * k['library_ms']:.2f} us"
        gate = ", ".join(f"{w} {e:.3e} (rtol {gates[w][0]}, atol {gates[w][1]})" for w, e in errs.items())
        print(f"[26] {name} at b4096: against plain max|err| {gate}; kernel {1e3 * k['ms']:.2f} us  "
              f"plain {1e3 * k['plain_ms']:.2f} us  library {lib_us}  bound {1e3 * bound_ms:.2f} us ({bound_by})",
              flush=True)
    out["phase_wall_s"] = time.perf_counter() - t_phase
    print(f"[26] phase wall {out['phase_wall_s']:.1f} s", flush=True)
    return out


def main() -> None:
    t_script = time.perf_counter()
    import torch

    # ------------------------------------------------------------ 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    try:
        from mfvae_tpu_torch.config import ExperimentConfig, load_config
        from mfvae_tpu_torch.data.transitions import vae_batch_from_grouped
        from mfvae_tpu_torch.envs.mpe import make, tag_prey_rel_slice
        from mfvae_tpu_torch.inference import WorldModel
        from mfvae_tpu_torch.models.mavae import GroupedBatch
        from mfvae_tpu_torch.ops import fused_elbo as ops
        from mfvae_tpu_torch.ops import lookup_grad as lg
        from mfvae_tpu_torch.planning import CEMNoise, EnvDynamicsModel, eval_joint_policy, make_cem_actor, make_mpc_actor
        from mfvae_tpu_torch.rollout_eval import rollout_accuracy
        from mfvae_tpu_torch.training.experiment import Experiment, build_spec
        from mfvae_tpu_torch.training import popart
        from mfvae_tpu_torch.training.trainer import make_action_sampler, make_train_step
        from mfvae_tpu_torch.utils import kernel_build
        from mfvae_tpu_torch.utils import profiling
    except ImportError as e:
        fail(f"the mfvae_tpu_torch package is not importable beside this script ({e})")
    import torch.nn.functional as F

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"[1] card: {smi}")
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)

    # ------------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    lib = kernel_build.build(ops.SOURCE)
    ops._lib()
    print(f"[2] built {lib.name} in {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    lib = kernel_build.build(lg.SOURCE)
    lg._lib()
    print(f"[2] built {lib.name} in {time.perf_counter() - t0:.2f} s", flush=True)

    # ---------------------------------------------------- 3. kernels vs plain
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def median_ms(fn, inner=20, reps=30):
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            torch.cuda._sleep(5_000_000)  # keep the device busy while the host queues
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / inner)
        return statistics.median(times)

    def allclose(a, b, rtol, atol):
        return bool(torch.allclose(a, b, rtol=rtol, atol=atol)), float((a - b).abs().max())

    def bound(nbytes, nops):
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S, nops / H100_F32_FLOPS
        return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    kernels = {}
    b, a, f = 128, 40, 64
    for shape in ((b, a, f), (3, 7, f)):
        mu, lv, eps = randn(*shape), randn(*shape), randn(*shape)
        z, kl = ops.fused_reparam_kl(mu, lv, eps)
        zp, klp = ops._fused_reparam_kl_plain(mu, lv, eps)
        ok_z, err_z = allclose(z, zp, 1e-6, 1e-6)
        ok_kl, err_kl = allclose(kl, klp, 1e-5, 1e-6)
        print(f"[3] K1 {list(shape)}: z max|err| {err_z:.3e} (rtol 1e-6, atol 1e-6) "
              f"kl max|err| {err_kl:.3e} (rtol 1e-5: another sum order)")
        check(ok_z and ok_kl, f"K1 disagrees with its plain version at {shape}")

        gz, gkl = randn(*shape), randn(*shape[:-1])
        rows = (mu.reshape(-1, f), lv.reshape(-1, f), eps.reshape(-1, f), gz.reshape(-1, f), gkl.reshape(-1))
        dmu, dlv = ops._reparam_kl_bwd_cuda(*rows)
        dmu_p, dlv_p = ops._bwd_rows_plain(*rows)
        ok_mu, err_mu = allclose(dmu, dmu_p, 1e-6, 1e-6)
        ok_lv, err_lv = allclose(dlv, dlv_p, 1e-6, 1e-6)
        m1, l1 = mu.clone().requires_grad_(), lv.clone().requires_grad_()
        m2, l2 = mu.clone().requires_grad_(), lv.clone().requires_grad_()
        ga = torch.autograd.grad(ops.fused_reparam_kl(m1, l1, eps), (m1, l1), (gz, gkl))
        gb = torch.autograd.grad(ops._fused_reparam_kl_plain(m2, l2, eps), (m2, l2), (gz, gkl))
        ok_ag_mu, err_ag_mu = allclose(ga[0], gb[0], 1e-6, 1e-6)
        ok_ag_lv, err_ag_lv = allclose(ga[1], gb[1], 1e-5, 1e-5)
        print(f"[3] K2 {list(shape)}: vs the plain K2 formula dmu {err_mu:.3e} dlv {err_lv:.3e} "
              f"(rtol 1e-6, atol 1e-6); via autograd.grad vs the plain function's autograd "
              f"dmu {err_ag_mu:.3e} (1e-6) dlv {err_ag_lv:.3e} (rtol/atol 1e-5: the chain "
              f"rule rounds the two dlv terms in another order)")
        check(ok_mu and ok_lv and ok_ag_mu and ok_ag_lv, f"K2 disagrees with its plain version at {shape}")
        if shape == (b, a, f):
            r = b * a
            k1_args = rows[:3]
            k2_args = rows
            kernels["K1"] = dict(
                max_abs_err=max(err_z, err_kl),
                ms=median_ms(lambda: ops._reparam_kl_fwd_cuda(*k1_args)),
                plain_ms=median_ms(lambda: ops._fwd_rows_plain(*k1_args)),
                bytes=4 * (3 * r * f + r * f + r), ops=11 * r * f,
            )
            kernels["K2"] = dict(
                max_abs_err=max(err_mu, err_lv),
                ms=median_ms(lambda: ops._reparam_kl_bwd_cuda(*k2_args)),
                plain_ms=median_ms(lambda: ops._bwd_rows_plain(*k2_args)),
                bytes=4 * (4 * r * f + r + 2 * r * f), ops=12 * r * f,
            )

    floor_ms = median_ms(lambda: torch.cuda._sleep(0))
    print(f"[3] launch floor (torch.cuda._sleep(0), an empty kernel): {1e3 * floor_ms:.2f} us", flush=True)

    state_n, reward_n = b * (30 * 142 + 10 * 140), b * a
    thr = ops.HUBER_SINGLE_BLOCK_MAX
    wave = ops._HUBER_BLOCKS_PER_SM * torch.cuda.get_device_properties(0).multi_processor_count
    k3_errs = []

    def k3_case(label, x, y, delta):
        h = ops.huber_mean(x, y, delta)
        hp = ops._huber_mean_plain(x, y, delta)
        ok, err = allclose(h, hp, 1e-5, 0.0)
        same = bool(torch.equal(ops.huber_mean(x, y, delta), h))
        hl = F.huber_loss(x.float(), y.float(), reduction="mean", delta=delta)
        print(f"[3] K3 {label} delta={delta}: {h.item():.7f} plain {hp.item():.7f} "
              f"F.huber_loss {hl.item():.7f} |err| {err:.3e} (rtol 1e-5: another sum order); "
              f"second call bit-equal {same}")
        check(ok, f"K3 disagrees with its plain version: {label}, delta={delta}")
        check(same, f"K3 gave two results on the same inputs: {label}")
        k3_errs.append(err)

    # the order alternates single- and multi-block grids, so a counter left
    # non-zero by one call would break the next
    for n in (state_n, reward_n, 1001, 1, 3, thr - 1, thr, thr + 1):
        for delta in (1.0, 0.5):
            x, y = 2 * randn(n), randn(n)
            k3_case(f"f32 n={n}", x, y, delta)
            if delta == 1.0 and n in (state_n, reward_n):
                kernels["K3" if n == state_n else "K3_reward"] = dict(
                    ms=median_ms(lambda: ops._huber_mean_cuda(x, y, delta)),
                    plain_ms=median_ms(lambda: ops._huber_mean_plain(x, y, delta)),
                    library_ms=median_ms(lambda: F.huber_loss(x, y, reduction="mean", delta=delta)),
                    bytes=4 * (2 * n + 1), ops=8 * n,
                )
    k3_paths = []
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for n in (state_n, reward_n):
            x, y = (2 * randn(n + 1)).to(dtype), randn(n + 1).to(dtype)
            name = str(dtype).removeprefix("torch.")
            k3_case(f"{name} n={n}", x[:n], y[:n], 1.0)
            k3_case(f"{name} n={n} x[1:] y[1:] (scalar head)", x[1:], y[1:], 1.0)
            k3_case(f"{name} n={n} x[1:] y[:-1] (scalar loads)", x[1:], y[:-1], 1.0)
            xa, ya = x[:n].clone(), y[:n].clone()
            geo = ops.huber_geometry(xa.data_ptr(), ya.data_ptr(), n, xa.element_size(), wave)
            k3_paths.append({
                "dtype": name, "n": n, "blocks": geo.blocks, "vec": geo.vec,
                "ms": median_ms(lambda: ops._huber_mean_cuda(xa, ya, 1.0)),
                "bound_ms": bound(xa.element_size() * 2 * n + 4, 8 * n)[0],
            })
    for kind in ("K3", "K3_reward"):
        kernels[kind]["max_abs_err"] = max(k3_errs)

    # one device kernel per K3 call, by the profiler's count
    from torch.profiler import ProfilerActivity, profile

    for n in (state_n, reward_n):
        x, y = 2 * randn(n), randn(n)
        ops.huber_mean(x, y)  # the stream's workspace exists before the trace
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ops.huber_mean(x, y)
            torch.cuda.synchronize()
        rows = [
            (e.key, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
        ]
        check(bool(rows), "torch.profiler recorded no device rows: K3's kernels per call cannot be counted")
        huber = sum(c for k, c in rows if "huber" in k)
        print(f"[3] K3 n={n}: {huber} device kernel(s) named *huber* in one call "
              f"(torch.profiler device rows {rows})")
        check(huber == 1, f"K3 launched {huber} device kernels in one call at n={n}, expected 1")

    # the single-block threshold: one block against the multi-block grid
    crossover = []
    for n in (4096, 8192, 12288, 16384, 32768, 131072):
        x, y = 2 * randn(n), randn(n)
        blocks = ops.huber_geometry(x.data_ptr(), y.data_ptr(), n, 4, wave, 0).blocks
        one = median_ms(lambda: ops._huber_mean_cuda(x, y, 1.0, single_block_max=n))
        many = median_ms(lambda: ops._huber_mean_cuda(x, y, 1.0, single_block_max=0))
        crossover.append({"n": n, "one_block_ms": one, "blocks": blocks, "multi_block_ms": many})
        print(f"[3] K3 crossover n={n}: one block {1e3 * one:.2f} us, {blocks} blocks {1e3 * many:.2f} us")
    print(f"[3] K3 single-block threshold n <= {thr}")
    print(json.dumps({"launch_floor_ms": floor_ms, "k3_paths": k3_paths, "k3_crossover": crossover}))
    # K4 at the b4,096 lookups' shapes (tag_wm's adversaries and good
    # agents: bf16 gradients [4,096, 30 | 10, 64], positions in a 40-row
    # table, actions in 5 bins), each mode against its plain version (each
    # element within 2^-19 of the sum of the magnitudes it adds: both f32
    # sums within 2^-20 of the exact one), twice bit-equal, then timed
    # beside the library call it replaces: the gradient's cast to f32 and
    # index_put_(accumulate=True) into a zeroed table, advanced indexing's
    # backward
    for first, cols in ((0, 30), (30, 10)):
        gk = randn(4096, cols, 64).to(torch.bfloat16)
        idx = torch.randint(0, 5, (4096, cols), generator=g, device=dev, dtype=torch.int32)
        pos = torch.arange(first, first + cols, device=dev)
        stack = torch.arange(cols, device=dev)
        for mode, kw, rows, index, nbytes in (
            ("fixed", dict(pos=pos), 40, (pos[None, :].expand(4096, -1),), 8 * cols + 4 * 40 * 64),
            ("bins", dict(idx=idx, bins=5), 5 * cols, (stack[None, :], idx.long()), 4 * idx.numel() + 4 * 5 * cols * 64),
        ):
            got = lg.lookup_grad(gk, rows, **kw)
            same = bool(torch.equal(lg.lookup_grad(gk, rows, **kw), got))
            want = lg._lookup_grad_plain(gk, rows, **kw)
            mag = lg._lookup_grad_plain(gk.abs(), rows, **kw)
            err = float(((got - want).abs() / mag.clamp_min(1e-30)).max())
            label = f"{mode} [4096, {cols}, 64] bf16"
            print(f"[3] K4 {label}: max |kernel - plain| over the magnitudes summed {err:.3e} (2^-19); "
                  f"second call bit-equal {same}")
            check(err <= 2.0**-19 and same, f"K4 {label}: disagrees with its plain version or gave two results")
            shape = (40, 64) if mode == "fixed" else (cols, 5, 64)
            kernels[f"K4 {label}"] = dict(
                max_rel_err=err,
                ms=median_ms(lambda: lg._lookup_grad_cuda(gk, rows, **kw)),
                plain_ms=median_ms(lambda: lg._lookup_grad_plain(gk, rows, **kw)),
                library_ms=median_ms(lambda: torch.zeros(shape, device=dev).index_put_(
                    index, gk.float(), accumulate=True)),
                bytes=2 * gk.numel() + nbytes, ops=gk.numel(),
            )
    torch.cuda.synchronize()
    for name, k in kernels.items():
        k["bound_ms"], k["bound_by"] = bound(k["bytes"], k["ops"])
        lib_us = "-" if k.get("library_ms") is None else f"{1e3 * k['library_ms']:.2f} us"
        print(f"[3] {name}: kernel {1e3 * k['ms']:.2f} us  plain {1e3 * k['plain_ms']:.2f} us  "
              f"library {lib_us}  bound {1e3 * k['bound_ms']:.2f} us ({k['bound_by']})", flush=True)

    # ------------------------------------------- 4./5. the main path, both routes
    examples = Path(__file__).resolve().parent / "examples"

    def drive(cfg, use_pallas: bool, epochs: int, tmp: str, phase: str, label: str):
        """Experiment(cfg).setup().run() for ``epochs``, with the launch
        counts set to 0 just before the run and read just after."""
        cfg.model.use_pallas = use_pallas
        cfg.train.epoch_num = epochs
        cfg.train.log_dir = f"{tmp}/results"
        cfg.train.checkpoint_dir = f"{tmp}/ckpt"
        exp = Experiment(cfg).setup()
        profiling.reset_counters()
        exp.result = result = exp.run()
        torch.cuda.synchronize()
        launches = launch_counts()
        wall = [round(1e3 * s, 3) for s in result["epoch_wall_s"]]
        print(f"[{phase}] {label}, use_pallas={str(use_pallas).lower()}, {epochs} epoch(s): "
              f"loss_train {result['loss_train']:.6f} loss_test {result['loss_test']:.6f} "
              f"epoch wall ms {wall} launches {launches}", flush=True)
        check(math.isfinite(result["loss_train"]) and math.isfinite(result["loss_test"]),
              f"{label}: non-finite losses")
        if use_pallas:
            # an unroll step: K1/K2 in each of its W window steps, K3w on its two
            # pooled branches and no K3; a one-step step: K1, K2 and two K3;
            # K4 in each forward's backward
            tn, w = cfg.train.train_num, cfg.train.unroll_steps
            want = {"k1.launches": epochs * tn * w, "k2.launches": epochs * tn * w,
                    "k3.launches": 0 if w > 1 else 2 * epochs * tn, "k3w.launches": 2 * epochs * tn if w > 1 else 0,
                    "k4.launches": epochs * tn * w * k4_per_step(exp.spec, cfg.model)}
            check(launches == want, f"{label}: launch counts {launches}, expected {want}")
        else:
            check(not any(launches.values()), f"{label}: the plain route launched kernels: {launches}")
        return exp, wall, launches

    def both_routes(exp, phase: str, label: str):
        """One train step by both routes from one state, batch and
        generator state; the losses within rtol 1e-4."""
        carry, spec, cfg = exp.carry, exp.spec, exp.cfg
        batch = vae_batch_from_grouped(
            spec, exp.buffer.sample(carry.buffer_state, torch.Generator(device=dev).manual_seed(1)).experience
        )
        outs = {}
        for use_pallas in (False, True):
            state = copy.deepcopy(carry.train_state)
            gen = torch.Generator(device=dev).manual_seed(2)
            step = make_train_step(cfg.loss, cfg.train.mode, cfg.train.popart_beta, use_pallas=use_pallas)
            _, o = step(state, batch, gen)
            outs[use_pallas] = [float(x) for x in o]
            if use_pallas:
                recon_s, recon_r, _ = state.model.fused_call(batch.inputs, None, gen)
                b = cfg.train.batch_size
                check(tuple(recon_s.shape) == (b, sum(spec.obs_dims)) and tuple(recon_r.shape) == (b, spec.n_agents),
                      f"{label}: output shapes {tuple(recon_s.shape)}, {tuple(recon_r.shape)}")
                check(bool(torch.isfinite(recon_s).all() and torch.isfinite(recon_r).all()),
                      f"{label}: non-finite outputs")
        for name, p, q in zip(("loss", "s_loss", "r_loss", "kl_loss"), outs[False], outs[True]):
            print(f"[{phase}] {label} one step, {name}: plain {p:.7f} kernels {q:.7f} rel {abs(p - q) / abs(p):.3e}")
            check(abs(p - q) <= 1e-4 * abs(p), f"{label}: {name} differs between the routes beyond rtol 1e-4")
        return batch

    path_launches = {}
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        # = examples/reference_parity.yaml
        exp, walls["reference_parity, kernels"], main_launches = drive(
            ExperimentConfig(), True, 2, f"{tmp}/pallas", "4", "reference_parity")
        path_launches["reference_parity"] = main_launches
        del exp
        exp, walls["reference_parity, plain"], _ = drive(
            ExperimentConfig(), False, 1, f"{tmp}/plain", "5", "reference_parity")

        # ----------------------------------------- 6. one step by both routes
        both_routes(exp, "6", "reference_parity")
        del exp

        # ------------------------------------------------------ 7. world model
        wm = str(examples / "world_model.yaml")
        exp, walls["world_model, kernels"], path_launches["world_model"] = drive(
            load_config(wm), True, 2, f"{tmp}/wm_pallas", "7", "world_model")
        m = exp.cfg.model
        check(m.det_features == 128 and m.residual_state and m.state_skip and m.decoder_layernorm
              and not m.fused_decoders and exp.cfg.loss.s_weight == 300.0 and m.compute_dtype == "bfloat16",
              "world_model.yaml is not the configuration this phase names")
        dec_in = exp.carry.train_state.model.state_decoder.fc0.kernel.shape[0]
        print(f"[7] world_model decoder input width {dec_in}")
        check(dec_in == 15900, f"world_model decoder input {dec_in}, expected 15,900")
        del exp
        exp, walls["world_model, plain"], _ = drive(load_config(wm), False, 1, f"{tmp}/wm_plain", "7", "world_model")
        both_routes(exp, "7", "world_model")
        del exp

        # ----------------------------------------------------------- 8. PopArt
        exp, walls["torch_popart, kernels"], path_launches["torch_popart"] = drive(
            load_config(str(examples / "torch_popart.yaml")), True, 2, f"{tmp}/popart", "8", "torch_popart")
        check(exp.cfg.train.mode == "POPART" and exp.cfg.train.train_num == 4, "torch_popart.yaml changed")
        sigma = exp.carry.train_state.popart.sigma
        print(f"[8] torch_popart sigma after {exp.carry.train_state.step} steps: "
              f"min {float(sigma.min()):.7f} max {float(sigma.max()):.7f}")
        check(bool(torch.isfinite(sigma).all()) and not bool((sigma == 1).all()), "PopArt sigma did not move off 1")
        batch = both_routes(exp, "8", "torch_popart")
        # the invariant, on the card: the head in float32 on a real batch's input
        model = copy.deepcopy(exp.carry.train_state.model)
        seen = []
        hook = model.reward_linear.register_forward_hook(lambda mod, args, out: seen.append(args[0].float()))
        with torch.no_grad():
            model.mean_call(batch.inputs)
        hook.remove()
        x = seen[0]
        old = exp.carry.train_state.popart
        new = popart.art(old, 3.0 + 5.0 * randn(*batch.rewards.shape), 0.3)

        @torch.no_grad()
        def denormalized(stats):
            head = model.reward_linear
            return popart.denormalize(stats, x @ head.kernel + head.bias)

        before = denormalized(old)
        popart.pop_rescale_head(model, old, new)
        after = denormalized(new)
        scale = float(before.abs().max())
        err = float((after - before).abs().max())
        print(f"[8] pop invariant: max |after - before| {err:.3e}, max |before| {scale:.4f}, "
              f"sigma moved by up to {float((new.sigma / old.sigma - 1).abs().max()):.3f}x")
        check(err <= 1e-5 * scale, "denormalized predictions moved under pop_rescale_head beyond rtol 1e-5")
        del exp, model

        # ------------------------------------------- 9. det_quality + shared_private
        label = "det_quality+shared_private"
        cfg = load_config(str(examples / "det_quality.yaml"), ["model.latent_structure=shared_private"])
        exp, walls[label], path_launches[label] = drive(cfg, True, 1, f"{tmp}/det_shared", "9", label)
        del exp

        # ------------------------------------------------- 10. plain-only options
        twohot = ExperimentConfig()
        twohot.model.reward_head_mode = "twohot"
        twohot.model.reward_head_input = "pred_state"
        twohot.model.fused_decoders = False
        twohot.model.action_delta_head = True
        weighted = ExperimentConfig()
        weighted.loss.contact_weight = 1.0
        weighted.loss.prey_dist_weight = 1.0
        for label, cfg in (
            ("twohot+pred_state+action_delta_head", twohot),
            ("continuous_tag", load_config(str(examples / "continuous_tag.yaml"))),
            ("contact_weight+prey_dist_weight", weighted),
        ):
            exp, walls[label], _ = drive(cfg, False, 1, f"{tmp}/{label}", "10", label)
            del exp

        # ------------------------------------------------- 11. batched pursuit
        def contact_share(exp):
            """Share of the train buffer's transitions whose largest agent
            reward exceeds loss.contact_threshold."""
            st = exp.carry.buffer_state
            rew = st.data.rewards[:, : st.size]
            return float((rew.amax(-1) > exp.cfg.loss.contact_threshold).float().mean())

        pursuit = str(examples / "pursuit_collection.yaml")
        label = "pursuit_collection n_envs=4"
        exp, walls[f"{label}, kernels"], path_launches[label] = drive(
            load_config(pursuit, ["train.n_envs=4"]), True, 2, f"{tmp}/pursuit_pallas", "11", label)
        shards = tuple(exp.carry.buffer_state.data.rewards.shape)
        print(f"[11] {label}: train buffer shards {shards}, filled {exp.carry.buffer_state.size} per shard")
        check(shards == (4, 2500, 40) and exp.cfg.train.collect_policy == "pursuit",
              f"{label}: buffer shards {shards}, expected (4, 2500, 40)")
        del exp
        exp, walls[f"{label}, plain"], _ = drive(
            load_config(pursuit, ["train.n_envs=4"]), False, 1, f"{tmp}/pursuit_plain", "11", label)
        both_routes(exp, "11", label)
        shares = {"pursuit": contact_share(exp)}
        del exp
        exp, walls["random collection n_envs=4, plain"], _ = drive(
            load_config(pursuit, ["train.n_envs=4", "train.collect_policy=random"]), False, 1,
            f"{tmp}/random_plain", "11", "random collection n_envs=4")
        shares["random"] = contact_share(exp)
        print(f"[11] contact share of the train buffer after 1 epoch (max reward > "
              f"{exp.cfg.loss.contact_threshold}): pursuit {shares['pursuit']:.6f} random {shares['random']:.6f}")
        del exp

        # ---------------------------------------------------- 12. episode_mix
        label = "episode_mix_collection n_envs=4"
        exp, walls[f"{label}, kernels"], path_launches[label] = drive(
            load_config(str(examples / "episode_mix_collection.yaml"), ["train.n_envs=4"]), True, 1,
            f"{tmp}/mix_pallas", "12", label)
        carry = exp.carry.env.policy
        print(f"[12] {label}: policy carry {[(tuple(x.shape), str(x.dtype)) for x in carry]}, "
              f"episodes under pursuit {carry[1].tolist()}")
        check(len(carry) == 2 and all(tuple(x.shape) == (4,) for x in carry), f"{label}: no per-env policy carry")
        del exp

        # ---------------------------------------- 13. world_model_control, unroll
        control = str(examples / "world_model_control.yaml")
        label = "world_model_control"
        exp, walls[f"{label}, plain"], _ = drive(load_config(control), False, 2, f"{tmp}/control", "13", label)
        c, m = exp.cfg, exp.cfg.model
        check(c.train.collect_policy == "sticky" and c.train.collect_mix_frac == 0.95 and c.train.unroll_steps == 8
              and c.train.grad_clip == 10.0 and m.action_delta_head and m.det_features == 128,
              "world_model_control.yaml is not the configuration this phase names")
        model = exp.carry.train_state.model
        dec_in = model.state_decoder.fc0.kernel.shape[0]
        print(f"[13] {label}: decoder input width {dec_in}, {exp.carry.train_state.step} unroll steps taken, "
              f"policy carry {[tuple(x.shape) for x in exp.carry.env.policy]}")
        check(dec_in == 15900, f"{label} decoder input {dec_in}, expected 15,900")
        # the kernel route, which the JAX package refuses for unroll_steps > 1
        exp_k, walls[f"{label}, kernels"], path_launches[label] = drive(
            load_config(control), True, 1, f"{tmp}/control_k", "13", label)
        del exp_k

        # ------------------------------------------- 14. world_model_unroll
        unroll_yaml = str(examples / "world_model_unroll.yaml")
        exp_u, walls["world_model_unroll, kernels"], path_launches["world_model_unroll"] = drive(
            load_config(unroll_yaml), True, 1, f"{tmp}/unroll_k", "14", "world_model_unroll")
        # ------------------------------------ 23. one unroll step by both routes
        unroll_out = unroll_routes_phase(exp_u, dev, median_ms, bound)
        print(f"[23] unroll routes summary: {json.dumps(unroll_out)}", flush=True)
        del exp_u
        label = "world_model_unroll n_envs=4"
        exp4, walls[f"{label}, plain"], _ = drive(
            load_config(unroll_yaml, ["train.n_envs=4"]), False, 1,
            f"{tmp}/unroll4", "14", label)
        cap = exp4.buffer.max_length
        print(f"[14] {label}: shards {tuple(exp4.carry.buffer_state.data.rewards.shape)}, per-shard capacity {cap}")
        check(cap == 2560 and cap % exp4.cfg.train.sample_num == 0, f"{label}: per-shard capacity {cap}")
        del exp4

        # ------------------------------------------------------- 15. serving
        wm = WorldModel(model)
        gen = torch.Generator(device=dev).manual_seed(3)
        batch = vae_batch_from_grouped(exp.spec, exp.buffer.sample(exp.carry.buffer_state, gen).experience)
        pred = wm.predict(batch.inputs, None)
        with torch.no_grad():
            want = model.mean_call(batch.inputs)
        check(all(torch.equal(p, q) for p, q in zip(pred, want)), "WorldModel.predict differs from mean_call")
        big = exp.buffer.sample(exp.carry.buffer_state, gen, batch_size=256).experience
        sample_actions, group_actions = make_action_sampler(exp.env, exp.spec)
        plan = group_actions(sample_actions(gen, (25, 256)))
        states, rewards = wm.rollout(GroupedBatch(obs=big.obs, actions=big.actions), plan)
        first = wm.predict(GroupedBatch(obs=big.obs, actions=tuple(a[0] for a in plan)), None)
        check(tuple(states.shape) == (25, 256, 5660) and tuple(rewards.shape) == (25, 256, 40),
              f"rollout shapes {tuple(states.shape)}, {tuple(rewards.shape)}")
        check(bool(torch.isfinite(states).all() and torch.isfinite(rewards).all()), "non-finite rollout")
        check(torch.equal(states[0], first[0]) and torch.equal(rewards[0], first[1]),
              "the rollout's first step differs from predict")
        times = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            wm._rollout(big.obs, plan)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        rollout_ms = statistics.median(times)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wm._rollout(big.obs, plan)
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)) / 1e3
        n_kernels = sum(e.count for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and not getattr(e, "is_user_annotation", False))
        print(f"[15] predict and the rollout's first step bit-equal to mean_call; rollout T=25 B=256: "
              f"median {rollout_ms:.3f} ms of 5 (CUDA events; all {[round(t, 3) for t in times]}); "
              f"device busy {busy:.3f} ms in {n_kernels} kernels (torch.profiler, one rollout)")
        accuracy = {}
        for pol in ("random", "pursuit"):
            t0 = time.perf_counter()
            acc = rollout_accuracy(wm, exp.env, exp.spec, torch.Generator(device=dev).manual_seed(4),
                                   horizons=(1, 5, 25), n_starts=256, burn_in=32, policy=pol)
            accuracy[pol] = acc
            print(f"[15] rollout_accuracy {pol} ({time.perf_counter() - t0:.2f} s): {json.dumps(acc)}")
            check(all(math.isfinite(v) for v in acc.values()), f"rollout_accuracy {pol}: non-finite metric")
        control_exp, control_wm = exp, wm  # served again by phase 18
        del exp, model, wm

        # ------------------------------------------------ 16. the other scenarios
        t_phase = time.perf_counter()
        expect = {
            "spread": [(10, 60, 5)],
            "adversary": [(1, 40, 5), (10, 42, 5)],
            "world_comm": [(1, 156, 20), (29, 164, 5), (10, 150, 5)],
        }
        for short, groups_want in expect.items():
            env_name = f"MPE_simple_{short}_v3"
            exp, walls[f"{short}, kernels"], path_launches[short] = drive(
                load_config(str(examples / "reference_parity.yaml"), [f"env.name={env_name}"]), True, 1,
                f"{tmp}/{short}_pallas", "16", short)
            groups = [(len(i), od, ad) for (od, ad), i in exp.spec.groups]
            print(f"[16] {short}: groups (agents, obs, actions) {groups}, Σobs {sum(exp.spec.obs_dims)}")
            check(groups == groups_want, f"{short}: groups {groups}, expected {groups_want}")
            del exp
            exp, walls[f"{short}, plain"], _ = drive(
                load_config(str(examples / "reference_parity.yaml"), [f"env.name={env_name}"]), False, 1,
                f"{tmp}/{short}_plain", "16", short)
            both_routes(exp, "16", short)
            del exp
        n = b * (156 + 29 * 164 + 10 * 150)
        x, y = 2 * randn(n), randn(n)
        k3_case(f"f32 n={n} (world_comm state branch)", x, y, 1.0)
        k3_wc = dict(
            n=n, ms=median_ms(lambda: ops._huber_mean_cuda(x, y, 1.0)),
            plain_ms=median_ms(lambda: ops._huber_mean_plain(x, y, 1.0)),
            library_ms=median_ms(lambda: F.huber_loss(x, y, reduction="mean", delta=1.0)),
        )
        k3_wc["bound_ms"], k3_wc["bound_by"] = bound(4 * (2 * n + 1), 8 * n)
        print(f"[16] K3 at world_comm's state branch: {json.dumps(k3_wc)}")
        print(f"[16] phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)
        t_phase = time.perf_counter()

        # ------------------------------------------ 17. pursuit on simple_adversary
        label = "pursuit_collection adversary n_envs=4"
        exp, walls[f"{label}, kernels"], path_launches[label] = drive(
            load_config(pursuit, ["train.n_envs=4", "env.name=MPE_simple_adversary_v3"]), True, 1,
            f"{tmp}/adv_pursuit", "17", label)
        st, goal = exp.carry.buffer_state, exp.carry.env.state.goal
        good = st.data.obs[1][:, : st.size, 0]  # good agent 0 of every stored transition: [4, size, 42]
        n_lm = exp.env.num_landmarks
        match = (good[..., 2 : 2 + 2 * n_lm].reshape(4, st.size, n_lm, 2) == good[..., None, 0:2]).all(-1)
        seen = match.to(torch.float32).argmax(-1)  # [4, size]: the goal each transition shows
        print(f"[17] {label}: shards {tuple(st.data.rewards.shape)}, env goals {goal.tolist()}, "
              f"goals shown per shard {[sorted(set(r)) for r in seen.tolist()]}")
        check(bool((match.sum(-1) == 1).all()), f"{label}: a stored goal channel matches no single landmark")
        # 2 x 128 steps of episodes of 1,000: no reset inside the epoch
        check(bool((seen == goal[:, None]).all()), f"{label}: a shard holds another env's goal")
        del exp
        print(f"[17] phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)
        t_phase = time.perf_counter()

        # ------------------------------------------------------ 18. planning
        env, spec = control_exp.env, control_exp.spec
        n_adv, n_good = control_exp.cfg.env.num_adversaries, control_exp.cfg.env.num_good_agents
        od_adv, prey = spec.obs_dims[0], tag_prey_rel_slice(control_exp.cfg.env.num_obs, n_adv, n_good)
        E, T, N, Hz = 8, 25, 64, 8

        def prey_distance(states, rewards):
            """[M, n_adv]: minus each adversary's summed distance to its
            nearest prey over the horizon, read off the predicted obs."""
            h, m = states.shape[:2]
            rel = states[:, :, : n_adv * od_adv].reshape(h, m, n_adv, od_adv)[..., prey]
            rel = rel.reshape(h, m, n_adv, n_good, 2)
            return -torch.sum(torch.sqrt(torch.sum(rel * rel, dim=-1) + 1e-12).amin(-1), dim=0)

        def evaluate(label, env_, spec_, actor=None, needs_state=False):
            """E episodes of T steps: the adversaries under ``actor`` (at
            random without one), the good agents at random."""
            sample, _ = make_action_sampler(env_, spec_)
            is_adv = torch.tensor([a.startswith(("adversary", "leadadversary")) for a in env_.agents], device=dev)

            def policy(obs, state, g):
                rand = sample(g, (E,))
                if actor is None:
                    return rand
                return torch.where(is_adv, actor(obs, g, state) if needs_state else actor(obs, g), rand)

            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            r = eval_joint_policy(env_, spec_, policy, n_episodes=E, ep_len=T,
                                  generator=torch.Generator(device=dev).manual_seed(18))
            end.record()
            torch.cuda.synchronize()
            ret = float(r[:, :, is_adv].sum((1, 2)).mean())
            ms = start.elapsed_time(end) / T
            print(f"[18] {label}: adversary return {ret:.4f} (mean over {E} episodes of {T} steps), "
                  f"{ms:.3f} ms per served step (CUDA events)", flush=True)
            check(tuple(r.shape) == (E, T, spec_.n_agents) and bool(torch.isfinite(r).all()),
                  f"{label}: rewards {tuple(r.shape)}, or not finite")
            return ret

        adv_idx = tuple(range(n_adv))
        tdm = EnvDynamicsModel(env, spec)
        mpc_kw = dict(horizon=Hz, n_candidates=N, plan_agents=adv_idx, score_fn=prey_distance,
                      factorized=True, candidate_mode="repeat")
        cem_kw = dict(horizon=Hz, n_candidates=N, plan_agents=adv_idx, score_fn=prey_distance, iters=3)
        returns = {"random, simple_tag": evaluate("random, simple_tag", env, spec)}
        returns["MPC, learned model"] = evaluate(
            "factorized repeat MPC, learned control model", env, spec, make_mpc_actor(control_wm, env, spec, **mpc_kw))
        returns["CEM, learned model"] = evaluate(
            "CEM iters=3, learned control model", env, spec, make_cem_actor(control_wm, env, spec, **cem_kw))
        mpc_true, cem_true = make_mpc_actor(tdm, env, spec, **mpc_kw), make_cem_actor(tdm, env, spec, **cem_kw)
        returns["MPC, true dynamics"] = evaluate(
            "factorized repeat MPC, true dynamics", env, spec, mpc_true, needs_state=True)
        returns["CEM, true dynamics"] = evaluate("CEM iters=3, true dynamics", env, spec, cem_true, needs_state=True)
        wc_env = make("MPE_simple_world_comm_v3", device=dev, num_good_agents=10, num_adversaries=30, num_obs=20,
                      max_steps=1000)
        wc_spec = build_spec(wc_env)
        returns["random, simple_world_comm"] = evaluate("random, simple_world_comm", wc_env, wc_spec)
        wc_mpc = make_mpc_actor(EnvDynamicsModel(wc_env, wc_spec), wc_env, wc_spec, horizon=Hz, n_candidates=N,
                                plan_agents=adv_idx, factorized=True, candidate_mode="repeat")
        returns["MPC, true dynamics, simple_world_comm"] = evaluate(
            "factorized repeat MPC (predicted reward), true dynamics, simple_world_comm", wc_env, wc_spec,
            wc_mpc, needs_state=True)
        print(f"[18] adversary returns: {json.dumps(returns)}")
        check(returns["MPC, true dynamics"] > returns["random, simple_tag"],
              "true-dynamics MPC does not beat random on simple_tag adversary return")
        # an [E]-batched call equals E per-episode calls with the same draws
        g = torch.Generator(device=dev).manual_seed(19)
        obs, state = env.reset_stacked(g, batch_shape=(E,))

        def episode(e):
            return type(obs)(*(o[e] for o in obs)), type(state)(*(x[e] for x in state))

        plans = make_action_sampler(env, spec)[0](g, (Hz, E, N))
        batched = mpc_true(obs, None, state, plans=plans)
        singles = torch.stack([mpc_true(episode(e)[0], None, episode(e)[1], plans=plans[:, e]) for e in range(E)])
        check(torch.equal(batched, singles), "batched true-dynamics MPC differs from per-episode calls")
        noise = cem_true.draw_noise(g, (E,))
        batched = cem_true(obs, None, state, noise=noise)
        singles = torch.stack([cem_true(episode(e)[0], None, episode(e)[1], noise=CEMNoise(
            [x[:, e] for x in noise.gumbel], [x[:, e] for x in noise.others], noise.final[e])) for e in range(E)])
        check(torch.equal(batched, singles), "batched true-dynamics CEM differs from per-episode calls")
        print(f"[18] [E={E}]-batched true-dynamics MPC and CEM equal {E} per-episode calls with the same draws")
        print(f"[18] phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)
        del control_exp, control_wm

        # ------------------------------------------- 19. behavior in imagination
        behavior_out, behavior_exp = behavior_phase(drive, examples, tmp, dev)
        path_launches["behavior: train_behavior x3"] = behavior_out["launches"]

        # ------------------------------------------------------- 20. baselines
        baselines_out = baselines_phase(drive, examples, tmp, dev, behavior_exp)
        del behavior_exp
        path_launches.update({f"baselines: {k}": v for k, v in baselines_out["launches"].items()})

        # ----------------------------------- 21. the host backend, the VAE families
        policy = f"{tmp}/vdn_policy.npz"  # phase 20's
        check(Path(policy).exists(), "phase 20 left no vdn: policy file")
        host_out = host_phase(tmp, dev, policy)
        path_launches.update(host_out["launches"])
        vae_out = vae_phase(tmp, dev)
        print(f"[21] host and VAE summary: {json.dumps({'host': host_out, 'vae': vae_out})}")
        print(f"[21] phase wall {host_out['phase_wall_s'] + vae_out['phase_wall_s']:.1f} s", flush=True)

        # ------------------------------------------------- 22. the M20 tooling
        tooling_out = tooling_phase(drive, both_routes, examples, tmp, dev, smi)
        path_launches.update(tooling_out["launches"])
        print(f"[22] tooling summary: {json.dumps(tooling_out)}")

        # ------------------------------------------------------ 24. scale-out
        scaleout_out = scaleout_phase(examples, tmp, dev, smi)
        path_launches.update(scaleout_out["launches"])
        print(f"[24] scale-out summary: {json.dumps(scaleout_out)}")

    # ------------------------------------------- 25. the reference's dicts
    reference_out = reference_dicts_phase(dev)
    path_launches.update(reference_out.pop("launches"))
    print(f"[25] reference dicts summary: {json.dumps(reference_out)}")

    # ----------------------------------------------- 26. the b4096 step and shapes
    b4096_out = b4096_phase(dev, median_ms, bound)
    path_launches.update(b4096_out.pop("launches"))
    print(f"[26] b4096 summary: {json.dumps(b4096_out)}")

    # ------------------------------------------------------ 27. the kernel list
    src = "mfvae_tpu_torch/ops/csrc/fused_elbo.cu"
    table = [
        ("K1 fused_reparam_kl fwd", "K1", "mfvae_tpu/ops/fused_elbo.py:49", "k1.launches"),
        ("K2 fused_reparam_kl bwd", "K2", "mfvae_tpu/ops/fused_elbo.py:60", "k2.launches"),
        ("K3 huber_mean", "K3", "mfvae_tpu/ops/fused_elbo.py:164", "k3.launches"),
    ]
    line = []
    for name, key, replaces, counter in table:
        k = kernels[key]
        line.append({
            "name": name, "ok": True, "route": "cuda", "source": src, "replaces": replaces,
            "launches": main_launches[counter], "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k.get("library_ms"),
            "launches_by_path": {path: n[counter] for path, n in path_launches.items()},
            "at_b4096": b4096_out["kernels_b4096"][key],
        })
    # K3w, at the unroll cell's state shape (phase 23); the JAX package has no such kernel
    k = unroll_out["k3w"]["state"]
    line.append({
        "name": "K3w huber_rows_wsum", "ok": True, "route": "cuda", "source": src, "replaces": None,
        "launches": main_launches["k3w.launches"], "max_rel_err": k["rel_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None,
        "launches_by_path": {path: n["k3w.launches"] for path, n in path_launches.items()},
        "at_unroll_cell": unroll_out["k3w"],
    })
    # K4, at tag_wm's b4,096 adversary lookup (phase 3); the JAX package
    # leaves its lookups to XLA
    k4_rows = {name.removeprefix("K4 "): k for name, k in kernels.items() if name.startswith("K4 ")}
    k = k4_rows["fixed [4096, 30, 64] bf16"]
    line.append({
        "name": "K4 lookup_grad", "ok": True, "route": "cuda", "source": "mfvae_tpu_torch/ops/csrc/lookup_grad.cu",
        "replaces": None, "launches": main_launches["k4.launches"], "max_rel_err": k["max_rel_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        "library_ms": k["library_ms"],
        "launches_by_path": {path: n["k4.launches"] for path, n in path_launches.items()},
        "at_b4096": k4_rows,
    })
    rk = kernels["K3_reward"]
    print(f"[27] K3 at the reward branch (n={b * a}): kernel {rk['ms']} ms plain {rk['plain_ms']} ms "
          f"library {rk['library_ms']} ms bound {rk['bound_ms']} ms launch floor {floor_ms} ms")
    print(f"[27] K3 at b4096's reward branch: {json.dumps(b4096_out['kernels_b4096']['K3_reward'])}")
    for label, w in walls.items():
        print(f"[27] per-epoch wall ms, {label}: {w}")
    print(f"[27] script wall {time.perf_counter() - t_script:.1f} s")
    print(smi)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
