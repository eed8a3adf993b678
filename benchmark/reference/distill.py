"""Behavior learned in imagination in plain PyTorch, in float32: the
distillation update of ``examples/behavior_policy.yaml``, followed for a
run's first updates.  Built on ``model.py``'s ``mean_forward`` and
``split_state`` and on ``train.py``'s ``Adam`` and ``Follow``; it imports
nothing of the program.

A decentralized policy learns inside the world model's imagination, as in
Dreamer (Hafner et al. 2019, arXiv:1912.01603), from a planning teacher
on the states its own actions visit, as in DAgger (Ross et al. 2011,
arXiv:1011.0686).  The P plan agents are simple_tag's adversaries, the
leading agents.  One update from S start states:

1. Visit.  The policy acts V steps in the world model's posterior-mean
   closed loop: each plan agent takes the argmax of its logits'
   log-softmax plus Gumbel noise, every other agent a uniform action; the
   predicted global state, split per agent, is the next observation.
2. Label.  The S·(1+V) states (the starts, then the visited states step
   by step) are each tiled M·K times; candidate m·K + a holds every plan
   agent at action a for all H steps (``hold``; ``random``: at a for the
   first step only, then at the shared draws) and the other agents at
   uniform actions shared by the K arms (common random numbers).  A plan
   agent's score is minus its distance to the nearest prey, read from its
   own predicted observation row, summed over the H steps; Q[s, p, a] is
   the mean over the M rollouts, and the targets are softmax(z / τ) of Q
   standardized over the arms (population std plus 1e-6).
3. Fit.  The policy (LayerNorm over the observation row, ReLU Dense
   layers, a Dense head of K logits, shared by the plan agents) descends
   the mean over states and plan agents of the cross-entropy to the
   targets by one Adam step.

Draws, from one generator, in this order an update: the start rows
``randperm(pool)[:S]``; the visit's Gumbel noise from ``rand(V, S, P,
K)`` and its uniform actions ``rand(V, S, A)``; the teacher's first
actions ``rand(S'·M, A)`` and continuation ``rand(H-1, S'·M, A)``, with
S' = S·(1+V).  A uniform action of n choices is ``min(floor(u·n), n -
1)``, a Gumbel draw ``-log(-log(max(u, tiny)))``.  The policy's layout is
the program's: ``norm.scale``, ``norm.bias``, then ``dense.<i>.kernel``
[in, out] and ``dense.<i>.bias``.

Departures from the program's arithmetic (``mfvae_tpu_torch/imagination.py``):

- the world model in float32, TF32 off, where the program computes in its
  ``compute_dtype`` (bfloat16) with float32 parameters; the policy is
  float32 on both sides;
- the visit takes the program's choices where they are handed in
  (``choices``): with random weights a plan agent's perturbed logits can
  tie within rounding, so the reference compares the logits behind the
  choice instead of the choice;
- the teacher runs ``BLOCK`` states (``BLOCK``·M·K rows) at once, so that
  its float32 activations fit; the program runs all S' at once.  Rows are
  independent, so only where the rows are computed differs;
- the LayerNorm's variance is the mean of squared deviations, the
  program's E[x²] - mean², clamped at 0;
- the prey's columns of an adversary's observation come from simple_tag's
  layout (own velocity and position, the landmarks, the other agents
  relative to it, adversaries first, then the good agents' velocities).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from benchmark.reference import model as M
from benchmark.reference import train as R

BLOCK = 16  # teacher states a block: 1,920 rows of the recipe's M·K, about 1 GB of float32 activations


class Noise(NamedTuple):
    """One update's draws."""

    rows: torch.Tensor  # [S] start rows of the pool
    gumbel: torch.Tensor  # [V, S, P, K]
    visit: torch.Tensor  # [V, S, A] uniform actions (the plan agents' are replaced)
    first: torch.Tensor  # [S'·M, A]
    cont: torch.Tensor  # [H-1, S'·M, A]


class Shape(NamedTuple):
    starts: int
    visit_steps: int
    m_rollouts: int
    arms: int
    horizon: int
    plan: int
    agents: int
    hold: bool
    temperature: float
    hidden: int  # the policy's hidden layers
    lr: float


def shape(conf: dict, spec: M.Spec) -> Shape:
    """The update's sizes from a configuration; any setting this reference
    does not implement raises."""
    b, e = conf["behavior"], conf["env"]
    fixed = {"algo": "distill", "plan_agents": "adversaries", "score": "prey_distance", "centralized": False}
    for key, want in fixed.items():
        if b[key] != want:
            raise NotImplementedError(f"the reference has no behavior.{key}={b[key]!r}")
    if b["continuation"] not in ("hold", "random"):
        raise NotImplementedError(f"the reference has no behavior.continuation={b['continuation']!r}")
    return Shape(min(b["n_starts"], b["start_pool"]), b["visit_steps"], b["m_rollouts"], spec.act_dims[0],
                 b["horizon"], e["num_adversaries"], spec.n, b["continuation"] == "hold", b["temperature"],
                 len(b["hidden"]), b["learning_rate"])


def uniform_actions(gen: torch.Generator, lead: Sequence[int], agents: int, n: int) -> torch.Tensor:
    u = torch.rand(*lead, agents, generator=gen, device=gen.device)
    return torch.clamp((u * n).to(torch.int32), max=n - 1)


def draw(gen: torch.Generator, pool_rows: int, sh: Shape) -> Noise:
    s, v, k = sh.starts, sh.visit_steps, sh.arms
    rows = torch.randperm(pool_rows, generator=gen, device=gen.device)[:s]
    u = torch.rand(v, s, sh.plan, k, generator=gen, device=gen.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))
    visit = uniform_actions(gen, (v, s), sh.agents, k)
    labelled = s * (1 + v)
    first = uniform_actions(gen, (labelled * sh.m_rollouts,), sh.agents, k)
    cont = uniform_actions(gen, (sh.horizon - 1, labelled * sh.m_rollouts), sh.agents, k)
    return Noise(rows, gumbel, visit, first, cont)


def policy_logits(pp: Dict[str, torch.Tensor], obs: torch.Tensor, hidden: int) -> torch.Tensor:
    x = M.layernorm(obs, pp["norm.scale"], pp["norm.bias"])
    for i in range(hidden):
        x = torch.relu(x @ pp[f"dense.{i}.kernel"] + pp[f"dense.{i}.bias"])
    return x @ pp[f"dense.{hidden}.kernel"] + pp[f"dense.{hidden}.bias"]


def prey_columns(e: dict) -> slice:
    """An adversary's observation columns holding the good agents' positions relative to it."""
    lo = 4 + 2 * e["num_obs"] + 2 * (e["num_adversaries"] - 1)
    return slice(lo, lo + 2 * e["num_good_agents"])


def prey_distance(conf: dict, spec: M.Spec, state: torch.Tensor, plan: int) -> torch.Tensor:
    """state [R, Σobs] -> [R, P]: each plan agent's distance to its nearest prey."""
    e = conf["env"]
    od, n_adv, n_good = spec.obs_dims[0], e["num_adversaries"], e["num_good_agents"]
    adv = state[:, : n_adv * od].reshape(state.shape[0], n_adv, od)
    rel = adv[..., prey_columns(e)].reshape(state.shape[0], n_adv, n_good, 2)
    return torch.amin(torch.sqrt(torch.sum(rel * rel, dim=-1) + 1e-12), dim=-1)[:, :plan]


def _step(p, conf: dict, spec: M.Spec, obs, actions: torch.Tensor, pr: M.Precision):
    """One posterior-mean world-model step of joint actions [B, A] -> next state [B, Σobs]."""
    per_group, lo = [], 0
    for _, idx in spec.groups:
        per_group.append(actions[:, lo:lo + len(idx)])
        lo += len(idx)
    return M.mean_forward(p, conf["model"], spec, obs, per_group, pr)[0]


def visit(p, conf: dict, spec: M.Spec, sh: Shape, pp, starts, noise: Noise, pr: M.Precision,
          choices: Optional[torch.Tensor] = None):
    """The visitation rollout -> (visited states [V, S, Σobs], the plan
    agents' actions [V, S, P]); ``choices`` [V, S, P] in place of its own."""
    obs, states, taken = list(starts), [], []
    for t in range(sh.visit_steps):
        with torch.no_grad():
            logp = torch.log_softmax(policy_logits(pp, obs[0][:, : sh.plan], sh.hidden), dim=-1)
            acts = torch.argmax(logp + noise.gumbel[t], dim=-1) if choices is None else choices[t].to(logp.device)
        full = torch.cat([acts.to(torch.int32), noise.visit[t][:, sh.plan:]], dim=1)
        state = _step(p, conf, spec, obs, full, pr)
        obs = M.split_state(spec, state)
        states.append(state)
        taken.append(acts)
    return torch.stack(states), torch.stack(taken)


@torch.no_grad()
def teacher_q(p, conf: dict, spec: M.Spec, sh: Shape, obs, noise: Noise, pr: M.Precision) -> torch.Tensor:
    """The enumerated teacher's Q [S', P, K] over the states ``obs`` (per group [S', A_g, od])."""
    m, k, h, plan = sh.m_rollouts, sh.arms, sh.horizon, sh.plan
    n = obs[0].shape[0]
    out = []
    for lo in range(0, n, BLOCK):
        hi = min(lo + BLOCK, n)
        cur = [o[lo:hi].repeat_interleave(m * k, dim=0) for o in obs]
        arm = torch.arange(k, device=cur[0].device).repeat((hi - lo) * m).to(torch.int32)
        first = noise.first[lo * m:hi * m].repeat_interleave(k, dim=0)
        first[:, :plan] = arm[:, None]
        cont = noise.cont[:, lo * m:hi * m].repeat_interleave(k, dim=1)
        if sh.hold:
            cont[:, :, :plan] = arm[None, :, None]
        score = torch.zeros(first.shape[0], plan, device=first.device)
        for t in range(h):
            state = _step(p, conf, spec, cur, first if t == 0 else cont[t - 1], pr)
            score -= prey_distance(conf, spec, state, plan)
            cur = M.split_state(spec, state)
        out.append(torch.mean(score.reshape(hi - lo, m, k, plan), dim=1).permute(0, 2, 1))
    return torch.cat(out)


def soft_targets(q: torch.Tensor, temperature: float) -> torch.Tensor:
    z = (q - torch.mean(q, dim=-1, keepdim=True)) / (torch.std(q, dim=-1, correction=0, keepdim=True) + 1e-6)
    return torch.softmax(z / temperature, dim=-1)


class Record:
    """What a followed run showed: per update the plan agents' visit
    actions [V, S, P], the labelled states (per group), Q, the targets and
    the policy's gradient; the first fit's logits [S', P, K]; the policy's
    first gradient and its weights after the last update (``follow``, a
    ``train.Follow``)."""

    def __init__(self, follow: R.Follow):
        self.follow = follow
        self.choices: List[torch.Tensor] = []
        self.labelled: List[tuple] = []
        self.q: List[torch.Tensor] = []
        self.targets: List[torch.Tensor] = []
        self.grads: List[Dict[str, torch.Tensor]] = []
        self.logits1: Optional[torch.Tensor] = None


def follow_updates(p: Dict[str, torch.Tensor], conf: dict, spec: M.Spec, pool, policy: Dict[str, torch.Tensor],
                   gen: torch.Generator, pr: M.Precision, updates: int = 3, choices=None,
                   half_batch: bool = False) -> Record:
    """The first ``updates`` distillation updates from the world model's
    weights ``p``, the start ``pool`` (per group [N, A_g, od]) and the
    policy's weights ``policy`` (copied), drawing from ``gen``.  The pool
    is the one input the program prepares (its env's states under its
    collection policy); the weights are the benchmark's own draws.
    ``choices`` (per update [V, S, P]) replace the visit's own argmax;
    ``half_batch`` (a fault the checks must catch) takes the
    cross-entropy's mean over the first half of the labelled states only."""
    sh = shape(conf, spec)
    pp = {k: v.detach().clone().to(torch.float32) for k, v in policy.items()}
    opt = R.Adam(pp, sh.lr)
    rec = Record(R.Follow(pp, updates))
    for i in range(updates):
        noise = draw(gen, pool[0].shape[0], sh)
        starts = [o[noise.rows] for o in pool]
        visited, taken = visit(p, conf, spec, sh, pp, starts, noise, pr, None if choices is None else choices[i])
        flat = visited.reshape(-1, visited.shape[-1])
        labelled = [torch.cat([o0, ov]) for o0, ov in zip(starts, M.split_state(spec, flat))]
        q = teacher_q(p, conf, spec, sh, labelled, noise, pr)
        tgt = soft_targets(q, sh.temperature)
        for v in pp.values():
            v.requires_grad_(True)
        logits = policy_logits(pp, labelled[0][:, : sh.plan], sh.hidden)
        nll = -torch.sum(tgt * torch.log_softmax(logits, dim=-1), dim=-1)  # [S', P]
        if half_batch:
            nll = nll[: nll.shape[0] // 2]
        grads = dict(zip(pp, torch.autograd.grad(torch.mean(nll), list(pp.values()))))
        for v in pp.values():
            v.requires_grad_(False)
        opt.step(pp, grads)
        rec.choices.append(taken)
        rec.labelled.append(tuple(labelled))
        rec.q.append(q)
        rec.targets.append(tgt)
        rec.grads.append(grads)
        if i == 0:
            rec.logits1 = logits.detach()
            rec.follow.first_grad = {k: g.detach().clone() for k, g in grads.items()}
    rec.follow.params_after = {k: v.detach().clone() for k, v in pp.items()}
    return rec
