"""Behavior learned inside the world model (mirror of
``mfvae_tpu/imagination.py``).

A decentralized policy is trained entirely inside ``WorldModel``
imagination, from real start states, and served as one forward pass per
env step:

- ``make_imagination_trainer``: REINFORCE over policy-in-the-loop imagined
  rollouts, with a per-start leave-one-mean baseline;
- ``make_actor_critic_trainer``: TD(λ) actor-critic (Dreamer's behavior
  learning), with a target critic, a symlog critic, the finite-horizon
  objective and a time feature as options;
- ``make_distillation_trainer``: DAgger-style distillation of a batched
  planning teacher (``make_enumerated_teacher``, ``make_cem_teacher``);
- ``make_policy_actor``: the trained policy under the planners' actor
  contract, over any leading axes of the stacked obs;
- ``make_selfplay_rollout``, ``make_selfplay_trainer``,
  ``make_team_actor``: both teams of a two-group scenario learn against
  each other inside the same world model (alternating best-response
  REINFORCE), and each team's policy is served on its own.

The networks keep flax's layouts (``models/layers.py``: Dense kernels
[in, out], LayerNorm epsilon 1e-6 with float32 statistics), so a JAX policy
tree maps onto them by name (``models/convert.py``).  In the port a
network's parameters live in its module, so a trainer returns ``(init_fn,
update_fn)``: ``init_fn`` draws the module's weights and returns it as
``params`` (a dict of modules for the actor-critic) with its Adam, and
``update_fn`` steps them in place and returns the metrics.  The JAX
factory names of the rollout, the teachers and the actor name their
classes.

The random draws are inputs, as in ``planning.py``: every rollout, teacher
and actor takes an explicit noise tuple or draws one from a
``torch.Generator``.  A categorical draw is argmax(logits + Gumbel noise),
as ``jax.random.categorical`` computes it; a Gaussian one takes standard
normal noise; the other agents act on uniform draws.  The tests hand in
JAX's own draws.

Gradients: with discrete actions they reach the policy through the
log-probs and entropies only; with continuous ones the reparameterized
actions also flow through the world model (``WorldModel._predict``, which
detaches its parameters) into the imagined states.  Distillation's
visitation rollout and every teacher run under ``torch.no_grad()``.

Tracing (``utils/profiling.py``): the span ``imagine.step`` holds each
world-model step of ``ImaginationRollout`` and of the teachers' closed
loop (``_imagine``): its ``WorldModel._predict`` and the refeed of the
predicted state.  Each such step counts ``imagine.steps`` once and
``imagine.rows`` by its batch rows; each teacher call counts
``teacher.calls``.  A distillation update is the span
``behavior.update``, holding ``distill.visit`` (the visitation rollout),
``distill.teacher`` (the labels) and ``distill.fit`` (the policy's
forward, the cross-entropy and the Adam step).
"""

from __future__ import annotations

import contextlib
import copy
import math
import warnings
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mfvae_tpu_torch.models.layers import Dense, LayerNorm, lecun_normal_
from mfvae_tpu_torch.models.mavae import AgentSpec, GroupedBatch
from mfvae_tpu_torch.training.trainer import make_action_sampler, stacked_to_grouped
from mfvae_tpu_torch.utils.profiling import count, span

NEG_INF = torch.finfo(torch.float32).min


def _gumbel(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))


# ------------------------------------------------------------------ networks
class _RowMLP(nn.Module):
    """LayerNorm over an observation row, ReLU Dense layers of ``hidden``
    widths, then one Dense head per entry of ``heads``.  flax names them
    ``LayerNorm_0`` and ``Dense_0..``; here they are ``norm`` and
    ``dense.0..``.  Without a generator the kernels start at zero, for a
    module whose weights are loaded or drawn later (``reset_parameters``)."""

    def __init__(self, obs_dim: int, hidden: Sequence[int], heads: Sequence[int], device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.obs_dim = int(obs_dim)
        self.hidden = tuple(int(h) for h in hidden)
        self.norm = LayerNorm(self.obs_dim, device=device)
        widths = [self.obs_dim, *self.hidden]
        self.dense = nn.ModuleList(
            [Dense(widths[i], h, device=device, kernel_init="zeros") for i, h in enumerate(self.hidden)]
            + [Dense(widths[-1], k, device=device, kernel_init="zeros") for k in heads]
        )
        if generator is not None:
            self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's init: lecun-normal kernels drawn in layer order, zero
        biases, a unit LayerNorm."""
        with torch.no_grad():
            self.norm.scale.fill_(1.0)
            self.norm.bias.zero_()
            for layer in self.dense:
                lecun_normal_(layer.kernel, layer.kernel.shape[0], generator)
                layer.bias.zero_()

    def trunk(self, obs: torch.Tensor) -> torch.Tensor:
        x = self.norm(obs.to(torch.float32))
        for layer in self.dense[: len(self.hidden)]:
            x = torch.relu(layer(x))
        return x


class PolicyMLP(_RowMLP):
    """Per-agent decentralized policy: own observation row -> action
    logits, shared across the (homogeneous) plan agents, so one call
    covers [..., P, obs_dim]."""

    def __init__(self, obs_dim: int, hidden: Sequence[int] = (128, 128), act_dim: int = 5, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(obs_dim, hidden, (act_dim,), device, generator)
        self.act_dim = int(act_dim)

    def forward(self, obs):
        return self.dense[-1](self.trunk(obs))


class GaussianPolicyMLP(_RowMLP):
    """Continuous-action policy: obs row -> (mu, log_std) of a pre-squash
    Gaussian, log_std clipped to [log_std_min, log_std_max]; actions are
    tanh-squashed onto the env's Box bounds (``tanh_gaussian_sample``)."""

    def __init__(self, obs_dim: int, hidden: Sequence[int] = (128, 128), act_dim: int = 5, device=None,
                 generator: Optional[torch.Generator] = None, log_std_min: float = -5.0,
                 log_std_max: float = 1.0):
        super().__init__(obs_dim, hidden, (act_dim, act_dim), device, generator)
        self.act_dim = int(act_dim)
        self.log_std_min, self.log_std_max = log_std_min, log_std_max

    def forward(self, obs):
        x = self.trunk(obs)
        mu = self.dense[-2](x)
        log_std = torch.clamp(self.dense[-1](x), self.log_std_min, self.log_std_max)
        return mu, log_std


class ValueMLP(_RowMLP):
    """Per-agent value head: own observation row -> scalar V̂."""

    def __init__(self, obs_dim: int, hidden: Sequence[int] = (128, 128), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(obs_dim, hidden, (1,), device, generator)

    def forward(self, obs):
        return self.dense[-1](self.trunk(obs))[..., 0]


def _tanh_affine(u, lo: float, hi: float):
    return lo + (hi - lo) * 0.5 * (torch.tanh(u) + 1.0)


def tanh_gaussian_sample(mu, log_std, noise, lo: float, hi: float):
    """a = affine(tanh(u)), u = mu + std·noise with ``noise`` standard
    normal [..., d]; returns (a, logp) with the change-of-variables
    correction summed over the action dims."""
    std = torch.exp(log_std)
    u = mu + std * noise
    a = _tanh_affine(u, lo, hi)
    base = -0.5 * (((u - mu) / std) ** 2 + 2.0 * log_std + math.log(2 * math.pi))
    # d a / d u = (hi-lo)/2 * (1 - tanh(u)^2), in its numerically stable form
    log_jac = math.log((hi - lo) * 0.5) + 2.0 * (math.log(2.0) - u - F.softplus(-2.0 * u))
    return a, torch.sum(base - log_jac, dim=-1)


def gaussian_entropy(log_std):
    """Pre-squash Gaussian entropy summed over the action dims."""
    return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e), dim=-1)


def _box_bounds(env) -> Tuple[float, float]:
    space = env.action_space(env.agents[0])
    return float(space.low), float(space.high)


def _plan_prefix(spec: AgentSpec, plan_agents: Sequence[int]) -> int:
    """The plan agents must be the leading prefix of group 0 (every
    adversary team here: agents 0..P-1 share the adversary dims)."""
    p = len(plan_agents)
    if tuple(plan_agents) != tuple(range(p)):
        raise ValueError("plan_agents must be the leading agent prefix (0..P-1)")
    if tuple(spec.groups[0][1][:p]) != tuple(range(p)):
        raise ValueError("plan agents must sit at the head of spec group 0")
    return p


def make_obs_builder(spec: AgentSpec, plan_agents: Sequence[int], centralized: bool = False
                     ) -> Tuple[Callable, int]:
    """Policy-input builder ``obs_fn(obs_g) -> [B, P, D]`` and D.

    Decentralized (the default): each plan agent's own observation row,
    D = obs_dims[0].  ``centralized=True`` appends the full flattened joint
    observation (every agent's row, all groups) to each agent's own row,
    D = obs_dims[0] + Σ obs_dims; serving it needs the joint observation at
    execution time."""
    p = _plan_prefix(spec, plan_agents)
    od0 = int(spec.obs_dims[0])
    if not centralized:
        return (lambda obs_g: obs_g[0][:, :p]), od0
    joint_dim = int(sum(spec.obs_dims))

    def obs_fn(obs_g):
        b = obs_g[0].shape[0]
        joint = torch.cat([o.reshape(b, -1) for o in obs_g], dim=-1)  # [B, Σobs]
        joint = joint[:, None, :].expand(b, p, joint_dim)
        return torch.cat([obs_g[0][:, :p], joint], dim=-1)

    return obs_fn, od0 + joint_dim


def _policy_for(env, obs_dim: int, hidden, act_dim: int) -> _RowMLP:
    cls = PolicyMLP if getattr(env, "discrete_actions", True) else GaussianPolicyMLP
    return cls(obs_dim, hidden, act_dim, device=env.device)


def _prefix_sum_score(p: int):
    """The default score: each plan agent's predicted-reward sum [B, P]."""
    def score_fn(states, rewards):
        return torch.sum(rewards[..., :p], dim=0)

    return score_fn


def _adam_step(opt: torch.optim.Optimizer, loss: torch.Tensor) -> None:
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()


# ------------------------------------------------------------------ rollout
class ImaginationNoise(NamedTuple):
    """The draws of one policy-in-the-loop rollout of H steps over B rows."""

    policy: torch.Tensor  # [H, B, P, K] Gumbel noise (discrete) or [H, B, P, d] standard normal (Box)
    others: torch.Tensor  # [H, B, A(, d)] every agent's uniform action; the plan agents' are overwritten


class ImaginationRollout:
    """Policy-in-the-loop imagination: ``rollout(policy, obs_g,
    generator=None, noise=None) -> (states [H, B, Σobs], rewards
    [H, B, A], logp [H, B, P], ent [H, B, P])`` from per-group start obs
    [B, A_g, od].  ``obs_fn`` maps the grouped obs to the policy's input
    rows [B, P, D] (default: each plan agent's own row).  The non-plan
    agents act uniformly at random, as the eval harness's opponents do."""

    def __init__(self, wm, env, spec: AgentSpec, plan_agents: Sequence[int], horizon: int = 8,
                 obs_fn: Optional[Callable] = None):
        self.wm, self.horizon = wm, horizon
        self.sample_actions, self.group_actions = make_action_sampler(env, spec)
        self.p = _plan_prefix(spec, plan_agents)
        self.obs_fn = obs_fn if obs_fn is not None else make_obs_builder(spec, plan_agents)[0]
        self.discrete = getattr(env, "discrete_actions", True)
        self.bounds = None if self.discrete else _box_bounds(env)
        self.act_dim = int(spec.act_dims[0])
        self.device = env.device

    def draw_noise(self, generator: Optional[torch.Generator], b: int) -> ImaginationNoise:
        shape = (self.horizon, b, self.p, self.act_dim)
        if self.discrete:
            pol = _gumbel(shape, generator, self.device)
        else:
            pol = torch.randn(shape, generator=generator, device=self.device)
        return ImaginationNoise(pol, self.sample_actions(generator, (self.horizon, b)))

    def __call__(self, policy, obs_g, generator: Optional[torch.Generator] = None,
                 noise: Optional[ImaginationNoise] = None):
        if noise is None:
            noise = self.draw_noise(generator, obs_g[0].shape[0])
        carry = tuple(obs_g)
        states, rewards, logps, ents = [], [], [], []
        for t in range(self.horizon):
            rows = self.obs_fn(carry)
            if self.discrete:
                logits = torch.log_softmax(policy(rows), dim=-1)  # [B, P, K]
                acts_p = torch.argmax(logits + noise.policy[t], dim=-1)
                logp = logits.gather(-1, acts_p.unsqueeze(-1)).squeeze(-1)
                ent = -torch.sum(torch.exp(logits) * logits, dim=-1)
            else:
                mu, log_std = policy(rows)
                acts_p, logp = tanh_gaussian_sample(mu, log_std, noise.policy[t], *self.bounds)
                ent = gaussian_entropy(log_std)
            others = noise.others[t]
            full = torch.cat([acts_p.to(others.dtype), others[:, self.p:]], dim=1)  # [B, A(, d)]
            with span("imagine.step"):
                ns, rw = self.wm._predict(GroupedBatch(obs=carry, actions=self.group_actions(full)))
                carry = self.wm._state_to_grouped(ns)
            _count_step(ns)
            states.append(ns)
            rewards.append(rw)
            logps.append(logp)
            ents.append(ent)
        return torch.stack(states), torch.stack(rewards), torch.stack(logps), torch.stack(ents)


make_imagination_rollout = ImaginationRollout


def _tile(obs_starts_g, n: int):
    """Each start n times in a row: [S, ...] -> [S·n, ...] (``jnp.repeat``)."""
    return tuple(o.repeat_interleave(n, dim=0) for o in obs_starts_g)


# ---------------------------------------------------------------- REINFORCE
def make_imagination_trainer(
    wm,
    env,
    spec: AgentSpec,
    plan_agents: Sequence[int],
    score_fn: Optional[Callable] = None,
    horizon: int = 8,
    n_rollouts: int = 16,
    learning_rate: float = 3e-4,
    entropy_coef: float = 1e-2,
    hidden: Tuple[int, ...] = (128, 128),
    centralized: bool = False,
):
    """REINFORCE over imagined futures.

    ``score_fn(states [H, B, Σobs], rewards [H, B, A]) -> [B, P]`` scores
    each plan agent (default: its predicted-reward sum).  Each update tiles
    the S start states ``n_rollouts`` times, imagines S·N futures under the
    current policy and ascends the score: advantage = score minus the
    per-start mean over the N rollouts, over their population std, times
    the trajectory log-prob, plus an entropy bonus.

    Returns ``(init_fn, update_fn)``:
      init_fn(generator) -> (params, opt): the policy module, its weights
        drawn from ``generator``, and an Adam over them;
      update_fn(params, opt, obs_starts_g, generator=None, noise=None)
        -> metrics, after one Adam step on ``params`` in place:
        obs_starts_g per group [S, A_g, od]; ``noise`` is the rollout's
        ``ImaginationNoise`` over S·N rows."""
    p = _plan_prefix(spec, plan_agents)
    obs_fn, obs_dim = make_obs_builder(spec, plan_agents, centralized)
    policy = _policy_for(env, obs_dim, hidden, int(spec.act_dims[0]))
    rollout = ImaginationRollout(wm, env, spec, plan_agents, horizon, obs_fn=obs_fn)
    if score_fn is None:
        score_fn = _prefix_sum_score(p)

    def init_fn(generator: torch.Generator):
        policy.reset_parameters(generator)
        return policy, torch.optim.Adam(policy.parameters(), lr=learning_rate)

    def update_fn(params, opt, obs_starts_g, generator: Optional[torch.Generator] = None,
                  noise: Optional[ImaginationNoise] = None):
        states, rewards, logp, ent = rollout(params, _tile(obs_starts_g, n_rollouts), generator, noise)
        score = score_fn(states, rewards)  # [S·N, P]
        s = score.shape[0] // n_rollouts
        score = score.reshape(s, n_rollouts, p)
        adv = score - torch.mean(score, dim=1, keepdim=True)
        adv = adv / (torch.std(score, dim=1, correction=0, keepdim=True) + 1e-6)
        logp_sum = torch.sum(logp, dim=0).reshape(s, n_rollouts, p)
        pg = -torch.mean(adv.detach() * logp_sum)
        ent_mean = torch.mean(ent)
        _adam_step(opt, pg - entropy_coef * ent_mean)
        return {
            "score_mean": torch.mean(score).detach(),
            "entropy": ent_mean.detach(),
            "pg_loss": pg.detach(),
        }

    return init_fn, update_fn


# ------------------------------------------------------------- actor-critic
def symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    return torch.sign(x) * torch.expm1(torch.abs(x))


def lambda_returns(rewards, values_next, gamma: float, lam: float):
    """TD(λ) targets, from the end: ``rewards`` [H, ...] = r_t,
    ``values_next`` [H, ...] = V̂(s_{t+1}) (the last one bootstraps past the
    horizon).  G_t = r_t + γ[(1-λ)·V̂(s_{t+1}) + λ·G_{t+1}], G_{H-1} =
    r_{H-1} + γ·V̂(s_H)."""
    g = rewards[-1] + gamma * values_next[-1]
    out = [g]
    for t in range(rewards.shape[0] - 2, -1, -1):
        g = rewards[t] + gamma * ((1.0 - lam) * values_next[t] + lam * g)
        out.append(g)
    return torch.stack(out[::-1])


def _huber(pred, target, delta: float = 1.0):
    """optax.huber_loss, elementwise."""
    abs_err = torch.abs(pred - target)
    quad = torch.clamp(abs_err, max=delta)
    return 0.5 * quad ** 2 + delta * (abs_err - quad)


def make_actor_critic_trainer(
    wm,
    env,
    spec: AgentSpec,
    plan_agents: Sequence[int],
    step_score_fn: Optional[Callable] = None,
    horizon: int = 8,
    n_rollouts: int = 16,
    learning_rate: float = 3e-4,
    entropy_coef: float = 1e-2,
    value_coef: float = 0.5,
    gamma: float = 0.95,
    lam: float = 0.95,
    hidden: Tuple[int, ...] = (128, 128),
    target_ema: float = 0.0,
    critic_symlog: bool = False,
    bootstrap_tail: bool = True,
    critic_time_feature: bool = False,
    centralized: bool = False,
):
    """Dreamer-style actor-critic inside imagination.

    Per update: the policy-in-the-loop rollout from the tiled start states;
    per-step per-agent rewards ``step_score_fn(states, rewards) -> [H, B,
    P]`` (default: the plan agents' predicted-reward columns); TD(λ)
    targets bootstrapped from the critic; REINFORCE on batch-normalized
    advantages, an entropy bonus and a Huber critic regression, one Adam
    over both networks.

    ``target_ema > 0`` bootstraps and baselines from a target critic, the
    EMA of the online one at that rate, updated after each Adam step; it is
    not in the optimizer (its gradient is identically zero in the JAX
    package, where Adam leaves it alone).  ``critic_symlog`` regresses the
    critic on symlog(G) and decodes with symexp.  ``bootstrap_tail=False``
    zeroes γ·V̂(s_H), the finite-horizon objective; with ``lam < 1`` the
    (1-λ)·V̂ terms still bootstrap (warned).  ``critic_time_feature``
    appends the normalized time remaining (H-t)/H to the critic's input.

    Returns ``(init_fn, update_fn)``; ``init_fn(generator) -> (params,
    opt)`` with params = {'pi', 'v'} (+ 'v_target'), the policy drawn
    before the critic; ``update_fn`` as in ``make_imagination_trainer``, so
    ``make_policy_actor`` serves params['pi']."""
    if not bootstrap_tail and lam < 1.0:
        warnings.warn(
            "bootstrap_tail=False with lam<1 is NOT the pure finite-"
            "horizon objective: intermediate (1-lam)*V terms still "
            "bootstrap from the critic. Set lam=1 for the Monte-Carlo "
            "finite-H return (the spread-study MC arm does)."
        )
    p = _plan_prefix(spec, plan_agents)
    obs_fn, obs_dim = make_obs_builder(spec, plan_agents, centralized)
    policy = _policy_for(env, obs_dim, hidden, int(spec.act_dims[0]))
    value = ValueMLP(obs_dim + int(critic_time_feature), hidden, device=env.device)
    rollout = ImaginationRollout(wm, env, spec, plan_agents, horizon, obs_fn=obs_fn)
    if step_score_fn is None:
        def step_score_fn(states, rewards):
            return rewards[..., :p]  # [H, B, P]

    def critic_obs(obs_seq):
        # [H+1, B, P, D] -> with the normalized time remaining appended:
        # 1 at the start state, 0 at the horizon's last
        if not critic_time_feature:
            return obs_seq
        hp1 = obs_seq.shape[0]
        tr = torch.arange(hp1 - 1, -1, -1, dtype=obs_seq.dtype, device=obs_seq.device) / max(hp1 - 1, 1)
        tr = tr[:, None, None, None].expand(*obs_seq.shape[:-1], 1)
        return torch.cat([obs_seq, tr], dim=-1)

    decode = symexp if critic_symlog else (lambda x: x)

    def init_fn(generator: torch.Generator):
        policy.reset_parameters(generator)
        value.reset_parameters(generator)
        params = {"pi": policy, "v": value}
        if target_ema > 0.0:
            params["v_target"] = copy.deepcopy(value).requires_grad_(False)
        opt = torch.optim.Adam([*policy.parameters(), *value.parameters()], lr=learning_rate)
        return params, opt

    def update_fn(params, opt, obs_starts_g, generator: Optional[torch.Generator] = None,
                  noise: Optional[ImaginationNoise] = None):
        obs_g = _tile(obs_starts_g, n_rollouts)
        states, rewards, logp, ent = rollout(params["pi"], obs_g, generator, noise)
        h, b = states.shape[:2]
        r = step_score_fn(states, rewards)  # [H, B, P]
        obs0 = obs_fn(obs_g)  # [B, P, D]
        obs_next = obs_fn(wm._state_to_grouped(states.reshape(h * b, -1))).reshape(h, b, p, -1)
        obs_seq = critic_obs(torch.cat([obs0[None], obs_next], dim=0))
        v_raw = params["v"](obs_seq)  # [H+1, B, P]
        v_all = decode(v_raw)
        v_boot = v_all
        if target_ema > 0.0:
            with torch.no_grad():
                v_boot = decode(params["v_target"](obs_seq))
        v_next = v_boot[1:]
        if not bootstrap_tail:
            v_next = torch.cat([v_next[:-1], torch.zeros_like(v_next[-1:])], dim=0)
        g = lambda_returns(r, v_next.detach(), gamma, lam).detach()
        adv = (g - v_boot[:-1]).detach()
        adv = (adv - torch.mean(adv)) / (torch.std(adv, correction=0) + 1e-6)
        pg = -torch.mean(adv * logp)
        if critic_symlog:
            v_loss = torch.mean(_huber(v_raw[:-1], symlog(g)))
        else:
            v_loss = torch.mean(_huber(v_all[:-1], g))
        ent_mean = torch.mean(ent)
        _adam_step(opt, pg + value_coef * v_loss - entropy_coef * ent_mean)
        if target_ema > 0.0:
            with torch.no_grad():
                for tgt, online in zip(params["v_target"].parameters(), params["v"].parameters()):
                    tgt.copy_((1.0 - target_ema) * tgt + target_ema * online)
        return {
            "score_mean": torch.mean(r).detach(),
            "return_mean": torch.mean(g),
            "value_loss": v_loss.detach(),
            "pg_loss": pg.detach(),
            "entropy": ent_mean.detach(),
        }

    return init_fn, update_fn


# ----------------------------------------------------------------- teachers
def _count_step(ns: torch.Tensor) -> None:
    """One imagined world-model step of ``ns.shape[0]`` rows."""
    count("imagine.steps")
    count("imagine.rows", ns.shape[0])


def _imagine(wm, group_actions, obs_g, full_plan):
    """Closed-loop imagination of joint plans [H, B, A] from per-group obs
    [B, A_g, od]: (states [H, B, Σobs], rewards [H, B, A])."""
    states, rewards = [], []
    carry = tuple(obs_g)
    for acts_t in full_plan:
        with span("imagine.step"):
            ns, rw = wm._predict(GroupedBatch(obs=carry, actions=group_actions(acts_t)))
            carry = wm._state_to_grouped(ns)
        _count_step(ns)
        states.append(ns)
        rewards.append(rw)
    return torch.stack(states), torch.stack(rewards)


class CEMTeacherNoise(NamedTuple):
    """The draws of one batched CEM teacher call over S states."""

    gumbel: List[torch.Tensor]  # per iteration [S, H, N, P, K]; empty for the soft teacher
    others: List[torch.Tensor]  # per iteration [H, S·N, A] uniform actions; one for the soft teacher


class CEMTeacher:
    """Batched CEM planning for distillation targets: ``teacher(obs_g,
    generator=None, noise=None) -> [S, P]`` expert first actions, each of
    the S states with its own ``n_candidates``-way tournament refit over
    ``iters`` rounds of per-(step, agent) categoricals.  Ties among the
    elites and the best go to the lower candidate, as ``lax.top_k`` and
    ``argmax`` break them.

    ``soft_temperature`` makes it one uniform-shooting round (``iters``
    unused) whose per-(state, agent) standardized scores weigh the
    candidates' first actions (softmax at that temperature):
    ``-> [S, P, K]`` first-action distributions."""

    def __init__(self, wm, env, spec: AgentSpec, plan_agents: Sequence[int], score_fn=None,
                 horizon: int = 8, n_candidates: int = 64, iters: int = 2, elite_frac: float = 0.125,
                 soft_temperature: Optional[float] = None):
        if not getattr(env, "discrete_actions", True):
            raise ValueError(
                "the CEM teacher refits per-action categoricals (discrete only); "
                "use the REINFORCE/actor-critic trainers for continuous envs"
            )
        self.wm, self.horizon, self.n, self.iters = wm, horizon, n_candidates, iters
        self.sample_actions, self.group_actions = make_action_sampler(env, spec)
        self.p = _plan_prefix(spec, plan_agents)
        self.n_elite = max(int(n_candidates * elite_frac), 1)
        self.k = int(max(spec.act_dims))
        self.device = env.device
        act_dims = torch.tensor(spec.act_dims[: self.p], device=env.device)
        self.valid = torch.arange(self.k, device=env.device)[None, :] < act_dims[:, None]  # [P, K]
        self.score_fn = score_fn if score_fn is not None else _prefix_sum_score(self.p)
        self.tau = None if soft_temperature is None else float(soft_temperature)

    def draw_noise(self, generator: Optional[torch.Generator], s: int) -> CEMTeacherNoise:
        if self.tau is not None:
            return CEMTeacherNoise([], [self.sample_actions(generator, (self.horizon, s * self.n))])
        gumbel, others = [], []
        for _ in range(self.iters):
            gumbel.append(_gumbel((s, self.horizon, self.n, self.p, self.k), generator, self.device))
            others.append(self.sample_actions(generator, (self.horizon, s * self.n)))
        return CEMTeacherNoise(gumbel, others)

    @torch.no_grad()
    def __call__(self, obs_g, generator: Optional[torch.Generator] = None,
                 noise: Optional[CEMTeacherNoise] = None):
        s, h, n, p, k = obs_g[0].shape[0], self.horizon, self.n, self.p, self.k
        count("teacher.calls")
        if noise is None:
            noise = self.draw_noise(generator, s)
        obs_t = _tile(obs_g, n)
        if self.tau is not None:
            full = noise.others[0]
            scores = self.score_fn(*_imagine(self.wm, self.group_actions, obs_t, full)).reshape(s, n, p)
            z = (scores - torch.mean(scores, dim=1, keepdim=True)) / (
                torch.std(scores, dim=1, correction=0, keepdim=True) + 1e-6
            )
            w = torch.softmax(z / self.tau, dim=1)  # [S, N, P]
            first = full[0][:, :p].reshape(s, n, p)
            onehot = F.one_hot(first.long(), k).to(w.dtype)  # [S, N, P, K]
            return torch.einsum("snp,snpk->spk", w, onehot)
        logits = torch.where(self.valid, 0.0, NEG_INF).expand(s, h, p, k)
        best_score = torch.full((s, p), NEG_INF, device=self.device)
        best_first = torch.zeros((s, p), dtype=torch.long, device=self.device)
        for i in range(self.iters):
            # [S, H, N, P] draws from each state's current categoricals
            plan_acts = torch.argmax(logits[:, :, None] + noise.gumbel[i], dim=-1)
            full = noise.others[i].clone()
            full[:, :, :p] = plan_acts.permute(1, 0, 2, 3).reshape(h, s * n, p).to(full.dtype)
            scores = self.score_fn(*_imagine(self.wm, self.group_actions, obs_t, full)).reshape(s, n, p)
            # per-(state, agent) elites -> refit that agent's categoricals
            elite = torch.sort(scores.permute(0, 2, 1), dim=-1, descending=True, stable=True).indices
            elite = elite[..., : self.n_elite]  # [S, P, E]
            elite_acts = plan_acts.permute(0, 1, 3, 2).gather(
                3, elite[:, None].expand(s, h, p, self.n_elite)
            )  # [S, H, P, E]
            counts = F.one_hot(elite_acts, k).sum(dim=3).to(torch.float32)  # [S, H, P, K]
            logits = torch.where(self.valid, torch.log(counts / self.n_elite + 1e-4), NEG_INF)
            col_best = torch.amax(scores, dim=1)  # [S, P]
            col_arg = torch.argmax(scores, dim=1)
            first = plan_acts[:, 0].gather(1, col_arg[:, None, :]).squeeze(1)  # [S, P]
            improved = col_best > best_score
            best_score = torch.where(improved, col_best, best_score)
            best_first = torch.where(improved, first, best_first)
        return best_first


make_cem_teacher = CEMTeacher


class EnumeratedNoise(NamedTuple):
    """The draws of one enumerated-teacher call over S states, shared by
    the K arms (common random numbers)."""

    first: torch.Tensor  # [S·M, A] every agent's uniform first action
    cont: torch.Tensor  # [H-1, S·M, A] the continuation's


class EnumeratedTeacher:
    """First-action Q by enumeration + common random numbers:

      for each action a in 0..K-1, roll M futures where every plan agent's
      first action is a and steps 1..H-1 are ``continuation`` actions
      shared across the K arms (``'hold'``: each plan agent repeats a;
      ``'random'``: shared uniform draws); non-plan agents are uniform and
      shared too.  Q[s, p, a] = mean over m of the score; the targets are
      the softmax over a of per-(state, agent) standardized Q over
      ``temperature``.

    Candidate index = m·K + a, a fastest.  ``teacher(obs_g, generator=None,
    noise=None) -> [S, P, K]`` targets, or (targets, Q) with
    ``return_q``."""

    def __init__(self, wm, env, spec: AgentSpec, plan_agents: Sequence[int], score_fn=None,
                 horizon: int = 8, m_rollouts: int = 24, temperature: float = 0.5,
                 continuation: str = "hold", return_q: bool = False):
        if continuation not in ("hold", "random"):
            raise ValueError(f"unknown continuation {continuation!r} (expected 'hold' or 'random')")
        if not getattr(env, "discrete_actions", True):
            raise ValueError(
                "the enumerated teacher enumerates a finite action set (discrete "
                "only); use the REINFORCE/actor-critic trainers for continuous envs"
            )
        self.p = _plan_prefix(spec, plan_agents)
        act_dims = set(int(d) for d in spec.act_dims[: self.p])
        if len(act_dims) != 1:
            raise ValueError("enumerated teacher needs homogeneous plan-agent action spaces")
        self.k = act_dims.pop()
        self.wm, self.horizon, self.m = wm, horizon, m_rollouts
        self.temperature, self.hold, self.return_q = temperature, continuation == "hold", return_q
        self.sample_actions, self.group_actions = make_action_sampler(env, spec)
        self.score_fn = score_fn if score_fn is not None else _prefix_sum_score(self.p)
        self.device = env.device

    def draw_noise(self, generator: Optional[torch.Generator], s: int) -> EnumeratedNoise:
        return EnumeratedNoise(
            self.sample_actions(generator, (s * self.m,)),
            self.sample_actions(generator, (self.horizon - 1, s * self.m)),
        )

    @torch.no_grad()
    def __call__(self, obs_g, generator: Optional[torch.Generator] = None,
                 noise: Optional[EnumeratedNoise] = None):
        s, m, k, p = obs_g[0].shape[0], self.m, self.k, self.p
        count("teacher.calls")
        if noise is None:
            noise = self.draw_noise(generator, s)
        first = noise.first.repeat_interleave(k, dim=0)  # [S·M·K, A]
        cont = noise.cont.repeat_interleave(k, dim=1)  # [H-1, S·M·K, A]
        arm = torch.arange(k, dtype=first.dtype, device=first.device).repeat(s * m)  # [S·M·K]
        first[:, :p] = arm[:, None]
        if self.hold:
            cont[:, :, :p] = arm[None, :, None]
        full = torch.cat([first[None], cont], dim=0)  # [H, S·M·K, A]
        states, rewards = _imagine(self.wm, self.group_actions, _tile(obs_g, m * k), full)
        scores = self.score_fn(states, rewards).reshape(s, m, k, p)
        q = torch.mean(scores, dim=1).permute(0, 2, 1)  # [S, P, K]
        z = (q - torch.mean(q, dim=-1, keepdim=True)) / (torch.std(q, dim=-1, correction=0, keepdim=True) + 1e-6)
        targets = torch.softmax(z / self.temperature, dim=-1)
        return (targets, q) if self.return_q else targets


make_enumerated_teacher = EnumeratedTeacher


# ------------------------------------------------------------- distillation
class DistillNoise(NamedTuple):
    """The draws of one distillation update over S starts."""

    visit: ImaginationNoise  # the visitation rollout over the S starts
    teacher: object  # EnumeratedNoise or CEMTeacherNoise over the S·(1+visit_steps) states


def make_distillation_trainer(
    wm,
    env,
    spec: AgentSpec,
    plan_agents: Sequence[int],
    score_fn: Optional[Callable] = None,
    horizon: int = 8,
    n_candidates: int = 64,
    cem_iters: int = 2,
    elite_frac: float = 0.125,
    visit_steps: int = 3,
    learning_rate: float = 3e-4,
    hidden: Tuple[int, ...] = (128, 128),
    target_mode: str = "argmax",
    temperature: float = 0.5,
    teacher_mode: str = "cem",
    m_rollouts: int = 24,
    continuation: str = "hold",
    centralized: bool = False,
):
    """DAgger-style planner distillation inside imagination.  Each update

      1. rolls the current policy ``visit_steps`` steps from the start
         states (on-policy visitation), with no gradient;
      2. labels every start and visited state with the teacher: CEM
         argmax labels, CEM soft targets (``target_mode='soft'``) or the
         enumerated teacher (``teacher_mode='enumerated'``, soft targets);
      3. descends the cross-entropy of the policy's logits to the labels.

    Returns ``(init_fn, update_fn)`` with the REINFORCE trainer's
    surface; ``noise`` is a ``DistillNoise``.  An update is the span
    ``behavior.update`` around ``distill.visit``, ``distill.teacher`` and
    ``distill.fit`` (module docstring)."""
    if target_mode not in ("argmax", "soft"):
        raise ValueError(f"unknown target_mode {target_mode!r}")
    if teacher_mode not in ("cem", "enumerated"):
        raise ValueError(f"unknown teacher_mode {teacher_mode!r}")
    if teacher_mode == "enumerated":
        target_mode = "soft"
    obs_fn, obs_dim = make_obs_builder(spec, plan_agents, centralized)
    policy = PolicyMLP(obs_dim, hidden, int(spec.act_dims[0]), device=env.device)
    rollout = ImaginationRollout(wm, env, spec, plan_agents, visit_steps, obs_fn=obs_fn)
    if teacher_mode == "enumerated":
        teacher = EnumeratedTeacher(wm, env, spec, plan_agents, score_fn, horizon, m_rollouts, temperature,
                                    continuation)
    else:
        teacher = CEMTeacher(wm, env, spec, plan_agents, score_fn, horizon, n_candidates, cem_iters, elite_frac,
                             temperature if target_mode == "soft" else None)

    def init_fn(generator: torch.Generator):
        policy.reset_parameters(generator)
        return policy, torch.optim.Adam(policy.parameters(), lr=learning_rate)

    def update_fn(params, opt, obs_starts_g, generator: Optional[torch.Generator] = None,
                  noise: Optional[DistillNoise] = None):
        with span("behavior.update"):
            s = obs_starts_g[0].shape[0]
            if noise is None:
                noise = DistillNoise(rollout.draw_noise(generator, s),
                                     teacher.draw_noise(generator, s * (1 + visit_steps)))
            with torch.no_grad():
                with span("distill.visit"):
                    states, *_ = rollout(params, obs_starts_g, noise=noise.visit)
                    visited_g = wm._state_to_grouped(states.reshape(visit_steps * s, -1))
                    all_obs_g = tuple(torch.cat([o0, ov], dim=0) for o0, ov in zip(obs_starts_g, visited_g))
                with span("distill.teacher"):
                    targets = teacher(all_obs_g, noise=noise.teacher)  # [B, P] labels or [B, P, K]
                    hard = targets if target_mode == "argmax" else torch.argmax(targets, dim=-1)
            with span("distill.fit"):
                logits = params(obs_fn(all_obs_g))  # [B, P, K]
                logp = torch.log_softmax(logits, dim=-1)
                if target_mode == "argmax":
                    nll = -logp.gather(-1, targets.long().unsqueeze(-1)).squeeze(-1)
                else:
                    nll = -torch.sum(targets * logp, dim=-1)  # [B, P]
                loss = torch.mean(nll)
                _adam_step(opt, loss)
            with torch.no_grad():
                agree = torch.mean((torch.argmax(logits, dim=-1) == hard).to(torch.float32))
                ent = -torch.mean(torch.sum(torch.exp(logp) * logp, dim=-1))
            return {"bc_loss": loss.detach(), "teacher_agree": agree, "entropy": ent}

    return init_fn, update_fn


# ------------------------------------------------------------------ serving
class ActorNoise(NamedTuple):
    """The draws of one served step over leading axes L."""

    policy: torch.Tensor  # [*L, P, K] Gumbel (discrete) or [*L, P, d] standard normal (Box); unused when greedy
    others: torch.Tensor  # [*L, A(, d)] uniform actions for the non-plan agents


class PolicyActor:
    """The trained policy under the planners' actor contract:
    ``act(stacked_obs, generator=None, noise=None) -> [*L, A(, d)]`` joint
    actions over the stacked obs's leading axes L (none for one env).  The
    plan agents act from the policy (argmax / the squashed mean when
    ``greedy``, else a draw); the others get uniform draws, which callers
    overwrite with the opponents' real policy.  One forward pass per step.
    ``policy`` is the network module holding the weights (the JAX
    signature's ``policy`` and ``params`` in one); ``centralized`` must
    match the trainer's flag."""

    def __init__(self, policy: nn.Module, env, spec: AgentSpec, plan_agents: Sequence[int], greedy: bool = True,
                 centralized: bool = False):
        self.policy, self.spec, self.greedy = policy, spec, greedy
        self.sample_actions, _ = make_action_sampler(env, spec)
        self.p = _plan_prefix(spec, plan_agents)
        self.obs_fn, _ = make_obs_builder(spec, plan_agents, centralized)
        self.discrete = getattr(env, "discrete_actions", True)
        self.bounds = None if self.discrete else _box_bounds(env)
        self.act_dim = int(spec.act_dims[0])
        self.device = env.device

    def draw_noise(self, generator: Optional[torch.Generator], lead=()) -> ActorNoise:
        shape = (*lead, self.p, self.act_dim)
        if self.discrete:
            pol = _gumbel(shape, generator, self.device)
        else:
            pol = torch.randn(shape, generator=generator, device=self.device)
        return ActorNoise(pol, self.sample_actions(generator, tuple(lead)))

    @torch.no_grad()
    def __call__(self, stacked_obs, generator: Optional[torch.Generator] = None,
                 noise: Optional[ActorNoise] = None) -> torch.Tensor:
        obs_g = stacked_to_grouped(self.spec, stacked_obs)
        lead = tuple(obs_g[0].shape[:-2])
        if noise is None:
            noise = self.draw_noise(generator, lead)
        rows = self.obs_fn(tuple(o.reshape(-1, *o.shape[-2:]) for o in obs_g))  # [M, P, D]
        if self.discrete:
            logits = self.policy(rows).reshape(*lead, self.p, -1)
            acts_p = torch.argmax(logits if self.greedy else logits + noise.policy, dim=-1)
        else:
            mu, log_std = (x.reshape(*lead, self.p, -1) for x in self.policy(rows))
            if self.greedy:
                acts_p = _tanh_affine(mu, *self.bounds)
            else:
                acts_p, _ = tanh_gaussian_sample(mu, log_std, noise.policy, *self.bounds)
        out = noise.others.clone()
        out.narrow(len(lead), 0, self.p).copy_(acts_p)  # the agent axis follows L
        return out


make_policy_actor = PolicyActor


# ---------------------------------------------------------------- self-play
class SelfplayNoise(NamedTuple):
    """The Gumbel draws of one self-play rollout of H steps over B rows."""

    a: torch.Tensor  # [H, B, G_a, K_a] team A (group 0)
    b: torch.Tensor  # [H, B, G_b, K_b] team B (group 1)


class SelfplayRollout:
    """Two-team policy-in-the-loop imagination: every agent acts from its
    own team's policy, on its own group's observations (simple_tag: group 0
    the adversaries, group 1 the good agents).  Discrete actions only.

    ``rollout(policy_a, policy_b, obs_g, generator=None, noise=None,
    frozen=None) -> (states [H, B, Σobs], rewards [H, B, A], (logp_a
    [H, B, G_a], ent_a), (logp_b [H, B, G_b], ent_b))``; the team named by
    ``frozen`` ('a' or 'b') acts under ``torch.no_grad()`` (the JAX
    package's ``stop_gradient`` of its params), so each team's gradients
    reach its params through its own logp/ent only."""

    def __init__(self, wm, env, spec: AgentSpec, horizon: int = 8):
        assert len(spec.groups) == 2, (
            f"self-play imagination needs exactly two agent groups (teams), "
            f"spec has {len(spec.groups)}"
        )
        assert getattr(env, "discrete_actions", True), (
            "self-play imagination is discrete-actions only"
        )
        self.wm, self.horizon, self.device = wm, horizon, env.device
        self.shapes = [(len(idxs), int(spec.act_dims[idxs[0]])) for _, idxs in spec.groups]

    def draw_noise(self, generator: Optional[torch.Generator], b: int) -> SelfplayNoise:
        return SelfplayNoise(*(_gumbel((self.horizon, b, g, k), generator, self.device) for g, k in self.shapes))

    @staticmethod
    def _team_step(policy, obs_team, gumbel, frozen: bool):
        with torch.no_grad() if frozen else contextlib.nullcontext():
            logits = torch.log_softmax(policy(obs_team), dim=-1)  # [B, G, K]
            acts = torch.argmax(logits + gumbel, dim=-1)
            logp = logits.gather(-1, acts[..., None])[..., 0]
            ent = -torch.sum(torch.exp(logits) * logits, dim=-1)
        return acts.to(torch.int32), logp, ent

    def __call__(self, policy_a, policy_b, obs_g, generator: Optional[torch.Generator] = None,
                 noise: Optional[SelfplayNoise] = None, frozen: Optional[str] = None):
        if noise is None:
            noise = self.draw_noise(generator, obs_g[0].shape[0])
        carry = tuple(obs_g)
        out = [[] for _ in range(6)]
        for t in range(self.horizon):
            acts_a, logp_a, ent_a = self._team_step(policy_a, carry[0], noise.a[t], frozen == "a")
            acts_b, logp_b, ent_b = self._team_step(policy_b, carry[1], noise.b[t], frozen == "b")
            # the teams are the spec's two groups: their actions are the
            # grouped actions
            ns, rw = self.wm._predict(GroupedBatch(obs=carry, actions=(acts_a, acts_b)))
            carry = self.wm._state_to_grouped(ns)
            for xs, x in zip(out, (ns, rw, logp_a, ent_a, logp_b, ent_b)):
                xs.append(x)
        states, rewards, logp_a, ent_a, logp_b, ent_b = (torch.stack(xs) for xs in out)
        return states, rewards, (logp_a, ent_a), (logp_b, ent_b)


make_selfplay_rollout = SelfplayRollout


def make_selfplay_trainer(
    wm,
    env,
    spec: AgentSpec,
    score_a_fn: Callable,
    score_b_fn: Callable,
    horizon: int = 8,
    n_rollouts: int = 16,
    learning_rate: float = 3e-4,
    entropy_coef: float = 1e-2,
    hidden: Tuple[int, ...] = (128, 128),
):
    """Alternating best-response REINFORCE for BOTH teams inside the same
    imagination.  Each update trains ONE team's policy while the other is
    frozen (it still acts); the REINFORCE trainer's per-start leave-one-mean
    baseline and normalization.

    ``score_X_fn(states [H, B, Σobs], rewards [H, B, A]) -> [B, G_X]``
    per-agent scores for team X (A = group 0, B = group 1).

    Returns ``(policy_a, policy_b, init_fn, update_a_fn, update_b_fn)``:
      init_fn(generator, obs_row_a=None, obs_row_b=None) -> ((params_a,
        opt_a), (params_b, opt_b)): each team's policy module, its weights
        drawn from ``generator`` (A first), and its Adam;
      update_X_fn(params_X, opt_X, params_other, obs_starts_g,
        generator=None, noise=None) -> (params_X, opt_X, metrics), after
        one Adam step on ``params_X`` in place, its grads cleared;
        ``noise`` is the rollout's ``SelfplayNoise`` over S·n_rollouts
        rows."""
    rollout = SelfplayRollout(wm, env, spec, horizon)
    (od_a, _), idx_a = spec.groups[0]
    (od_b, _), idx_b = spec.groups[1]
    policy_a = PolicyMLP(od_a, hidden, int(spec.act_dims[idx_a[0]]), device=env.device)
    policy_b = PolicyMLP(od_b, hidden, int(spec.act_dims[idx_b[0]]), device=env.device)

    def init_fn(generator: torch.Generator, obs_row_a=None, obs_row_b=None):
        for policy, row in ((policy_a, obs_row_a), (policy_b, obs_row_b)):
            if row is not None and row.shape[-1] != policy.obs_dim:
                raise ValueError(f"an observation row of width {row.shape[-1]} for a policy over {policy.obs_dim}")
            policy.reset_parameters(generator)
        return ((policy_a, torch.optim.Adam(policy_a.parameters(), lr=learning_rate)),
                (policy_b, torch.optim.Adam(policy_b.parameters(), lr=learning_rate)))

    def _pg_loss(score, logp, ent):
        # score [B, G], logp [H, B, G] -> leave-one-mean REINFORCE
        s, g = score.shape[0] // n_rollouts, score.shape[-1]
        score = score.reshape(s, n_rollouts, g)
        adv = score - torch.mean(score, dim=1, keepdim=True)
        adv = adv / (torch.std(score, dim=1, correction=0, keepdim=True) + 1e-6)
        logp_sum = torch.sum(logp, dim=0).reshape(s, n_rollouts, g)
        pg = -torch.mean(adv.detach() * logp_sum)
        ent_mean = torch.mean(ent)
        return pg - entropy_coef * ent_mean, {
            "score_mean": torch.mean(score).detach(),
            "entropy": ent_mean.detach(),
            "pg_loss": pg.detach(),
        }

    def _make_update(train_a: bool):
        def update_fn(params_train, opt_state, params_frozen, obs_starts_g,
                      generator: Optional[torch.Generator] = None, noise: Optional[SelfplayNoise] = None):
            obs_g = _tile(obs_starts_g, n_rollouts)
            if train_a:
                states, rewards, (logp, ent), _ = rollout(params_train, params_frozen, obs_g, generator, noise,
                                                          frozen="b")
                score = score_a_fn(states, rewards)
            else:
                states, rewards, _, (logp, ent) = rollout(params_frozen, params_train, obs_g, generator, noise,
                                                          frozen="a")
                score = score_b_fn(states, rewards)
            loss, metrics = _pg_loss(score, logp, ent)
            _adam_step(opt_state, loss)
            # no grad outlives the update: the next one may freeze this team
            opt_state.zero_grad(set_to_none=True)
            return params_train, opt_state, metrics

        return update_fn

    return policy_a, policy_b, init_fn, _make_update(True), _make_update(False)


class TeamActor:
    """Serve ONE team's self-play policy: ``act(stacked_obs,
    generator=None, noise=None) -> [*L, G]`` actions for the group's agents
    from their own observations (argmax when ``greedy``, else a draw with
    Gumbel ``noise`` [*L, G, K]).  ``policy`` is the module holding the
    weights (the JAX signature's ``policy`` and ``params`` in one)."""

    def __init__(self, policy: nn.Module, spec: AgentSpec, group: int, greedy: bool = False):
        self.policy, self.spec, self.group, self.greedy = policy, spec, group, greedy
        idxs = spec.groups[group][1]
        self.shape = (len(idxs), int(spec.act_dims[idxs[0]]))
        self.device = next(policy.parameters()).device

    def draw_noise(self, generator: Optional[torch.Generator], lead=()) -> torch.Tensor:
        return _gumbel(tuple(lead) + self.shape, generator, self.device)

    @torch.no_grad()
    def __call__(self, stacked_obs, generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        logits = self.policy(stacked_to_grouped(self.spec, stacked_obs)[self.group])  # [*L, G, K]
        if not self.greedy:
            if noise is None:
                noise = self.draw_noise(generator, logits.shape[:-2])
            logits = logits + noise
        return torch.argmax(logits, dim=-1).to(torch.int32)


make_team_actor = TeamActor
