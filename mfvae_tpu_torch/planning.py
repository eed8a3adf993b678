"""Model-predictive control through the serving surface (mirror of
``mfvae_tpu/planning.py``).

Plan actions by imagining candidate futures and executing the first action
of the best one:

  1. sample N candidate joint action plans of horizon H from the env's own
     action spaces (the trainer's ``make_action_sampler``, so the planner's
     model of the uncontrolled agents is uniform random);
  2. imagine all N futures in one batched rollout: the learned model's
     ``WorldModel._rollout``, or the env's true dynamics through
     ``EnvDynamicsModel``;
  3. score each candidate and execute the first action of the best one,
     jointly or per plan agent.

Every actor takes the stacked obs (and, through true dynamics, the env
state) with any leading axes, e.g. [E] episodes, and flattens [E, N] into
one rollout batch, so ``eval_joint_policy`` steps all its episodes as one
batched env with no loop over them.  ``score_fn(states, rewards)`` sees
that batch as its candidate axis: states [H, E·N, Σobs], rewards
[H, E·N, A]; it must score each candidate on its own.

The random draws are a replaceable step, as eps is in the model: MPC takes
explicit ``plans``, CEM an explicit ``CEMNoise`` (each iteration's Gumbel
noise of the categorical draw and the uniform actions of every agent, and
the final uniform draw), so tests hand in the JAX package's own draws.
Selection ties break to the first maximum, as ``jnp.argmax`` and
``lax.top_k`` do.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch

from mfvae_tpu_torch.data.buffer import tree_map
from mfvae_tpu_torch.models.mavae import AgentSpec
from mfvae_tpu_torch.rollout_eval import flatten_global_state
from mfvae_tpu_torch.training.trainer import make_action_sampler, stacked_to_grouped

NEG_INF = torch.finfo(torch.float32).min


class EnvDynamicsModel:
    """The real env in the planner's imagination contract: the
    true-dynamics arm that separates model error from planner limits.

    ``needs_state = True``: actors built on it plan from the live env
    state (a diagnostic upper bound; real agents only have observations)
    and hand the stacked action plans through, with no grouping.  MPE
    dynamics are deterministic, so every candidate sees the same world."""

    needs_state = True

    def __init__(self, env, spec: AgentSpec):
        self.env = env
        self.spec = spec

    @torch.no_grad()
    def _rollout(self, state, plans: torch.Tensor):
        """``state``: the env state with leading axes L (none for one
        env); ``plans`` [H, *L, N, A(, d)], one candidate per column.  The
        state is broadcast to [*L, N] and the batched env steps H times.
        Returns (states [H, *L, N, Σobs], rewards [H, *L, N, A])."""
        lead = state.step.dim()
        n = plans.shape[lead + 1]
        s = tree_map(lambda x: x.unsqueeze(lead).expand(*x.shape[:lead], n, *x.shape[lead:]), state)
        states, rewards = [], []
        for a_t in plans:
            obs, s, rew, _, _ = self.env.step_stacked(s, a_t)
            # the agent-order global state, WorldModel._rollout's layout
            states.append(flatten_global_state(self.spec, stacked_to_grouped(self.spec, obs)))
            rewards.append(rew)
        return torch.stack(states), torch.stack(rewards)


def _imagine(wm, spec: AgentSpec, group_actions, stacked_obs, state, plans: torch.Tensor):
    """Imagine ``plans`` [H, *L, N, A(, d)] from the obs (or, for a model
    that needs it, the state) with leading axes L.  Returns (states
    [H, M, Σobs], rewards [H, M, A]) with M = prod(L)·N."""
    h = plans.shape[0]
    grouped = stacked_to_grouped(spec, stacked_obs)
    n_lead = grouped[0].dim() - 2
    if getattr(wm, "needs_state", False):
        if state is None:
            raise ValueError(
                "this planner imagines through the true dynamics (EnvDynamicsModel): "
                "call act(stacked_obs, generator, state)"
            )
        states, rewards = wm._rollout(state, plans)
    else:
        n = plans.shape[n_lead + 1]
        obs_g = tuple(
            o.unsqueeze(n_lead).expand(*o.shape[:n_lead], n, *o.shape[n_lead:]).reshape(-1, *o.shape[n_lead:])
            for o in grouped
        )
        plan_g = tuple(p.reshape(h, -1, *p.shape[n_lead + 2:]) for p in group_actions(plans))
        states, rewards = wm._rollout(obs_g, plan_g)
    return states.reshape(h, -1, states.shape[-1]), rewards.reshape(h, -1, rewards.shape[-1])


def _pick(first_acts: torch.Tensor, n_for_agent: torch.Tensor) -> torch.Tensor:
    """first_acts [*L, N, A(, d)], n_for_agent [*L, A] -> [*L, A(, d)]:
    agent a's first action from candidate n_for_agent[..., a]."""
    k = n_for_agent.dim() - 1  # the candidate axis
    idx = n_for_agent.unsqueeze(k)
    idx = idx.reshape(idx.shape + (1,) * (first_acts.dim() - idx.dim())).expand(
        *idx.shape, *first_acts.shape[idx.dim():]
    )
    return first_acts.gather(k, idx).squeeze(k)


def _plan_index(spec: AgentSpec, plan_agents, device) -> torch.Tensor:
    agents = tuple(plan_agents) if plan_agents is not None else tuple(range(spec.n_agents))
    return torch.tensor(agents, dtype=torch.long, device=device)


def make_mpc_actor(
    wm,
    env,
    spec: AgentSpec,
    horizon: int = 8,
    n_candidates: int = 64,
    plan_agents: Optional[Sequence[int]] = None,
    score_fn=None,
    factorized: bool = False,
    candidate_mode: str = "random",
):
    """Random-shooting MPC: ``act(stacked_obs, generator=None, state=None,
    plans=None) -> joint actions [*L, A(, act_dim)]``.

    ``plan_agents``: the agents whose predicted reward is maximized
    (default all); the others keep candidate 0's action, a uniform draw
    that callers overwrite with the opponents' real policy.

    ``score_fn(states, rewards)`` replaces the predicted-reward objective;
    it returns [M] (joint) or [M, len(plan_agents)] (``factorized``).

    ``factorized=True``: each plan agent executes the first action of the
    candidate that maximizes its own score column (a joint argmax over a
    many-agent team is noise).  ``candidate_mode='repeat'``: one action per
    (candidate, agent), held over the horizon.

    ``plans`` [H, *L, N, A(, d)] replaces the draw from ``generator``.  A
    ``wm`` with ``needs_state`` (``EnvDynamicsModel``) imagines from the
    env state: call ``act(stacked_obs, generator, state)``."""
    if candidate_mode not in ("random", "repeat"):
        raise ValueError(f"unknown candidate_mode {candidate_mode!r}")
    sample_actions, group_actions = make_action_sampler(env, spec)
    idx = _plan_index(spec, plan_agents, env.device)
    if score_fn is None:
        if factorized:
            def score_fn(states, rewards):
                return torch.sum(rewards[..., idx], dim=0)  # [M, P]
        else:
            def score_fn(states, rewards):
                return torch.sum(rewards[..., idx], dim=(0, 2))  # [M]

    @torch.no_grad()
    def act(stacked_obs, generator: Optional[torch.Generator] = None, state=None,
            plans: Optional[torch.Tensor] = None):
        lead = tuple(stacked_obs[0].shape[:-2])
        if plans is None:
            if candidate_mode == "repeat":
                first = sample_actions(generator, (*lead, n_candidates))
                plans = first.unsqueeze(0).expand(horizon, *first.shape)
            else:
                plans = sample_actions(generator, (horizon, *lead, n_candidates))
        states, rewards = _imagine(wm, spec, group_actions, stacked_obs, state, plans)
        score = score_fn(states, rewards)
        score = score.reshape(*lead, n_candidates, *score.shape[1:])
        first_acts = plans[0]  # [*L, N, A(, d)]
        if not factorized:
            best = torch.argmax(score, dim=-1)  # [*L]
            return _pick(first_acts, best[..., None].expand(*lead, spec.n_agents))
        if score.dim() != len(lead) + 2:
            raise ValueError("factorized=True needs per-agent scores [N, len(plan_agents)]")
        n_for_agent = torch.zeros(*lead, spec.n_agents, dtype=torch.long, device=score.device)
        n_for_agent[..., idx] = torch.argmax(score, dim=-2)  # non-plan agents: candidate 0
        return _pick(first_acts, n_for_agent)

    return act


class CEMNoise(NamedTuple):
    """The random draws of one CEM call over leading axes L."""

    gumbel: List[torch.Tensor]  # per iteration [H, *L, N, P, K]: Gumbel-max noise of the categorical draw
    others: List[torch.Tensor]  # per iteration [H, *L, N, A]: uniform actions (the plan agents' overwritten)
    final: torch.Tensor  # [*L, A]: the executed draw of the non-plan agents


class CEMActor:
    """Cross-entropy-method planner (discrete actions): refit
    per-(step, plan agent) categoricals to each agent's elite candidates,
    re-imagine, and execute each plan agent's best-seen first action.
    Selection is factorized per agent throughout, so ``score_fn(states,
    rewards)`` returns [M, len(plan_agents)] (default: per-agent predicted
    reward sums).  Action ids past an agent's own action space (the
    simple_world_comm leader's 20 beside 5) are masked to -inf.

    ``proposal_fn(stacked_obs) -> [P, K]`` (or [*L, P, K]) logits
    warm-start the categoricals instead of the uniform start.

    ``actor(stacked_obs, generator=None, state=None, noise=None) -> [*L, A]``;
    ``noise`` (``draw_noise``'s layout) replaces the draws from
    ``generator``."""

    def __init__(self, wm, env, spec: AgentSpec, horizon: int = 8, n_candidates: int = 64,
                 plan_agents: Optional[Sequence[int]] = None, score_fn=None, iters: int = 3,
                 elite_frac: float = 0.125, proposal_fn=None):
        if not getattr(env, "discrete_actions", True):
            raise NotImplementedError(
                "the CEM actor implements the discrete-action categorical CEM; "
                "use make_mpc_actor for continuous envs"
            )
        self.wm, self.spec = wm, spec
        self.horizon, self.n_candidates, self.iters = horizon, n_candidates, iters
        self.proposal_fn = proposal_fn
        self.sample_actions, self.group_actions = make_action_sampler(env, spec)
        self.idx = idx = _plan_index(spec, plan_agents, env.device)
        self.n_elite = max(int(n_candidates * elite_frac), 1)
        if score_fn is None:
            def score_fn(states, rewards):
                return torch.sum(rewards[..., idx], dim=0)  # [M, P]
        self.score_fn = score_fn
        self.device = env.device
        act_dims = torch.tensor(spec.act_dims, device=env.device)[idx]  # [P]
        self.n_actions = int(max(spec.act_dims))
        self.valid = torch.arange(self.n_actions, device=env.device)[None, :] < act_dims[:, None]  # [P, K]

    def draw_noise(self, generator: Optional[torch.Generator] = None, lead=()) -> CEMNoise:
        """Every draw of one call, iteration by iteration, then the final."""
        tiny = torch.finfo(torch.float32).tiny
        gumbel, others = [], []
        shape = (self.horizon, *lead, self.n_candidates, len(self.idx), self.n_actions)
        for _ in range(self.iters):
            u = torch.rand(shape, generator=generator, device=self.device)
            gumbel.append(-torch.log(-torch.log(torch.clamp(u, min=tiny))))
            others.append(self.sample_actions(generator, (self.horizon, *lead, self.n_candidates)))
        return CEMNoise(gumbel, others, self.sample_actions(generator, tuple(lead)))

    @torch.no_grad()
    def __call__(self, stacked_obs, generator: Optional[torch.Generator] = None, state=None,
                 noise: Optional[CEMNoise] = None) -> torch.Tensor:
        h, n, idx, valid = self.horizon, self.n_candidates, self.idx, self.valid
        p = len(idx)
        lead = tuple(stacked_obs[0].shape[:-2])
        if noise is None:
            noise = self.draw_noise(generator, lead)
        if self.proposal_fn is None:
            logits = torch.where(valid, 0.0, NEG_INF)
        else:
            prop = torch.log_softmax(self.proposal_fn(stacked_obs), dim=-1)
            logits = torch.where(valid, prop, NEG_INF)
        logits = logits.expand(h, *lead, p, self.n_actions)
        best_score = torch.full((*lead, p), NEG_INF, device=self.device)
        best_first = torch.zeros((*lead, p), dtype=torch.long, device=self.device)
        for i in range(self.iters):
            # plan agents from the current categoricals (Gumbel-max): [H, *L, N, P]
            plan_acts = torch.argmax(logits.unsqueeze(-3) + noise.gumbel[i], dim=-1)
            # the other agents stay uniform random
            full = noise.others[i].clone()
            full[..., idx] = plan_acts.to(full.dtype)
            states, rewards = _imagine(self.wm, self.spec, self.group_actions, stacked_obs, state, full)
            scores = self.score_fn(states, rewards).reshape(*lead, n, p)
            # per-agent elites (ties to the lower candidate, as lax.top_k),
            # then refit that agent's [H, K] categoricals
            elite = torch.sort(scores, dim=-2, descending=True, stable=True).indices[..., : self.n_elite, :]
            elite_acts = plan_acts.gather(-2, elite.unsqueeze(0).expand(h, *elite.shape))  # [H, *L, E, P]
            counts = torch.nn.functional.one_hot(elite_acts, self.n_actions).sum(dim=-3).to(torch.float32)
            logits = torch.where(valid, torch.log(counts / self.n_elite + 1e-4), NEG_INF)
            # each agent's best-seen first action across iterations
            col_best = torch.amax(scores, dim=-2)  # [*L, P]
            col_arg = torch.argmax(scores, dim=-2)
            first = plan_acts[0].gather(-2, col_arg.unsqueeze(-2)).squeeze(-2)
            improved = col_best > best_score
            best_score = torch.where(improved, col_best, best_score)
            best_first = torch.where(improved, first, best_first)
        out = noise.final.clone()
        out[..., idx] = best_first.to(out.dtype)
        return out


def make_cem_actor(wm, env, spec: AgentSpec, horizon: int = 8, n_candidates: int = 64,
                   plan_agents: Optional[Sequence[int]] = None, score_fn=None, iters: int = 3,
                   elite_frac: float = 0.125, proposal_fn=None) -> CEMActor:
    """The JAX package's factory name for ``CEMActor``."""
    return CEMActor(wm, env, spec, horizon, n_candidates, plan_agents, score_fn, iters, elite_frac,
                    proposal_fn)


@torch.no_grad()
def eval_joint_policy(
    env,
    spec: AgentSpec,
    joint_policy,
    n_episodes: int = 16,
    ep_len: int = 64,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Roll ``n_episodes`` real-env episodes as one batched env under
    ``joint_policy(stacked_obs [E], env_state [E], generator) -> actions
    [E, A(, act_dim)]`` and return the rewards [E, T, A].  No mid-episode
    resets: the episodes are fixed-length."""
    del spec  # the JAX package's signature
    obs, state = env.reset_stacked(generator, batch_shape=(n_episodes,))
    rewards = []
    for _ in range(ep_len):
        actions = joint_policy(obs, state, generator)
        obs, state, rew, _, _ = env.step_stacked(state, actions)
        rewards.append(rew)
    return torch.stack(rewards, dim=1)
