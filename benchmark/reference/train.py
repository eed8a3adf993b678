"""The training side of the reference: the run's random streams, uniform
replay sampling, random collection, the ELBO step under Adam, and the
first steps of a run followed from the seed.

Random streams.  A run of seed s draws from seven independent generators
on its device, named reset, act, step, sample, model, train and eval;
stream i is seeded with ``SeedSequence((s, i))``'s first two 32-bit words
``(w0 << 31) ^ w1``.  Each consumer draws in a fixed order: collection
one ``rand(A)`` from act per env step (action ``min(floor(u·n), n - 1)``),
a train step one ``randint(0, size, (B,))`` from sample and one
``randn(B, A, F)`` from train, the test phase one ``randint(0, size,
(test_num·B,))`` and one ``randn(test_num·B, A, F)`` from eval, a reset
the agent positions then the landmarks from reset.  The reference draws
the same numbers from generators of its own, seeded alike.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import model as M
from benchmark.reference.env import N_ACTIONS, SimpleTag

STREAMS = ("reset", "act", "step", "sample", "model", "train", "eval")


def stream_seed(seed: int, index: int) -> int:
    w = np.random.SeedSequence((int(seed), int(index))).generate_state(2, np.uint32)
    return (int(w[0]) << 31) ^ int(w[1])


def streams(seed: int, device) -> Dict[str, torch.Generator]:
    out = {}
    for i, name in enumerate(STREAMS):
        g = torch.Generator(device=device)
        g.manual_seed(stream_seed(seed, i))
        out[name] = g
    return out


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) on a dict of leaves."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float):
        self.lr = lr
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params, grads):
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(0.9).add_(g, alpha=0.1)
            self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            p.sub_(self.lr / c1 * self.m[k] / (torch.sqrt(self.v[k] / c2) + 1e-8))


class Follow:
    """The record of a run's first train steps: the loss of each, the
    first gradient and the parameters after ``keep_after`` steps."""

    def __init__(self, params: Dict[str, torch.Tensor], keep_after: int = 3):
        self.initial = {k: v.detach().clone() for k, v in params.items()}
        self.keep_after = keep_after
        self.losses: List[torch.Tensor] = []
        self.first_grad: Optional[Dict[str, torch.Tensor]] = None
        self.first_out: Optional[tuple] = None  # the first forward's state output and reward
        self.first_huber: list = []  # (x, y, delta, value) of the first step's loss reductions
        self.params_after: Optional[Dict[str, torch.Tensor]] = None

    def grad_norms(self) -> Dict[str, float]:
        return leaf_norms(self.first_grad)

    def change_norms(self) -> Dict[str, float]:
        return leaf_norms({k: self.params_after[k] - v for k, v in self.initial.items()})


def train_step(params, opt: Adam, m: dict, loss_cfg: dict, spec: M.Spec, batch, eps, pr: M.Precision,
               follow: Optional[Follow] = None, half_batch: bool = False):
    """One ELBO step on ``batch`` = (obs, actions, next_state, rewards)
    -> (loss, s, r, kl); ``half_batch`` (a fault the checks must catch)
    takes the loss over the first half of the rows only."""
    obs, actions, next_state, rewards = batch
    for v in params.values():
        v.requires_grad_(True)
    state, reward, mu, logvar = M.forward(params, m, spec, obs, actions, eps, pr)
    if follow is not None and follow.first_out is None:
        raw = state - M.global_state(obs) if m["residual_state"] else state
        follow.first_out = (raw.detach().clone(), reward.detach().clone())
    parts = (state, reward, next_state, rewards, mu, logvar)
    if half_batch:
        parts = tuple(x[: x.shape[0] // 2] for x in parts)
    loss, s, r, kl = M.elbo(*parts, loss_cfg)
    out = torch.stack([loss, s, r, kl]).detach()
    if follow is not None and opt.t == 0:
        st, rw, ns, rws = parts[:4]
        delta = loss_cfg.get("huber_delta", 1.0)
        follow.first_huber = [(ns.detach(), st.detach(), delta, float(s.detach())),
                              (rws.detach(), rw.detach(), delta, float(r.detach()))]
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    for v in params.values():
        v.requires_grad_(False)
    opt.step(params, grads)
    if follow is not None:
        follow.losses.append(out)
        if opt.t == 1:
            follow.first_grad = {k: g.detach().clone() for k, g in grads.items()}
        if opt.t == follow.keep_after:
            follow.params_after = {k: v.detach().clone() for k, v in params.items()}
    return out


def batch_from_rows(spec: M.Spec, ring: dict, idx: torch.Tensor):
    """Rows ``idx`` of a ring {obs, actions, next_obs: per group, rewards}
    -> (obs, actions, next_state, rewards)."""
    obs = [o[idx] for o in ring["obs"]]
    actions = [a[idx] for a in ring["actions"]]
    next_state = M.global_state([o[idx] for o in ring["next_obs"]])
    return obs, actions, next_state, ring["rewards"][idx]


def train_phase(params, opt, cfg: dict, spec: M.Spec, ring: dict, size: int, gens, pr,
                follow: Optional[Follow] = None, half_batch: bool = False) -> torch.Tensor:
    """``train_num`` steps, each on a uniform sample of the ring's first
    ``size`` rows; -> the mean (loss, s, r, kl) over the steps."""
    m, t, b = cfg["model"], cfg["train"], cfg["buffer"]["batch_size"]
    outs = []
    for _ in range(t["train_num"]):
        idx = torch.randint(0, max(size, 1), (b,), generator=gens["sample"], device=gens["sample"].device)
        eps = torch.randn((b, spec.n, m["obs_features"]), generator=gens["train"], device=gens["train"].device)
        outs.append(train_step(params, opt, m, cfg["loss"], spec, batch_from_rows(spec, ring, idx), eps, pr,
                               follow, half_batch))
    return torch.stack(outs).mean(dim=0)


@torch.no_grad()
def test_phase(params, cfg: dict, spec: M.Spec, ring: dict, size: int, gens, pr) -> torch.Tensor:
    """The test phase: ``test_num`` batches drawn at once, one forward over
    them, the ELBO over the joined rows (a mean of equal-sized batch
    means); -> (loss, s, r, kl)."""
    m = cfg["model"]
    n = cfg["train"]["test_num"] * cfg["buffer"]["batch_size"]
    g = gens["eval"]
    idx = torch.randint(0, max(size, 1), (n,), generator=g, device=g.device)
    eps = torch.randn((n, spec.n, m["obs_features"]), generator=g, device=g.device)
    obs, actions, next_state, rewards = batch_from_rows(spec, ring, idx)
    state, reward, mu, logvar = M.forward(params, m, spec, obs, actions, eps, pr)
    return torch.stack(M.elbo(state, reward, next_state, rewards, mu, logvar, cfg["loss"]))


def new_ring(env: SimpleTag, spec: M.Spec, capacity: int, device) -> dict:
    groups = [(od, len(idx)) for (od, _), idx in spec.groups]
    return {
        "obs": [torch.zeros(capacity, a, od, device=device) for od, a in groups],
        "actions": [torch.zeros(capacity, a, dtype=torch.int32, device=device) for _, a in groups],
        "next_obs": [torch.zeros(capacity, a, od, device=device) for od, a in groups],
        "rewards": torch.zeros(capacity, env.n, device=device),
        "done": torch.zeros(capacity, device=device),
    }


def collect(env: SimpleTag, spec: M.Spec, carry, ring: dict, cursor: int, steps: int, gens):
    """``steps`` random-action env steps written to the ring from
    ``cursor``; an episode's end resets the env.  -> (carry, cursor)."""
    obs, state = carry
    cap = ring["rewards"].shape[0]
    dev = env.device
    n_act = torch.full((env.n,), float(N_ACTIONS), device=dev)
    for _ in range(steps):
        u = torch.rand(env.n, generator=gens["act"], device=dev)
        actions = torch.minimum((u * n_act).to(torch.int32), n_act.to(torch.int32) - 1)
        next_obs, next_state, rewards, done = env.step(state, actions)
        bounds = np.cumsum([0] + [len(idx) for _, idx in spec.groups])
        for g in range(len(spec.groups)):
            ring["obs"][g][cursor] = obs[g]
            ring["next_obs"][g][cursor] = next_obs[g]
            ring["actions"][g][cursor] = actions[bounds[g]:bounds[g + 1]]
        ring["rewards"][cursor] = rewards
        ring["done"][cursor] = torch.amax(done.to(torch.float32))
        cursor = (cursor + 1) % cap
        if bool(torch.all(done)):
            obs, state = env.reset(gens["reset"])
        else:
            obs, state = next_obs, next_state
    return (obs, state), cursor


def leaf_norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def median(values) -> float:
    v = sorted(values)
    return v[len(v) // 2] if len(v) % 2 else 0.5 * (v[len(v) // 2 - 1] + v[len(v) // 2])


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> float:
    """max over leaves of |‖prog‖ - ‖ref‖| / max(‖ref‖, the median leaf's
    ‖ref‖), over the leaves in ``keep`` (all by default); a leaf the
    program did not report reads as not moved (``prog`` None: none)."""
    prog = prog or {}
    keys = [k for k in ref if keep is None or k in keep]
    floor = median([ref[k] for k in keys])
    return max(abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], floor, 1e-30) for k in keys)


def moved_leaves(first_grad_norms: Dict[str, float], share: float = 1e-3) -> set:
    """The leaves whose first gradient (the reference's) is at least
    ``share`` of the median leaf's: the others move under Adam by
    round-off alone."""
    floor = share * median(first_grad_norms.values())
    return {k for k, v in first_grad_norms.items() if v >= floor}


def huber_mean64(x: torch.Tensor, y: torch.Tensor, delta: float) -> float:
    """mean over all elements of huber(x - y), in float64."""
    a = torch.abs(x.double() - y.double())
    q = torch.clamp(a, max=delta)
    return float(torch.mean(0.5 * q * q + delta * (a - q)))


def huber_gap(calls) -> float:
    """The worst relative gap of a loss reduction's value against the
    float64 huber mean of the very inputs it was given; none read: 1."""
    if not calls:
        return 1.0
    return max(rel_gap(value, huber_mean64(x, y, delta)) for x, y, delta, value in calls)


def row_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """max over rows (the last axis is a row) of ‖prog - ref‖ / max(‖ref‖,
    the median row's ‖ref‖); an answer of another shape reads infinite."""
    if prog.shape != ref.shape:
        return float("inf")
    ref = ref.double().flatten(0, -2)
    diff = torch.linalg.vector_norm(prog.to(ref.device).double().flatten(0, -2) - ref, dim=-1)
    norm = torch.linalg.vector_norm(ref, dim=-1)
    return float(torch.max(diff / torch.clamp(norm, min=max(float(norm.median()), 1e-30))))


def outputs_gap(prog: Dict[str, torch.Tensor], names, ref: tuple) -> float:
    """The worse ``row_gap`` of the first forward's state output and
    reward; an output the program did not give reads 1."""
    return max(row_gap(prog[n], r) if n in prog else 1.0 for n, r in zip(names, ref))


def output_modules(m: dict) -> tuple:
    """The program's modules whose outputs are the state output (the
    delta under ``residual_state``) and the reward."""
    return ("state_head" if m["fused_decoders"] else "state_decoder", "reward_linear")


def rel_gap(prog: Optional[float], ref: float) -> float:
    """|prog - ref| / |ref|; a number the program did not report reads 1."""
    return 1.0 if prog is None else abs(prog - ref) / max(abs(ref), 1e-30)


def watched(watch) -> dict:
    """What the program's first steps showed (``benchmark.watch.FirstSteps``)."""
    return {"grad": watch.grad_norms, "change": watch.change_norms, "loss1": watch.first_loss,
            "out": watch.first_outputs, "huber": watch.huber_calls}


def followed(conf: dict, follow: Follow) -> dict:
    """The same of a followed run, for the reference put in the program's place."""
    return {"grad": follow.grad_norms(), "change": follow.change_norms(), "loss1": float(follow.losses[0][0]),
            "out": dict(zip(output_modules(conf["model"]), follow.first_out)), "huber": follow.first_huber}


def step_readings(conf: dict, prog: dict, follow: Follow) -> dict:
    """``out1`` the worst row's gap of the first forward's state output and
    reward; ``loss1`` the relative gap of the first step's loss; ``grad``
    and ``update`` the worst leaf's gap of norms (the first gradient; the
    change after ``keep_after`` steps, over the leaves the reference's
    first gradient moves); on the kernel route (``use_pallas``) also
    ``k3``, the worst gap of the first step's loss reductions (kernel K3's
    state and reward huber means) against the float64 huber mean of the
    inputs each was given."""
    grad_r = follow.grad_norms()
    out = {
        "out1": outputs_gap(prog["out"], output_modules(conf["model"]), follow.first_out),
        "loss1": rel_gap(prog["loss1"], float(follow.losses[0][0])),
        "grad": worst_leaf_gap(prog["grad"], grad_r),
        "update": worst_leaf_gap(prog["change"], follow.change_norms(), keep=moved_leaves(grad_r)),
    }
    if conf["model"].get("use_pallas"):
        out["k3"] = huber_gap(prog["huber"])
    return out
