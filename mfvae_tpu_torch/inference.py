"""Serving a trained world model (mirror of ``mfvae_tpu/inference.py``).

``WorldModel(model)`` answers the queries the architecture supports, all
under ``torch.no_grad()`` on the model's device:

- ``predict(obs, actions)`` -> (next_state, rewards): the posterior-mean
  one-step prediction (``MAVAE.mean_call``, the path unroll training's
  ``mean_feedback`` runs);
- ``sample(obs, actions, generator, n)`` -> n posterior draws;
- ``encode(obs)`` -> per-agent (mu, logvar);
- ``rollout(obs, action_plan)`` -> a T-step closed loop: the predicted
  global state is every agent's next observation, so it is re-split per
  agent (``state_to_grouped``) and fed back.

Inputs are ``GroupedBatch``es, or the reference's per-agent dicts.

Imagination (``imagination.py``) is built on ``_predict`` and
``_state_to_grouped``, as in the JAX package, so stub world models plug in.
``_predict`` is ``mean_call`` with autograd on, over the model's parameters
detached: as JAX's ``_predict`` closes over ``variables``, gradients reach
its inputs (continuous actions, the imagined obs fed back) and never the
world model.  Every query reads the one model it was given, with no copy,
so ``predict`` and ``_predict`` agree however far that model trains on
(the JAX ``WorldModel`` holds a snapshot of ``variables`` instead).

On the card ``rollout`` serves each step as one replayed CUDA graph: the
step's ``mean_call`` on static per-group obs and action buffers, then the
refeed, which copies the predicted state, re-split, back into the obs
buffers, so a replay leaves the next step's input in place.  One capture
serves every horizon.  A graph is keyed on the device, the per-group obs
and action shapes and dtypes (B among them; the action shapes tell
discrete from continuous) and the address of every parameter and buffer
of the model.  An update in place (``optimizer.step``,
``load_state_dict``) keeps the addresses, so a replay reads the trained
weights; a replaced or moved tensor changes the key and forces a new
capture.  The first request of a key runs eagerly, which warms up the
capture; the second captures and replays.  ``GRAPH_KEYS`` graphs are kept,
and the one used least recently goes first.  The CPU, and a start that is
not float32 (the refeed is), run the eager loop.

A step graph of a model that computes in bf16 reads its weights cast: it
holds a cast store, one persistent tensor of the compute dtype for the
``kernel`` and the ``bias`` of every ``Dense`` and ``StackedDense``, and
is captured with those tensors in place of the float32 parameters, so a
layer's own cast of its weights launches nothing in the graph.  The store
is refreshed from the parameters once a request, before its first replay
(the same rounding as the layers' own casts, so a replay stays bit-equal
to the eager loop), and so reads an update in place as the graph does.
LayerNorm's ``scale`` and ``bias`` stay out (it computes in float32 and
reads them uncast), and so do the embedding tables (a lookup gathers rows
before it casts them).  A float32 model has no store.  Counters
(``utils/profiling.py``): ``rollout.graph_captures``,
``rollout.graph_replays`` (one a step), ``rollout.eager_steps`` and
``rollout.cast_refreshes`` (one a request replayed on a cast store).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from mfvae_tpu_torch.config import ModelConfig
from mfvae_tpu_torch.models.layers import Dense, StackedDense
from mfvae_tpu_torch.models.mavae import MAVAE, AgentSpec, GroupedBatch, state_to_grouped, zero_actions_grouped
from mfvae_tpu_torch.utils.profiling import count, span

GRAPH_KEYS = 4


class _MeanCall(nn.Module):
    """``model.mean_call`` as a module's forward, for ``functional_call``."""

    def __init__(self, model: MAVAE):
        super().__init__()
        self.model = model

    def forward(self, batch: GroupedBatch):
        return self.model.mean_call(batch)


def _cast_store(mean: _MeanCall) -> Dict[str, Tuple[nn.Parameter, torch.Tensor]]:
    """The cast store of a step graph (module docstring): for each
    ``kernel`` and ``bias`` of a ``Dense`` or ``StackedDense`` that
    computes in another dtype than its parameters', its name under
    ``mean`` -> (the parameter, an empty tensor of the layer's dtype)."""
    store = {}
    for name, layer in mean.named_modules():
        if isinstance(layer, (Dense, StackedDense)):
            for leaf in ("kernel", "bias"):
                p = getattr(layer, leaf)
                if p is not None and p.dtype != layer.dtype:
                    store[f"{name}.{leaf}"] = (p, torch.empty_like(p, dtype=layer.dtype))
    return store


class _StepGraph:
    """One rollout step captured as a CUDA graph (``graph``): ``step`` on
    the static buffers ``obs`` and ``act``.  A replay overwrites ``ns``
    [B, Σobs] and ``rw`` [B, A], the step's outputs, and ``obs``.

    ``casts`` is the graph's cast store (module docstring), allocated
    before the capture and read by the captured step in place of the
    float32 ``Dense``/``StackedDense`` weights; ``refresh`` fills it from
    the parameters, once a request.  Empty for a float32 model."""

    def __init__(self, model: MAVAE, obs_g, actions, device: torch.device):
        self.model = model
        self._mean = _MeanCall(model)
        store = _cast_store(self._mean)
        self._params = [p for p, _ in store.values()]
        self.casts = {name: cast for name, (_, cast) in store.items()}
        self.obs = tuple(torch.empty(o.shape, dtype=o.dtype, device=device) for o in obs_g)
        self.act = tuple(torch.empty(a.shape, dtype=a.dtype, device=device) for a in actions)
        self._capture()

    def _capture(self) -> None:
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.step()

    def refresh(self) -> None:
        """The cast store from the parameters as they are now."""
        torch._foreach_copy_(list(self.casts.values()), self._params)

    def step(self) -> None:
        """``mean_call`` on the buffers and the cast store, then the
        refeed: the predicted state re-split into ``obs``, the next
        step's input."""
        batch = GroupedBatch(obs=self.obs, actions=self.act)
        self.ns, self.rw = torch.func.functional_call(self._mean, self.casts, (batch,))
        for buf, o in zip(self.obs, state_to_grouped(self.model.spec, self.ns)):
            buf.copy_(o)


class WorldModel:
    GRAPH_DEVICES = ("cuda",)  # device types whose rollouts replay step graphs

    def __init__(self, model: MAVAE):
        self.model = model
        self.spec = model.spec
        self.device = next(model.parameters()).device
        self._mean = _MeanCall(model)
        self._graphs: "OrderedDict[tuple, _StepGraph]" = OrderedDict()
        self._seen: "OrderedDict[tuple, None]" = OrderedDict()  # keys served once, eagerly

    # ------------------------------------------------------------------ api
    @torch.no_grad()
    def predict(self, obs, actions) -> Tuple[torch.Tensor, torch.Tensor]:
        """Posterior-mean next global state [B, Σobs] and per-agent
        rewards [B, A]."""
        return self.model.mean_call(self._as_batch(obs, actions))

    @torch.no_grad()
    def sample(self, obs, actions, generator: Optional[torch.Generator] = None, n: int = 1, eps=None):
        """n posterior draws: ([n, B, Σobs], [n, B, A]).  ``eps``
        [n, B, A, F] (grouped agent order) replaces the generator's draws."""
        batch = self._as_batch(obs, actions)
        states, rewards = [], []
        for i in range(n):
            s, r, _, _ = self.model(batch, None, generator, None if eps is None else eps[i])
            states.append(s)
            rewards.append(r)
        return torch.stack(states), torch.stack(rewards)

    @torch.no_grad()
    def encode(self, obs, actions=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-agent latents (mu, logvar), each [B, A, F] in grouped order."""
        mu, logvar, *_ = self.model.encode(self._as_batch(obs, actions))
        return mu.to(torch.float32), logvar.to(torch.float32)

    def _predict(self, batch: GroupedBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Posterior-mean step differentiable in ``batch`` only, through
        the parameters detached: (next state [B, Σobs], rewards [B, A])."""
        params = {name: p.detach() for name, p in self._mean.named_parameters()}
        return torch.func.functional_call(self._mean, params, (batch,))

    def _state_to_grouped(self, state: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return state_to_grouped(self.spec, state)

    def rollout(self, obs, action_plan) -> Tuple[torch.Tensor, torch.Tensor]:
        """Imagine a T-step trajectory from ``obs`` under ``action_plan``:
        a dict {agent: [T] or [T, B] (continuous: [T, act] or [T, B, act])}
        or a per-group tuple of [T, B, A_g(, act)].  Returns the
        posterior-mean closed loop (states [T, B, Σobs], rewards
        [T, B, A]).  One span ``rollout`` a request."""
        with span("rollout"):
            batch = self._as_batch(obs, None)
            if isinstance(action_plan, dict):
                discrete = self.model.discrete_act
                plan_g = []
                for _, idxs in self.spec.groups:
                    cols = []
                    for i in idxs:
                        c = torch.as_tensor(action_plan[self.spec.agents[i]], device=self.device)
                        # an unbatched per-agent plan gets a B = 1 axis
                        if c.dim() == (1 if discrete else 2):
                            c = c.unsqueeze(1)
                        cols.append(c)
                    plan_g.append(torch.stack(cols, dim=2))  # [T, B, A_g(, act)]
                action_plan = tuple(plan_g)
            return self._rollout(batch.obs, action_plan)

    @torch.no_grad()
    def _rollout(self, obs_g, action_plan):
        """obs_g: per-group [B, A_g, od]; action_plan: per-group
        [T, B, A_g(, act)]; either may be a view of any strides.  On the
        card a replayed graph a step once the key has been served (module
        docstring), else the eager loop.  Spans ``rollout.step`` a step
        (eagerly its ``mean_call``, then ``rollout.refeed``, the state
        re-split; on the graph the step's copies around ``rollout.replay``)
        and ``rollout.capture`` before the first step of a capturing
        request; on a cast store ``rollout.cast`` once a request, before
        its first step."""
        key = self._graph_key(obs_g, action_plan)
        graph = self._graphs.get(key)
        if graph is None and key in self._seen:
            with span("rollout.capture"):
                graph = _StepGraph(self.model, obs_g, tuple(a[0] for a in action_plan), key[0])
            count("rollout.graph_captures")
            del self._seen[key]
            self._graphs[key] = graph
            while len(self._graphs) > GRAPH_KEYS:
                self._graphs.popitem(last=False)
        if graph is not None:
            self._graphs.move_to_end(key)
            return self._replay(graph, obs_g, action_plan)
        states, rewards = [], []
        for t in range(action_plan[0].shape[0]):
            with span("rollout.step"):
                ns, rw = self.model.mean_call(GroupedBatch(obs=obs_g, actions=tuple(a[t] for a in action_plan)))
            states.append(ns)
            rewards.append(rw)
            with span("rollout.refeed"):
                obs_g = state_to_grouped(self.spec, ns)
        count("rollout.eager_steps", len(states))
        out = torch.stack(states), torch.stack(rewards)
        if key is not None:
            self._seen[key] = None
            while len(self._seen) > GRAPH_KEYS:
                self._seen.popitem(last=False)
        return out

    def _graph_key(self, obs_g, action_plan) -> Optional[tuple]:
        """What a step graph is captured for (module docstring), or None
        where the eager loop serves."""
        tensors = [*self.model.parameters(), *self.model.buffers()]
        dev = tensors[0].device
        if dev.type not in self.GRAPH_DEVICES or any(o.dtype != torch.float32 for o in obs_g):
            return None
        inputs = (*obs_g, *(a[0] for a in action_plan))
        return (dev, tuple((tuple(x.shape), x.dtype) for x in inputs), tuple(t.data_ptr() for t in tensors))

    def _replay(self, graph: _StepGraph, obs_g, action_plan):
        """The request on ``graph``: its cast store refreshed (span
        ``rollout.cast``), the start copied in, then per step the actions
        copied in, a replay, the outputs copied out into tensors of this
        request's own."""
        if graph.casts:
            with span("rollout.cast"):
                graph.refresh()
            count("rollout.cast_refreshes")
        horizon = action_plan[0].shape[0]
        states = torch.empty((horizon, *graph.ns.shape), dtype=graph.ns.dtype, device=graph.ns.device)
        rewards = torch.empty((horizon, *graph.rw.shape), dtype=graph.rw.dtype, device=graph.rw.device)
        for buf, o in zip(graph.obs, obs_g):
            buf.copy_(o)
        for t in range(horizon):
            with span("rollout.step"):
                for buf, a in zip(graph.act, action_plan):
                    buf.copy_(a[t])
                with span("rollout.replay"):
                    graph.graph.replay()
                states[t].copy_(graph.ns)
                rewards[t].copy_(graph.rw)
        count("rollout.graph_replays", horizon)
        return states, rewards

    def _as_batch(self, obs, actions) -> GroupedBatch:
        if isinstance(obs, GroupedBatch):
            return obs
        if not isinstance(obs, dict):
            raise TypeError(type(obs))
        discrete = self.model.discrete_act
        obs_g, act_g = [], []
        for _, idxs in self.spec.groups:
            names = [self.spec.agents[i] for i in idxs]
            obs_g.append(torch.stack(
                [torch.atleast_2d(torch.as_tensor(obs[a], device=self.device)) for a in names], dim=1
            ))
            if actions is not None:
                widen = torch.atleast_1d if discrete else torch.atleast_2d
                act_g.append(torch.stack(
                    [widen(torch.as_tensor(actions[a], device=self.device)) for a in names], dim=1
                ))
        if actions is None:
            act_g = list(zero_actions_grouped(self.spec, obs_g[0].shape[0], discrete, self.device))
        return GroupedBatch(obs=tuple(obs_g), actions=tuple(act_g))

    # ------------------------------------------------------------- loading
    @classmethod
    def from_checkpoint(
        cls,
        checkpoint_dir: str,
        model_cfg: ModelConfig,
        spec: AgentSpec,
        step: Optional[int] = None,
        device="cuda",
    ) -> "WorldModel":
        """The model of a ``training.experiment`` checkpoint
        (``payload["model"]``), on ``device`` (the card unless the caller
        asks for the CPU)."""
        from mfvae_tpu_torch.training.checkpoint import CheckpointManager
        from mfvae_tpu_torch.training.experiment import resolve_device

        dev = resolve_device(device)
        payload = CheckpointManager(checkpoint_dir).restore(step)
        if payload is None:
            raise FileNotFoundError(f"no checkpoint in {checkpoint_dir}")
        model = MAVAE.from_config(model_cfg, spec, device=dev)
        model.load_state_dict(payload["model"])
        return cls(model)
