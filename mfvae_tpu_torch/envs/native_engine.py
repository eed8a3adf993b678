"""Batched host MPE engine over the repo's C++ core
(``native/mpe_engine.cpp``; mirror of ``mfvae_tpu/envs/native_engine.py``).

A structure-of-arrays engine for all four MPE scenarios, batched over
environments with a worker pool, stepping in microseconds on the host.  It
is the host backend's env (``envs/host_adapter.py``): transitions are made
on the CPU while the card trains.  The library is built by
``utils/native_build.py`` with the JAX package's flags, so both packages
step the same code to the same bits.

Fidelity: the engine implements the published MPE dynamics of the in-repo
env (``envs/mpe.py``); state-injection tests step both from one state and
compare observations, rewards and done (tests/test_torch_host.py).

Two surfaces:

- ``NativeSimpleTagEnv`` (and the spread, adversary and world_comm
  classes): the batched array API (``reset() -> obs``,
  ``step(actions) -> (obs, rew, done)``).
- ``NativeHostEnv`` (and its subclasses): one env behind the PettingZoo
  parallel API, for ``envs/host_adapter.py`` ``create_env``.  Its spaces are
  the port's ``envs/spaces.py`` ``Box``/``Discrete``, not gymnasium's.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np

from mfvae_tpu_torch.envs.spaces import Box, Discrete
from mfvae_tpu_torch.utils.native_build import load_cached

_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _get_lib() -> Optional[ctypes.CDLL]:
    lib = load_cached("mpe_engine.cpp")
    if lib is None or getattr(lib, "_mpe_configured", False):
        return lib
    c = ctypes
    lib.mpe_create.restype = c.c_void_p
    lib.mpe_create.argtypes = [c.c_int32] * 5 + [c.c_uint64, c.c_int32]
    lib.mpe_create_spread.restype = c.c_void_p
    lib.mpe_create_spread.argtypes = [c.c_int32] * 3 + [c.c_uint64, c.c_int32]
    lib.mpe_create_worldcomm.restype = c.c_void_p
    lib.mpe_create_worldcomm.argtypes = [c.c_int32] * 8 + [c.c_uint64, c.c_int32]
    lib.mpe_create_adversary.restype = c.c_void_p
    lib.mpe_create_adversary.argtypes = [c.c_int32] * 3 + [c.c_uint64, c.c_int32]
    lib.mpe_get_goal.restype = c.c_int32
    lib.mpe_get_goal.argtypes = [c.c_void_p, c.c_int32]
    lib.mpe_set_goal.argtypes = [c.c_void_p, c.c_int32, c.c_int32]
    lib.mpe_obs_dim_lead.restype = c.c_int32
    lib.mpe_obs_dim_lead.argtypes = [c.c_void_p]
    lib.mpe_get_comm.argtypes = [c.c_void_p, c.c_int32, _F32]
    lib.mpe_set_comm.argtypes = [c.c_void_p, c.c_int32, _F32]
    lib.mpe_destroy.argtypes = [c.c_void_p]
    for fn in (lib.mpe_obs_dim_adv, lib.mpe_obs_dim_good, lib.mpe_obs_stride):
        fn.restype = c.c_int32
        fn.argtypes = [c.c_void_p]
    lib.mpe_reset.argtypes = [c.c_void_p, _F32]
    lib.mpe_reset_masked.argtypes = [c.c_void_p, _U8]
    lib.mpe_observe.argtypes = [c.c_void_p, _F32]
    lib.mpe_step.argtypes = [c.c_void_p, _I32, _F32, _F32, _U8, c.c_int32]
    lib.mpe_step_cont.restype = c.c_int32
    lib.mpe_step_cont.argtypes = [c.c_void_p, _F32, _F32, _F32, _U8, c.c_int32]
    lib.mpe_get_state.argtypes = [
        c.c_void_p, c.c_int32, _F32, _F32, _F32, c.POINTER(c.c_int32)
    ]
    lib.mpe_get_positions.argtypes = [c.c_void_p, _F32]
    lib.mpe_get_landmarks.argtypes = [c.c_void_p, _F32]
    lib.mpe_get_goals.argtypes = [c.c_void_p, _I32]
    lib.mpe_set_state.argtypes = [c.c_void_p, c.c_int32, _F32, _F32, _F32, c.c_int32]
    lib._mpe_configured = True
    return lib


def native_engine_available() -> bool:
    return _get_lib() is not None


class NativeSimpleTagEnv:
    """Batched simple_tag on the native engine.

    Agent order matches envs/mpe.py: adversaries first, then good agents.
    ``step`` takes int32 actions [n_envs, A] in [0, 5) and returns
    (obs [n_envs, obs_stride], rewards [n_envs, A], done [n_envs]); split
    per-class views via :meth:`split_obs`.

    Zero-copy contract: ``reset``/``observe``/``step`` return views into
    reusable internal buffers that the NEXT call overwrites — ``.copy()``
    anything retained across calls (NativeBatchedCollector does).
    """

    def __init__(
        self,
        n_envs: int = 1,
        num_good_agents: int = 10,
        num_adversaries: int = 30,
        num_obs: int = 20,
        max_steps: int = 1000,
        seed: int = 0,
        n_threads: int = 0,
        auto_reset: bool = True,
    ):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError(
                "native MPE engine unavailable (no g++ toolchain or build "
                "failed); use envs.mpe.SimpleTagEnv instead"
            )
        self._lib = lib
        self.n_envs = int(n_envs)
        self.num_good_agents = int(num_good_agents)
        self.num_adversaries = int(num_adversaries)
        self.num_obs = int(num_obs)
        self.max_steps = int(max_steps)
        self.num_agents = self.num_adversaries + self.num_good_agents
        self.auto_reset = bool(auto_reset)
        self._h = lib.mpe_create(
            self.n_envs, self.num_good_agents, self.num_adversaries,
            self.num_obs, self.max_steps, seed, n_threads,
        )
        self.obs_dim_adv = int(lib.mpe_obs_dim_adv(self._h))
        self.obs_dim_good = int(lib.mpe_obs_dim_good(self._h))
        self.obs_stride = int(lib.mpe_obs_stride(self._h))
        self._obs = np.empty((self.n_envs, self.obs_stride), np.float32)
        self._rew = np.empty((self.n_envs, self.num_agents), np.float32)
        self._done = np.empty((self.n_envs,), np.uint8)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.mpe_destroy(h)
            self._h = None

    @property
    def agents(self) -> Tuple[str, ...]:
        return tuple(f"adversary_{i}" for i in range(self.num_adversaries)) + tuple(
            f"agent_{i}" for i in range(self.num_good_agents)
        )

    # ------------------------------------------------------------- core API
    def reset(self) -> np.ndarray:
        self._lib.mpe_reset(self._h, self._obs)
        return self._obs

    def reset_where(self, mask: np.ndarray) -> None:
        self._lib.mpe_reset_masked(self._h, np.ascontiguousarray(mask, np.uint8))

    def observe(self) -> np.ndarray:
        self._lib.mpe_observe(self._h, self._obs)
        return self._obs

    def step(self, actions: np.ndarray):
        """actions: [n_envs, A] integer (any int dtype)."""
        acts = np.ascontiguousarray(actions, np.int32)
        if acts.shape != (self.n_envs, self.num_agents):
            raise ValueError(
                f"actions shape {acts.shape} != {(self.n_envs, self.num_agents)}"
            )
        # the C core indexes a 5-entry direction table without a bounds
        # check; out-of-range actions would be undefined behavior
        if acts.size and (acts.min() < 0 or acts.max() >= 5):
            raise ValueError(
                f"actions must be in [0, 5); got range "
                f"[{acts.min()}, {acts.max()}]"
            )
        self._lib.mpe_step(
            self._h, acts, self._obs, self._rew, self._done,
            1 if self.auto_reset else 0,
        )
        return self._obs, self._rew, self._done.astype(bool)

    def get_positions(self) -> np.ndarray:
        """All envs' agent positions [n_envs, A, 2] in one native call
        (for host-side scripted policies)."""
        out = np.empty((self.n_envs, self.num_agents, 2), np.float32)
        self._lib.mpe_get_positions(self._h, out)
        return out

    def get_landmarks(self) -> np.ndarray:
        """All envs' landmark positions [n_envs, L, 2] in one call.
        L = num_obs (tag), num_good_agents (adversary), num_agents
        (spread) — resolved from whichever attribute the class carries."""
        n_lmk = getattr(self, "num_obs", None)
        if n_lmk is None:
            n_lmk = getattr(self, "num_good_agents", self.num_agents)
        out = np.empty((self.n_envs, int(n_lmk), 2), np.float32)
        self._lib.mpe_get_landmarks(self._h, out)
        return out

    def step_continuous(self, actions: np.ndarray):
        """Continuous actions [n_envs, A, 2] float (the 2-d force
        direction, scaled by each agent's accel — the MPE envs'
        discrete_actions=False semantics)."""
        acts = np.ascontiguousarray(actions, np.float32)
        if acts.shape != (self.n_envs, self.num_agents, 2):
            raise ValueError(
                f"continuous actions shape {acts.shape} != "
                f"{(self.n_envs, self.num_agents, 2)}"
            )
        rc = self._lib.mpe_step_cont(
            self._h, acts, self._obs, self._rew, self._done,
            1 if self.auto_reset else 0,
        )
        if rc != 0:
            raise ValueError("continuous actions unsupported for this scenario")
        return self._obs, self._rew, self._done.astype(bool)

    def split_obs(self, obs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """[n_envs, obs_stride] -> (adversary [n_envs, n_adv, d_adv],
        good [n_envs, n_good, d_good]) views."""
        cut = self.num_adversaries * self.obs_dim_adv
        adv = obs[:, :cut].reshape(-1, self.num_adversaries, self.obs_dim_adv)
        good = obs[:, cut:].reshape(-1, self.num_good_agents, self.obs_dim_good)
        return adv, good

    def named_obs(self, flat: np.ndarray) -> Dict[str, np.ndarray]:
        """[n_envs, obs_stride] -> {agent: [n_envs, D_a]} views."""
        adv, good = self.split_obs(flat)
        out = {}
        for i in range(self.num_adversaries):
            out[f"adversary_{i}"] = adv[:, i]
        for i in range(self.num_good_agents):
            out[f"agent_{i}"] = good[:, i]
        return out

    @property
    def action_highs(self) -> np.ndarray:
        """Exclusive upper action bound per agent (for random collection)."""
        return np.full((self.num_agents,), 5, np.int64)

    # ------------------------------------------------- state injection (tests)
    def get_state(self, env: int = 0):
        pos = np.empty((self.num_agents, 2), np.float32)
        vel = np.empty((self.num_agents, 2), np.float32)
        lmk = np.empty((self.num_obs, 2), np.float32)
        step = ctypes.c_int32(0)
        self._lib.mpe_get_state(self._h, env, pos, vel, lmk, ctypes.byref(step))
        return pos, vel, lmk, int(step.value)

    def set_state(self, env: int, pos, vel, lmk, step: int = 0) -> None:
        self._lib.mpe_set_state(
            self._h, env,
            np.ascontiguousarray(pos, np.float32),
            np.ascontiguousarray(vel, np.float32),
            np.ascontiguousarray(lmk, np.float32),
            int(step),
        )


class NativeSimpleSpreadEnv:
    """Batched simple_spread on the native engine (homogeneous agents; one
    obs class of width 4 + 2L + 4(A-1)).  Same zero-copy contract and
    surface as NativeSimpleTagEnv."""

    def __init__(
        self,
        n_envs: int = 1,
        num_agents: int = 3,
        max_steps: int = 25,
        seed: int = 0,
        n_threads: int = 0,
        auto_reset: bool = True,
    ):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError(
                "native MPE engine unavailable (no g++ toolchain or build "
                "failed); use envs.mpe.SimpleSpreadEnv instead"
            )
        self._lib = lib
        self.n_envs = int(n_envs)
        self.num_agents = int(num_agents)
        self.max_steps = int(max_steps)
        self.auto_reset = bool(auto_reset)
        self._h = lib.mpe_create_spread(
            self.n_envs, self.num_agents, self.max_steps, seed, n_threads
        )
        self.obs_dim = int(lib.mpe_obs_dim_good(self._h))
        self.obs_stride = int(lib.mpe_obs_stride(self._h))
        self._obs = np.empty((self.n_envs, self.obs_stride), np.float32)
        self._rew = np.empty((self.n_envs, self.num_agents), np.float32)
        self._done = np.empty((self.n_envs,), np.uint8)

    __del__ = NativeSimpleTagEnv.__del__
    reset = NativeSimpleTagEnv.reset
    reset_where = NativeSimpleTagEnv.reset_where
    observe = NativeSimpleTagEnv.observe
    step = NativeSimpleTagEnv.step
    step_continuous = NativeSimpleTagEnv.step_continuous
    get_positions = NativeSimpleTagEnv.get_positions
    get_landmarks = NativeSimpleTagEnv.get_landmarks

    @property
    def agents(self) -> Tuple[str, ...]:
        return tuple(f"agent_{i}" for i in range(self.num_agents))

    def split_obs(self, obs: np.ndarray) -> np.ndarray:
        """[n_envs, obs_stride] -> [n_envs, A, obs_dim] view."""
        return obs.reshape(-1, self.num_agents, self.obs_dim)

    def named_obs(self, flat: np.ndarray) -> Dict[str, np.ndarray]:
        rows = self.split_obs(flat)
        return {a: rows[:, i] for i, a in enumerate(self.agents)}

    @property
    def action_highs(self) -> np.ndarray:
        return np.full((self.num_agents,), 5, np.int64)

    def get_state(self, env: int = 0):
        pos = np.empty((self.num_agents, 2), np.float32)
        vel = np.empty((self.num_agents, 2), np.float32)
        lmk = np.empty((self.num_agents, 2), np.float32)  # L == A
        step = ctypes.c_int32(0)
        self._lib.mpe_get_state(self._h, env, pos, vel, lmk, ctypes.byref(step))
        return pos, vel, lmk, int(step.value)

    set_state = NativeSimpleTagEnv.set_state


class NativeSimpleAdversaryEnv:
    """Batched simple_adversary on the native engine: 1 adversary (agent 0,
    obs 2L+2(A-1)) + N good agents (+2 goal_rel channel), N landmarks, one
    being the per-env goal re-chosen at each reset.  Same zero-copy
    contract and surface as NativeSimpleTagEnv."""

    def __init__(
        self,
        n_envs: int = 1,
        num_good_agents: int = 2,
        max_steps: int = 25,
        seed: int = 0,
        n_threads: int = 0,
        auto_reset: bool = True,
    ):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError(
                "native MPE engine unavailable (no g++ toolchain or build "
                "failed); use envs.mpe.SimpleAdversaryEnv instead"
            )
        self._lib = lib
        self.n_envs = int(n_envs)
        self.num_good_agents = int(num_good_agents)
        self.num_adversaries = 1
        self.max_steps = int(max_steps)
        self.num_agents = self.num_good_agents + 1
        self.auto_reset = bool(auto_reset)
        self._h = lib.mpe_create_adversary(
            self.n_envs, self.num_good_agents, self.max_steps, seed, n_threads
        )
        self.obs_dim_adv = int(lib.mpe_obs_dim_adv(self._h))
        self.obs_dim_good = int(lib.mpe_obs_dim_good(self._h))
        self.obs_stride = int(lib.mpe_obs_stride(self._h))
        self._obs = np.empty((self.n_envs, self.obs_stride), np.float32)
        self._rew = np.empty((self.n_envs, self.num_agents), np.float32)
        self._done = np.empty((self.n_envs,), np.uint8)

    # everything shape-generic is borrowed from the tag class (with
    # num_adversaries = 1 the agents/split_obs/named_obs/action_highs
    # logic is identical)
    __del__ = NativeSimpleTagEnv.__del__
    reset = NativeSimpleTagEnv.reset
    reset_where = NativeSimpleTagEnv.reset_where
    observe = NativeSimpleTagEnv.observe
    step = NativeSimpleTagEnv.step
    step_continuous = NativeSimpleTagEnv.step_continuous
    agents = NativeSimpleTagEnv.agents
    split_obs = NativeSimpleTagEnv.split_obs
    named_obs = NativeSimpleTagEnv.named_obs
    action_highs = NativeSimpleTagEnv.action_highs
    get_positions = NativeSimpleTagEnv.get_positions
    get_landmarks = NativeSimpleTagEnv.get_landmarks

    def get_state(self, env: int = 0):
        """(pos, vel, lmk, step, goal) — the goal index IS scenario state
        and must round-trip with the rest for checkpoint/injection."""
        pos = np.empty((self.num_agents, 2), np.float32)
        vel = np.empty((self.num_agents, 2), np.float32)
        lmk = np.empty((self.num_good_agents, 2), np.float32)  # L == N good
        step = ctypes.c_int32(0)
        self._lib.mpe_get_state(self._h, env, pos, vel, lmk, ctypes.byref(step))
        return pos, vel, lmk, int(step.value), self.get_goal(env)

    def set_state(self, env: int, pos, vel, lmk, step: int = 0,
                  goal: int = None) -> None:
        NativeSimpleTagEnv.set_state(self, env, pos, vel, lmk, step)
        if goal is not None:
            self.set_goal(goal, env=env)

    def get_goals(self) -> np.ndarray:
        """All envs' goal landmark indices [n_envs] in one call."""
        out = np.empty((self.n_envs,), np.int32)
        self._lib.mpe_get_goals(self._h, out)
        return out

    def get_goal(self, env: int = 0) -> int:
        return int(self._lib.mpe_get_goal(self._h, env))

    def set_goal(self, goal: int, env: int = 0) -> None:
        # the C core indexes s.lmk[2*goal] without a bounds check;
        # out-of-range goals would be undefined behavior
        goal = int(goal)
        if not 0 <= goal < self.num_good_agents:
            raise ValueError(
                f"goal must be in [0, {self.num_good_agents}); got {goal}"
            )
        self._lib.mpe_set_goal(self._h, env, goal)


class NativeSimpleWorldCommEnv:
    """Batched simple_world_comm on the native engine (leader comm channel,
    food, forest-visibility masking).  Agent order: leadadversary_0,
    adversary_0..n-2, agent_0..G-1.  The leader's action is in
    [0, 5*dim_c) = movement (a % 5) x comm (a // 5); everyone else [0, 5).
    Same zero-copy contract as NativeSimpleTagEnv."""

    def __init__(
        self,
        n_envs: int = 1,
        num_good_agents: int = 2,
        num_adversaries: int = 4,  # includes the leader
        num_obs: int = 1,
        num_food: int = 2,
        num_forests: int = 2,
        dim_c: int = 4,
        max_steps: int = 25,
        seed: int = 0,
        n_threads: int = 0,
        auto_reset: bool = True,
    ):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError(
                "native MPE engine unavailable (no g++ toolchain or build "
                "failed); use envs.mpe.SimpleWorldCommEnv instead"
            )
        # empty reduction sets in the C reward code would yield +/-inf
        # shaping terms that silently poison training
        if num_good_agents < 1 or num_adversaries < 1 or num_food < 1:
            raise ValueError(
                "simple_world_comm requires >= 1 good agent, adversary, and "
                "food landmark (min-distance shaping reduces over them)"
            )
        if dim_c < 1:
            raise ValueError("dim_c must be >= 1 (the leader channel)")
        self._lib = lib
        self.n_envs = int(n_envs)
        self.num_good_agents = int(num_good_agents)
        self.num_adversaries = int(num_adversaries)
        self.num_obs = int(num_obs)
        self.num_food = int(num_food)
        self.num_forests = int(num_forests)
        self.dim_c = int(dim_c)
        self.max_steps = int(max_steps)
        self.num_agents = self.num_adversaries + self.num_good_agents
        self.num_landmarks = self.num_obs + self.num_food + self.num_forests
        self.auto_reset = bool(auto_reset)
        self._h = lib.mpe_create_worldcomm(
            self.n_envs, self.num_good_agents, self.num_adversaries,
            self.num_obs, self.num_food, self.num_forests, self.dim_c,
            self.max_steps, seed, n_threads,
        )
        self.obs_dim_lead = int(lib.mpe_obs_dim_lead(self._h))
        self.obs_dim_adv = int(lib.mpe_obs_dim_adv(self._h))
        self.obs_dim_good = int(lib.mpe_obs_dim_good(self._h))
        self.obs_stride = int(lib.mpe_obs_stride(self._h))
        self._obs = np.empty((self.n_envs, self.obs_stride), np.float32)
        self._rew = np.empty((self.n_envs, self.num_agents), np.float32)
        self._done = np.empty((self.n_envs,), np.uint8)

    __del__ = NativeSimpleTagEnv.__del__
    reset = NativeSimpleTagEnv.reset
    reset_where = NativeSimpleTagEnv.reset_where
    observe = NativeSimpleTagEnv.observe

    @property
    def agents(self) -> Tuple[str, ...]:
        return (
            ("leadadversary_0",)
            + tuple(f"adversary_{i}" for i in range(self.num_adversaries - 1))
            + tuple(f"agent_{i}" for i in range(self.num_good_agents))
        )

    def step(self, actions: np.ndarray):
        """actions: [n_envs, A]; column 0 (leader) in [0, 5*dim_c), rest
        in [0, 5)."""
        acts = np.ascontiguousarray(actions, np.int32)
        if acts.shape != (self.n_envs, self.num_agents):
            raise ValueError(
                f"actions shape {acts.shape} != {(self.n_envs, self.num_agents)}"
            )
        lead, rest = acts[:, 0], acts[:, 1:]
        if acts.size and (
            lead.min() < 0
            or lead.max() >= 5 * self.dim_c
            or (rest.size and (rest.min() < 0 or rest.max() >= 5))
        ):
            raise ValueError(
                f"leader action must be in [0, {5 * self.dim_c}), others in "
                f"[0, 5)"
            )
        self._lib.mpe_step(
            self._h, acts, self._obs, self._rew, self._done,
            1 if self.auto_reset else 0,
        )
        return self._obs, self._rew, self._done.astype(bool)

    def split_obs(self, obs: np.ndarray):
        """[n_envs, stride] -> (lead [n_envs, 1, d_lead],
        adversary [n_envs, n_adv-1, d_adv], good [n_envs, G, d_good])."""
        c1 = self.obs_dim_lead
        c2 = c1 + (self.num_adversaries - 1) * self.obs_dim_adv
        lead = obs[:, :c1].reshape(-1, 1, self.obs_dim_lead)
        adv = obs[:, c1:c2].reshape(-1, self.num_adversaries - 1, self.obs_dim_adv)
        good = obs[:, c2:].reshape(-1, self.num_good_agents, self.obs_dim_good)
        return lead, adv, good

    def named_obs(self, flat: np.ndarray) -> Dict[str, np.ndarray]:
        lead, adv, good = self.split_obs(flat)
        out = {"leadadversary_0": lead[:, 0]}
        for i in range(self.num_adversaries - 1):
            out[f"adversary_{i}"] = adv[:, i]
        for i in range(self.num_good_agents):
            out[f"agent_{i}"] = good[:, i]
        return out

    @property
    def action_highs(self) -> np.ndarray:
        highs = np.full((self.num_agents,), 5, np.int64)
        highs[0] = 5 * self.dim_c  # leader: movement x comm
        return highs

    def get_state(self, env: int = 0):
        """(pos, vel, lmk, step, comm) — the shared (pos, vel, lmk, step)
        prefix keeps index 3 = step across all scenario classes; the
        leader channel is appended."""
        pos = np.empty((self.num_agents, 2), np.float32)
        vel = np.empty((self.num_agents, 2), np.float32)
        lmk = np.empty((self.num_landmarks, 2), np.float32)
        comm = np.empty((self.dim_c,), np.float32)
        step = ctypes.c_int32(0)
        self._lib.mpe_get_state(self._h, env, pos, vel, lmk, ctypes.byref(step))
        self._lib.mpe_get_comm(self._h, env, comm)
        return pos, vel, lmk, int(step.value), comm

    def set_state(self, env: int, pos, vel, lmk, comm=None, step: int = 0) -> None:
        NativeSimpleTagEnv.set_state(self, env, pos, vel, lmk, step)
        if comm is not None:
            self._lib.mpe_set_comm(
                self._h, env, np.ascontiguousarray(comm, np.float32)
            )


class NativeHostEnv:
    """PettingZoo parallel-API adapter over one native env — the same
    surface the reference's host path consumes (torch_ver/src/env.py:24-39:
    reset(seed) -> (obs, infos), step(actions) -> (obs, rewards,
    terminations, truncations, infos), agents, observation_space /
    action_space)."""

    def __init__(self, num_good, num_adversaries, num_obstacles, max_cycles,
                 seed=0, continuous=False):
        self._cls = NativeSimpleTagEnv
        self._ctor = dict(
            n_envs=1,
            num_good_agents=num_good,
            num_adversaries=num_adversaries,
            num_obs=num_obstacles,
            max_steps=max_cycles,
            n_threads=1,
            auto_reset=False,
        )
        self.continuous = continuous
        self._env = self._cls(seed=seed, **self._ctor)
        self.agents = list(self._env.agents)

    def observation_space(self, agent):
        d = (
            self._env.obs_dim_adv
            if agent.startswith("adversary")
            else self._env.obs_dim_good
        )
        return Box(-np.inf, np.inf, (d,))

    def action_space(self, agent):
        if self.continuous:
            # the MPE envs' continuous contract (envs/mpe.py):
            # 2-d force in [-1, 1], stepped via the engine's mpe_step_cont
            return Box(-1.0, 1.0, (2,))
        return Discrete(5)

    def _obs_dict(self, flat: np.ndarray) -> Dict[str, np.ndarray]:
        adv, good = self._env.split_obs(flat)
        out = {}
        for i in range(self._env.num_adversaries):
            out[f"adversary_{i}"] = adv[0, i].copy()
        for i in range(self._env.num_good_agents):
            out[f"agent_{i}"] = good[0, i].copy()
        return out

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            # honor the PettingZoo contract: reset(seed=s) must reproduce
            # the episode; the engine rng is per-instance, so rebuild
            self._env = self._cls(seed=seed, **self._ctor)
        obs = self._env.reset()
        return self._obs_dict(obs), {a: {} for a in self.agents}

    def pursuit_inputs(self):
        """(kind, pos [A,2], n_adv, goal_pos) for the host pursuit policy
        (envs/policies.py host_pursuit_actions), or None when the scenario
        has no scripted policy.  Whitelist by engine class: a future
        scenario adapter that subclasses this one must opt IN, not
        remember to opt out (scenario ordering assumptions differ)."""
        if type(self._env) is not NativeSimpleTagEnv:
            return None
        pos = self._env.get_state(0)[0]
        return "tag", pos, self._env.num_adversaries, None

    def step(self, actions: Dict[str, int]):
        if self.continuous:
            acts = np.asarray(
                [[np.asarray(actions[a], np.float32) for a in self.agents]],
                np.float32,
            )
            obs, rew, done = self._env.step_continuous(acts)
        else:
            acts = np.asarray(
                [[int(actions[a]) for a in self.agents]], np.int32
            )
            obs, rew, done = self._env.step(acts)
        obs_d = self._obs_dict(obs)
        rewards = {a: float(rew[0, i]) for i, a in enumerate(self.agents)}
        truncs = {a: bool(done[0]) for a in self.agents}  # time-limit only
        terms = {a: False for a in self.agents}
        # no internal auto-reset: the PettingZoo contract has the caller
        # reset after truncation (AsyncCollector._one_step does)
        return obs_d, rewards, terms, truncs, {a: {} for a in self.agents}


class NativeWorldCommHostEnv(NativeHostEnv):
    """PettingZoo parallel-API adapter over one native simple_world_comm
    env (leader action space Discrete(5*dim_c), others Discrete(5))."""

    def __init__(self, num_good=2, num_adversaries=4, num_obstacles=1,
                 max_cycles=25, seed=0):
        # discrete-only by design, matching the reference path (the
        # leader's communication channel has no continuous form)
        self.continuous = False
        self._cls = NativeSimpleWorldCommEnv
        self._ctor = dict(
            n_envs=1,
            num_good_agents=num_good,
            num_adversaries=num_adversaries,
            num_obs=num_obstacles,
            max_steps=max_cycles,
            n_threads=1,
            auto_reset=False,
        )
        self._env = self._cls(seed=seed, **self._ctor)
        self.agents = list(self._env.agents)

    def observation_space(self, agent):
        env = self._env
        d = (
            env.obs_dim_lead
            if agent.startswith("leadadversary")
            else env.obs_dim_adv
            if agent.startswith("adversary")
            else env.obs_dim_good
        )
        return Box(-np.inf, np.inf, (d,))

    def action_space(self, agent):
        n = 5 * self._env.dim_c if agent.startswith("leadadversary") else 5
        return Discrete(n)

    def _obs_dict(self, flat: np.ndarray) -> Dict[str, np.ndarray]:
        lead, adv, good = self._env.split_obs(flat)
        out = {"leadadversary_0": lead[0, 0].copy()}
        for i in range(self._env.num_adversaries - 1):
            out[f"adversary_{i}"] = adv[0, i].copy()
        for i in range(self._env.num_good_agents):
            out[f"agent_{i}"] = good[0, i].copy()
        return out


class NativeAdversaryHostEnv(NativeHostEnv):
    """PettingZoo parallel-API adapter over one native simple_adversary
    env (adversary_0 lacks the 2-wide goal_rel channel the good agents
    have)."""

    def __init__(self, num_good=2, max_cycles=25, seed=0, continuous=False):
        self._cls = NativeSimpleAdversaryEnv
        self._ctor = dict(
            n_envs=1,
            num_good_agents=num_good,
            max_steps=max_cycles,
            n_threads=1,
            auto_reset=False,
        )
        self.continuous = continuous
        self._env = self._cls(seed=seed, **self._ctor)
        self.agents = list(self._env.agents)
    # observation_space inherited: the adversary/good width dispatch in
    # NativeHostEnv.observation_space is exactly what this scenario needs

    def pursuit_inputs(self):
        pos, _, lmk, _, goal = self._env.get_state(0)
        return "adversary", pos, 1, lmk[goal]


class NativeSpreadHostEnv(NativeHostEnv):
    """PettingZoo parallel-API adapter over one native simple_spread env."""

    def __init__(self, num_agents=3, max_cycles=25, seed=0, continuous=False):
        self._cls = NativeSimpleSpreadEnv
        self._ctor = dict(
            n_envs=1,
            num_agents=num_agents,
            max_steps=max_cycles,
            n_threads=1,
            auto_reset=False,
        )
        self.continuous = continuous
        self._env = self._cls(seed=seed, **self._ctor)
        self.agents = list(self._env.agents)

    def observation_space(self, agent):
        return Box(-np.inf, np.inf, (self._env.obs_dim,))

    def _obs_dict(self, flat: np.ndarray) -> Dict[str, np.ndarray]:
        rows = self._env.split_obs(flat)
        return {a: rows[0, i].copy() for i, a in enumerate(self.agents)}
