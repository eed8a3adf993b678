"""Host env path (mirror of ``mfvae_tpu/envs/host_adapter.py``).

``create_env`` (the reference's torch_ver/src/env.py:24-39 surface), space
sizing, ``MultiAgentHostBuffer`` (per-agent fields over the host ring,
``data/host_buffer.py``) and the collectors that step host envs into it:
``AsyncCollector`` over one PettingZoo-API env, ``NativeBatchedCollector``
over K native envs in one call.  A collector can run on a background
thread, so the card trains while the host steps physics
(``training/host_experiment.py``).

Nothing here needs gymnasium or PettingZoo.  Spaces are sized by duck
typing (``.n``; Box's ``.shape[0]``; the flat size of other shapes), so a
PettingZoo env works where one is installed, and the port's own spaces
(``envs/spaces.py``) serve the native and local envs.  The collectors
draw from ``numpy.random.default_rng(seed)`` in the JAX package's order:
a synchronous ``collect(n)`` fills the ring as the JAX package's does.
"""

from __future__ import annotations

import importlib
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from mfvae_tpu_torch.data.host_buffer import HostRingBuffer
from mfvae_tpu_torch.envs import native_engine as ne
from mfvae_tpu_torch.envs.policies import host_pursuit_actions


def _is_box(space) -> bool:
    return hasattr(space, "low") and hasattr(space, "high")


def get_space_size(space) -> int:
    """Discrete -> n, Box -> shape[0], MultiBinary -> its flat size
    (torch_ver/src/env.py:6-21), by duck typing: a Discrete has a scalar
    ``n`` and no shape (gymnasium's MultiBinary has ``n`` too, its shape)."""
    if hasattr(space, "n") and not getattr(space, "shape", ()):
        return int(space.n)
    if _is_box(space):
        return int(space.shape[0])
    if hasattr(space, "shape"):
        return int(np.prod(space.shape))
    raise NotImplementedError(type(space))


class LocalHostEnv:
    """PettingZoo parallel-API wrapper over the port's MPE envs
    (``envs/mpe.py``, all four scenarios) on the CPU, for where neither
    PettingZoo's MPE nor the native engine is available.  Resets draw from
    a ``torch.Generator``; ``reset(seed)`` reseeds it."""

    def __init__(self, env_name, num_good, num_adversaries, num_obstacles, max_cycles, discrete=True):
        from mfvae_tpu_torch.envs.mpe import make

        self._env = make(
            f"MPE_{env_name}",
            device="cpu",
            num_good_agents=num_good,
            num_adversaries=num_adversaries,
            num_obs=num_obstacles,
            max_steps=max_cycles,
            discrete_actions=discrete,
        )
        self.agents = list(self._env.agents)
        self._state = None
        self._generator = torch.Generator().manual_seed(0)

    def observation_space(self, agent):
        return self._env.observation_space(agent)

    def action_space(self, agent):
        return self._env.action_space(agent)

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._generator.manual_seed(seed)
        obs, self._state = self._env.reset(self._generator)
        return {a: o.numpy() for a, o in obs.items()}, {a: {} for a in self.agents}

    def step(self, actions):
        acts = {a: torch.as_tensor(np.asarray(v)) for a, v in actions.items()}
        obs, self._state, rew, done, _ = self._env.step(self._state, acts)
        obs = {a: o.numpy() for a, o in obs.items()}
        rewards = {a: float(rew[a]) for a in self.agents}
        truncs = {a: bool(done[a]) for a in self.agents}  # time-limit only
        terms = {a: False for a in self.agents}
        return obs, rewards, terms, truncs, {a: {} for a in self.agents}

    def pursuit_inputs(self):
        """Host pursuit-policy inputs (``envs/policies.py``
        ``host_pursuit_actions``) from the wrapped env's state, or None for
        scenarios without a scripted policy."""
        from mfvae_tpu_torch.envs.mpe import SimpleAdversaryEnv, SimpleTagEnv

        if self._state is None:
            return None
        pos = self._state.agent_pos.numpy()
        if isinstance(self._env, SimpleTagEnv):
            return "tag", pos, self._env.num_adversaries, None
        if isinstance(self._env, SimpleAdversaryEnv):
            lmk = self._state.landmark_pos.numpy()
            return "adversary", pos, 1, lmk[int(self._state.goal)]
        return None


def create_env(
    env_name: str = "simple_tag_v3",
    num_good: int = 10,
    num_adversaries: int = 30,
    num_obstacles: int = 20,
    max_cycles: int = 1000,
    seed: int = 42,
    discrete: bool = True,
    scripted_policy: bool = False,
):
    """Host env factory, -> (env, obs_dims, act_dims, obs, infos).

    In the JAX package's order: PettingZoo's MPE (``pettingzoo.mpe`` or
    ``mpe2``) where installed, for discrete simple_tag under random
    collection only; else the native C++ engine (``envs/native_engine.py``);
    else ``LocalHostEnv``.  The other scenarios, continuous actions and
    scripted collection skip PettingZoo: its simple_spread scales rewards
    otherwise, its continuous actions are a 5-channel Box, and the
    scripted policy reads the in-repo envs' state (``pursuit_inputs``).
    simple_world_comm is discrete-only."""
    if env_name not in ("simple_tag_v3", "simple_spread_v3", "simple_world_comm_v3", "simple_adversary_v3"):
        raise NotImplementedError(env_name)
    spread = env_name == "simple_spread_v3"
    world_comm = env_name == "simple_world_comm_v3"
    adversary = env_name == "simple_adversary_v3"
    if world_comm and not discrete:
        raise NotImplementedError(
            "simple_world_comm is discrete-only (the leader's communication "
            "channel has no continuous form)"
        )
    env = None
    if not (spread or world_comm or adversary) and discrete and not scripted_policy:
        for modname in ("pettingzoo.mpe", "mpe2"):
            try:
                mod = importlib.import_module(f"{modname}.{env_name}")
            except ImportError:
                continue
            env = mod.parallel_env(
                num_good=num_good,
                num_adversaries=num_adversaries,
                num_obstacles=num_obstacles,
                max_cycles=max_cycles,
                continuous_actions=False,
            )
            break
    if env is None:
        if ne.native_engine_available():
            if adversary:
                env = ne.NativeAdversaryHostEnv(num_good, max_cycles, seed=seed, continuous=not discrete)
            elif spread:
                env = ne.NativeSpreadHostEnv(num_good, max_cycles, seed=seed, continuous=not discrete)
            elif world_comm:
                env = ne.NativeWorldCommHostEnv(num_good, num_adversaries, num_obstacles, max_cycles, seed=seed)
            else:
                env = ne.NativeHostEnv(
                    num_good, num_adversaries, num_obstacles, max_cycles, seed=seed, continuous=not discrete
                )
        else:
            env = LocalHostEnv(env_name, num_good, num_adversaries, num_obstacles, max_cycles, discrete=discrete)
    obs, infos = env.reset(seed=seed)
    obs_dims = {a: get_space_size(env.observation_space(a)) for a in env.agents}
    act_dims = {a: get_space_size(env.action_space(a)) for a in env.agents}
    return env, obs_dims, act_dims, obs, infos


def create_transition(obs, action, next_obs, done, rew):
    """Stack per-agent dicts into arrays (torch_ver/src/env.py:42-57):
    -> (obs_all, action_all, next_obs_all, done_all, rew).  Needs one obs
    width across agents."""
    agents = list(obs.keys())
    obs_all = np.array([obs[a] for a in agents])
    action_all = np.array([action[a] for a in agents])
    next_obs_all = np.array([next_obs[a] for a in agents])
    done_all = any(bool(v) for v in done.values())
    return obs_all, action_all, next_obs_all, done_all, rew


class MultiAgentHostBuffer:
    """Per-agent transition store over the host ring (the reference's
    torch_ver/src/replay_buffer.py schema: ``{agent}_observations``,
    ``_next_observations``, ``_actions``, ``_rewards``, ``_terminals``,
    ``_truncations`` and ``mask``).  A Box action space stores float32
    vectors, any other space a scalar int64."""

    def __init__(self, env, max_size: int = 10_000, batch_size: int = 128, seed: int = 0):
        self.batch_size = batch_size
        self.agents = list(env.agents)
        self._act_dtypes = {}
        schema = {}
        for a in self.agents:
            od = get_space_size(env.observation_space(a))
            aspace = env.action_space(a)
            if _is_box(aspace):
                act_shape, act_dtype = (int(aspace.shape[0]),), np.float32
            else:
                act_shape, act_dtype = (), np.int64
            self._act_dtypes[a] = act_dtype
            schema[f"{a}_observations"] = ((od,), np.float32)
            schema[f"{a}_next_observations"] = ((od,), np.float32)
            schema[f"{a}_actions"] = (act_shape, act_dtype)
            schema[f"{a}_rewards"] = ((1,), np.float32)
            schema[f"{a}_terminals"] = ((1,), np.float32)
            schema[f"{a}_truncations"] = ((1,), np.float32)
        schema["mask"] = ((1,), np.float32)
        self.buffer = HostRingBuffer(schema, capacity=max_size, seed=seed)

    def add(self, obs, actions, rewards, next_obs, terminals, truncations) -> None:
        item = {}
        for a in self.agents:
            item[f"{a}_observations"] = np.asarray(obs[a], np.float32)
            item[f"{a}_next_observations"] = np.asarray(next_obs[a], np.float32)
            item[f"{a}_actions"] = np.asarray(actions[a], self._act_dtypes[a])
            item[f"{a}_rewards"] = np.asarray([rewards[a]], np.float32)
            item[f"{a}_terminals"] = np.asarray([float(terminals[a])], np.float32)
            item[f"{a}_truncations"] = np.asarray([float(truncations[a])], np.float32)
        item["mask"] = np.asarray([1.0], np.float32)
        self.buffer.add(item)

    def sample(self) -> Dict[str, np.ndarray]:
        return self.buffer.sample(self.batch_size)

    def add_batch(self, obs, actions, rewards, next_obs, truncations) -> None:
        """K transitions in one ring call: every argument is {agent: [K,
        ...]} (or [K] for scalars).  Terminals are always 0: the MPE host
        path ends episodes by time limit only."""
        k = len(next(iter(truncations.values())))
        item = {}
        for a in self.agents:
            item[f"{a}_observations"] = np.asarray(obs[a], np.float32)
            item[f"{a}_next_observations"] = np.asarray(next_obs[a], np.float32)
            item[f"{a}_actions"] = np.asarray(actions[a], self._act_dtypes[a])
            item[f"{a}_rewards"] = np.asarray(rewards[a], np.float32).reshape(k, 1)
            item[f"{a}_terminals"] = np.zeros((k, 1), np.float32)
            item[f"{a}_truncations"] = np.asarray(truncations[a], np.float32).reshape(k, 1)
        item["mask"] = np.ones((k, 1), np.float32)
        self.buffer.add(item)

    def on_episode_end(self) -> None:
        """The reference's episode-boundary hook (replay_buffer.py:104-105);
        the flat ring stores whole transitions, so it does nothing."""

    def __len__(self) -> int:
        return len(self.buffer)


class _CollectorLoop:
    """collect/start/stop/wait over ``_one_step`` (which advances
    ``self._steps``).  An exception in the background thread is kept and
    raised again by ``wait_for`` and ``stop``, so a collector that dies
    fails the run instead of leaving it waiting."""

    def __init__(self):
        self._stop = threading.Event()
        self._steps = 0
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _one_step(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def collect(self, n_steps: int) -> int:
        """Synchronous collection of at least ``n_steps`` transitions."""
        target = self._steps + n_steps
        while self._steps < target:
            self._one_step()
        return self._steps

    def start(self, max_steps: Optional[int] = None):
        """Collect on a background thread until ``stop`` (or ``max_steps``).

        The thread gives up the interpreter lock after every step
        (``time.sleep(0)``).  Eager PyTorch releases the lock in every op
        it runs, and a thread that never lets go holds it for the whole
        switch interval (5 ms) each time the training thread asks for it
        back: without the yield, a train step of a tiny config on the CPU
        ran over 100 times slower (PERF.md §6)."""

        self._stop.clear()  # a stopped collector can be started again

        def loop():
            try:
                while not self._stop.is_set():
                    if max_steps is not None and self._steps >= max_steps:
                        break
                    self._one_step()
                    time.sleep(0)
            except BaseException as e:  # noqa: BLE001 - kept for the waiting thread, which raises it
                self._error = e

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def _raise_error(self):
        if self._error is not None:
            raise RuntimeError(f"the host collector thread failed: {self._error!r}") from self._error

    def wait_for(self, target: int) -> float:
        """Block until ``steps`` >= ``target``; -> the seconds waited.
        Raises the thread's exception if it died, and RuntimeError if it
        ended before reaching ``target``."""
        t0 = time.perf_counter()
        while self._steps < target:
            alive = self._thread is not None and self._thread.is_alive()
            self._raise_error()
            if not alive and self._steps < target:
                raise RuntimeError(f"the host collector stopped at {self._steps} of {target} steps")
            time.sleep(0.001)
        return time.perf_counter() - t0

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._raise_error()

    @property
    def steps(self) -> int:
        return self._steps


class AsyncCollector(_CollectorLoop):
    """Steps one host env with random, pursuit, episode_mix or ``vdn:``
    actions into the buffer, on the calling thread (``collect``) or on a
    background thread (``start``).

    ``policy='pursuit'`` uses ``host_pursuit_actions`` on the env's
    ``pursuit_inputs()``; envs without one (PettingZoo, spread,
    world_comm) raise."""

    def __init__(self, env, buffer: MultiAgentHostBuffer, seed: int = 0, policy: str = "random",
                 epsilon: float = 0.1, mix_frac: float = 0.5):
        super().__init__()
        self.env = env
        self.buffer = buffer
        self.rng = np.random.default_rng(seed)
        self.policy = policy
        self.epsilon = float(epsilon)
        self.mix_frac = float(mix_frac)
        self._q_policy = None
        if policy.startswith("vdn:"):
            from mfvae_tpu_torch.baselines.collect_policy import HostQCollectPolicy

            if not hasattr(env.action_space(env.agents[0]), "n"):
                raise ValueError("learned Q-policy collection needs discrete actions")
            self._q_policy = HostQCollectPolicy(
                policy[len("vdn:"):],
                env.agents,
                {a: int(np.prod(env.observation_space(a).shape)) for a in env.agents},
                epsilon,
                self.rng,
            )
        elif policy not in ("random", "pursuit", "episode_mix"):
            raise ValueError(f"unknown collect policy {policy!r}")
        self._obs, _ = env.reset(seed=seed)
        if policy in ("pursuit", "episode_mix") and (
            not hasattr(env, "pursuit_inputs") or env.pursuit_inputs() is None
        ):
            raise ValueError(
                f"{type(env).__name__} has no host pursuit policy (supported: "
                "simple_tag, simple_adversary on the native engine or LocalHostEnv)"
            )
        # episode_mix: whole episodes alternate scripted/random, drawn at
        # every reset; the draw is made for that policy only, so the other
        # policies' streams stay the JAX package's
        self._ep_scripted = bool(self.rng.random() < self.mix_frac) if policy == "episode_mix" else False
        self._discrete = hasattr(env.action_space(env.agents[0]), "n")
        # the reference samples action_space.sample() (torch_ver/main.py:69)
        self._samplers = {}
        for a in env.agents:
            space = env.action_space(a)
            if hasattr(space, "n"):
                self._samplers[a] = lambda n=int(space.n): int(self.rng.integers(0, n))
            else:
                lo, hi, shape = space.low, space.high, space.shape
                self._samplers[a] = lambda lo=lo, hi=hi, shape=shape: self.rng.uniform(
                    lo, hi, size=shape).astype(np.float32)

    def _one_step(self):
        env = self.env
        if self._q_policy is not None:
            acts = self._q_policy.actions(self._obs)[0]  # [N]
            return self._finish_step({a: int(acts[i]) for i, a in enumerate(env.agents)})
        scripted_now = self.policy == "pursuit" or (self.policy == "episode_mix" and self._ep_scripted)
        if scripted_now:
            kind, pos, n_adv, goal_pos = env.pursuit_inputs()
            acts = host_pursuit_actions(kind, pos, n_adv, self.rng, self.epsilon,
                                        discrete=self._discrete, goal_pos=goal_pos)
            actions = {a: (int(acts[i]) if self._discrete else acts[i]) for i, a in enumerate(env.agents)}
        else:
            actions = {a: self._samplers[a]() for a in env.agents}
        self._finish_step(actions)

    def _finish_step(self, actions):
        env = self.env
        next_obs, rewards, terms, truncs, _ = env.step(actions)
        self.buffer.add(self._obs, actions, rewards, next_obs, terms, truncs)
        self._obs = next_obs
        self._steps += 1
        if any(terms.values()) or any(truncs.values()) or not env.agents:
            self._obs, _ = env.reset()
            if self.policy == "episode_mix":
                self._ep_scripted = bool(self.rng.random() < self.mix_frac)
            if self._q_policy is not None:
                self._q_policy.reset()


class NativeBatchedCollector(_CollectorLoop):
    """K native envs stepped as one call per iteration, K transitions into
    the ring in one batched add.  Works with any batched native env through
    its ``named_obs``/``action_highs`` surface: pass ``env=`` (built with
    ``auto_reset=False``), or the tag population kwargs to build
    simple_tag.  ``steps`` counts env transitions, so an epoch's sample
    target means the same at any K."""

    def __init__(
        self,
        buffer: MultiAgentHostBuffer,
        n_envs: Optional[int] = None,
        num_good: Optional[int] = None,
        num_adversaries: Optional[int] = None,
        num_obstacles: Optional[int] = None,
        max_cycles: Optional[int] = None,
        seed: int = 0,
        n_threads: Optional[int] = None,
        env=None,
        continuous: bool = False,
        collect_policy: str = "random",
        epsilon: float = 0.1,
        mix_frac: float = 0.5,
    ):
        super().__init__()
        self.continuous = continuous
        self.collect_policy = collect_policy
        self.epsilon = float(epsilon)
        self.mix_frac = float(mix_frac)
        pop_kwargs = dict(n_envs=n_envs, num_good=num_good, num_adversaries=num_adversaries,
                          num_obstacles=num_obstacles, max_cycles=max_cycles, n_threads=n_threads)
        if env is not None:
            given = [k for k, v in pop_kwargs.items() if v is not None]
            if given:
                raise ValueError(
                    f"env= and population kwargs are mutually exclusive (got env plus {given}); "
                    "configure the env instance instead"
                )
            if env.auto_reset:
                raise ValueError(
                    "NativeBatchedCollector requires auto_reset=False (the terminal obs "
                    "must be recorded as next_obs before the reset)"
                )
        else:
            env = ne.NativeSimpleTagEnv(
                n_envs=16 if n_envs is None else n_envs,
                num_good_agents=10 if num_good is None else num_good,
                num_adversaries=30 if num_adversaries is None else num_adversaries,
                num_obs=20 if num_obstacles is None else num_obstacles,
                max_steps=1000 if max_cycles is None else max_cycles,
                seed=seed,
                n_threads=0 if n_threads is None else n_threads,
                auto_reset=False,
            )
        self.env = env
        self.buffer = buffer
        self.n_envs = env.n_envs
        self.rng = np.random.default_rng(seed)
        self._pursuit_kind = None
        self._q_policy = None
        if collect_policy.startswith("vdn:"):
            if continuous:
                raise ValueError("learned Q-policy collection needs discrete actions")
        elif collect_policy in ("pursuit", "episode_mix"):
            if isinstance(env, ne.NativeSimpleAdversaryEnv):
                self._pursuit_kind, self._pursuit_n_adv = "adversary", 1
            elif isinstance(env, ne.NativeSimpleTagEnv):
                self._pursuit_kind, self._pursuit_n_adv = "tag", env.num_adversaries
            else:
                raise ValueError(
                    f"{type(env).__name__} has no host pursuit policy (supported: simple_tag, simple_adversary)"
                )
        elif collect_policy != "random":
            raise ValueError(f"unknown collect policy {collect_policy!r}")
        self._agents = tuple(env.agents)
        self._action_highs = np.array(env.action_highs)[None, :]
        self._obs = self.env.reset().copy()
        if collect_policy.startswith("vdn:"):
            from mfvae_tpu_torch.baselines.collect_policy import HostQCollectPolicy

            named = env.named_obs(self._obs)  # per-agent widths, no reset
            self._q_policy = HostQCollectPolicy(
                collect_policy[len("vdn:"):],
                env.agents,
                {a: int(v.shape[1]) for a, v in named.items()},
                epsilon,
                self.rng,
                n_envs=env.n_envs,
            )
        if collect_policy == "episode_mix":
            # per-env flags, redrawn wherever an episode resets; drawn for
            # this policy only, as in the JAX package
            self._ep_scripted = self.rng.random(self.n_envs) < self.mix_frac

    def _pursuit_actions(self) -> np.ndarray:
        env = self.env
        pos = env.get_positions()  # [K, A, 2], one native call
        goal_pos = None
        if self._pursuit_kind == "adversary":
            lmk = env.get_landmarks()  # [K, L, 2]
            goal_pos = lmk[np.arange(self.n_envs), env.get_goals()]
        return host_pursuit_actions(self._pursuit_kind, pos, self._pursuit_n_adv, self.rng, self.epsilon,
                                    discrete=not self.continuous, goal_pos=goal_pos)

    def _random_actions(self) -> np.ndarray:
        if self.continuous:
            # uniform in the Box(-1, 1, (2,)) force contract
            return self.rng.uniform(-1.0, 1.0, size=(self.n_envs, self.env.num_agents, 2)).astype(np.float32)
        return self.rng.integers(0, self._action_highs, size=(self.n_envs, self.env.num_agents)).astype(np.int32)

    def _sample_actions(self) -> np.ndarray:
        if self._q_policy is not None:
            return self._q_policy.actions(self.env.named_obs(self._obs))
        if self.collect_policy == "episode_mix":
            scripted = self._pursuit_actions()
            rand = self._random_actions()
            flags = self._ep_scripted.reshape((self.n_envs,) + (1,) * (scripted.ndim - 1))
            return np.where(flags, scripted, rand).astype(scripted.dtype)
        if self._pursuit_kind is not None:
            return self._pursuit_actions()
        return self._random_actions()

    def _one_step(self):
        env = self.env
        agents = self._agents
        acts = self._sample_actions()
        if self.continuous:
            next_obs, rew, done = env.step_continuous(np.ascontiguousarray(acts, np.float32))
        else:
            acts = np.ascontiguousarray(acts, np.int32)
            next_obs, rew, done = env.step(acts)
        self.buffer.add_batch(
            obs=env.named_obs(self._obs),
            actions={a: acts[:, i] for i, a in enumerate(agents)},
            rewards={a: rew[:, i] for i, a in enumerate(agents)},
            next_obs=env.named_obs(next_obs),
            truncations={a: done.astype(np.float32) for a in agents},
        )
        if done.any():
            env.reset_where(done.astype(np.uint8))
            self._obs = env.observe().copy()
            if self.collect_policy == "episode_mix":
                redraw = self.rng.random(self.n_envs) < self.mix_frac
                self._ep_scripted = np.where(done, redraw, self._ep_scripted)
            if self._q_policy is not None:
                self._q_policy.reset(done_mask=done)
        else:
            self._obs = next_obs.copy()
        self._steps += self.n_envs
