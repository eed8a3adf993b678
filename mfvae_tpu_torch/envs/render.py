"""Rendering of the MPE envs (mirror of ``mfvae_tpu/envs/render.py``).

States rasterize to RGB numpy frames, pure numpy with no GUI, and frames
save as PNGs/GIFs through PIL and metric curves plot through matplotlib,
both imported only when called.  A torch state is moved to the CPU and read
as numpy; the rasterizer is the JAX package's, so one state gives the same
frame in both packages, bit for bit.

    env = make("MPE_simple_tag_v3", device="cpu")
    obs, state = env.reset(generator)
    frame = render_state(env, state)                 # [H, W, 3] uint8
    frames = rollout_frames(env, generator, policy)  # list of frames
    save_gif(frames, "episode.gif")                  # needs PIL
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mfvae_tpu_torch.envs import mpe

# MPE convention colors: adversaries red, the leader darker red, good
# agents green, landmarks gray, food (and the adversary scenario's goal)
# blue, forests pale green
ADVERSARY_COLOR = (220, 80, 80)
LEADER_COLOR = (150, 30, 30)
GOOD_COLOR = (80, 190, 100)
LANDMARK_COLOR = (110, 110, 110)
FOOD_COLOR = (70, 100, 220)
FOREST_COLOR = (160, 220, 160)
BACKGROUND = (255, 255, 255)


def _disc(frame: np.ndarray, cx: float, cy: float, radius: float,
          color: Tuple[int, int, int], extent: float, alpha: float = 1.0):
    """Rasterize a filled disc at world (cx, cy) onto the frame in place."""
    h, w, _ = frame.shape
    # world [-extent, extent] -> pixels; y up -> row down
    px = (cx + extent) / (2 * extent) * (w - 1)
    py = (extent - cy) / (2 * extent) * (h - 1)
    pr = radius / (2 * extent) * (w - 1)
    y0, y1 = max(int(py - pr) - 1, 0), min(int(py + pr) + 2, h)
    x0, x1 = max(int(px - pr) - 1, 0), min(int(px + pr) + 2, w)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    mask = (yy - py) ** 2 + (xx - px) ** 2 <= pr * pr
    patch = frame[y0:y1, x0:x1].astype(np.float32)
    col = np.asarray(color, np.float32)
    patch[mask] = (1 - alpha) * patch[mask] + alpha * col
    frame[y0:y1, x0:x1] = patch.astype(np.uint8)


def _numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _entities(env, state) -> List[Tuple[float, float, float, Tuple[int, int, int], float]]:
    """(x, y, radius, color, alpha) per entity, landmarks first (drawn
    under agents)."""
    out = []
    lpos = _numpy(state.landmark_pos)
    if isinstance(env, mpe.SimpleWorldCommEnv):
        for i in range(env.num_obs):
            out.append((*lpos[i], mpe.LANDMARK_SIZE, LANDMARK_COLOR, 1.0))
        for i in range(env.num_obs, env.num_obs + env.num_food):
            out.append((*lpos[i], mpe.FOOD_SIZE, FOOD_COLOR, 1.0))
        for i in range(env.num_obs + env.num_food, env.num_landmarks):
            out.append((*lpos[i], mpe.FOREST_SIZE, FOREST_COLOR, 0.6))
    elif isinstance(env, mpe.SimpleSpreadEnv):
        for i in range(env.num_landmarks):
            out.append((*lpos[i], mpe.SPREAD_LANDMARK_SIZE, LANDMARK_COLOR, 1.0))
    elif isinstance(env, mpe.SimpleAdversaryEnv):
        goal = int(state.goal)
        for i in range(env.num_landmarks):
            color = FOOD_COLOR if i == goal else LANDMARK_COLOR
            out.append((*lpos[i], mpe.ADVERSARY_LANDMARK_SIZE, color, 1.0))
    else:  # simple_tag
        for i in range(env.num_obs):
            out.append((*lpos[i], mpe.LANDMARK_SIZE, LANDMARK_COLOR, 1.0))

    apos = _numpy(state.agent_pos)
    for i, name in enumerate(env.agents):
        if isinstance(env, mpe.SimpleAdversaryEnv):
            color = ADVERSARY_COLOR if name.startswith("adversary") else GOOD_COLOR
            size = mpe.ADVERSARY_AGENT_SIZE
        elif name.startswith("leadadversary"):
            color, size = LEADER_COLOR, mpe.ADV_SIZE
        elif name.startswith("adversary"):
            color, size = ADVERSARY_COLOR, mpe.ADV_SIZE
        elif isinstance(env, mpe.SimpleSpreadEnv):
            color, size = GOOD_COLOR, mpe.SPREAD_AGENT_SIZE
        elif isinstance(env, mpe.SimpleWorldCommEnv):
            color, size = GOOD_COLOR, mpe.GOOD_SIZE_WC
        else:
            color, size = GOOD_COLOR, mpe.GOOD_SIZE
        out.append((*apos[i], size, color, 1.0))
    return out


def render_state(env, state, size: int = 256, extent: float = 1.3) -> np.ndarray:
    """Rasterize one (unbatched) env state to an RGB frame [size, size, 3]
    uint8.  ``extent`` is the world half-width shown (the unit box plus
    margin)."""
    frame = np.full((size, size, 3), BACKGROUND, np.uint8)
    for x, y, r, color, alpha in _entities(env, state):
        _disc(frame, float(x), float(y), float(r), color, extent, alpha)
    return frame


def rollout_frames(
    env,
    generator: Optional[torch.Generator] = None,
    policy: Optional[Callable] = None,
    n_steps: int = 25,
    size: int = 256,
) -> List[np.ndarray]:
    """Step the env through its dict surface for ``n_steps``, rendering
    each state, until every agent is done.  ``policy(obs_dict, generator)
    -> action_dict``; by default each agent's action space samples from
    ``generator``."""
    obs, state = env.reset(generator)
    frames = [render_state(env, state, size=size)]
    for _ in range(n_steps):
        if policy is None:
            actions = {a: env.action_space(a).sample(generator) for a in env.agents}
        else:
            actions = policy(obs, generator)
        obs, state, _, done, _ = env.step(state, actions)
        frames.append(render_state(env, state, size=size))
        if bool(done["__all__"]):
            break
    return frames


def save_gif(frames: Sequence[np.ndarray], path: str, fps: int = 10) -> str:
    """Write frames to an animated GIF (requires PIL)."""
    from PIL import Image

    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:], duration=int(1000 / fps), loop=0)
    return path


def save_png(frame: np.ndarray, path: str) -> str:
    from PIL import Image

    Image.fromarray(frame).save(path)
    return path


def plot_metrics(jsonl_path: str, out_path: str, tags: Optional[Sequence[str]] = None):
    """Plot training curves from a MetricsLogger JSONL file (requires
    matplotlib).  Default tags: the four Loss/*_Train series."""
    import json

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    tags = tags or ["Loss/Train", "Loss/State_Train", "Loss/Reward_Train", "Loss/KL_Train"]
    series = {t: ([], []) for t in tags}
    with open(jsonl_path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("tag") in series:
                series[rec["tag"]][0].append(rec["step"])
                series[rec["tag"]][1].append(rec["value"])
    fig, ax = plt.subplots(figsize=(8, 5))
    for tag, (xs, ys) in series.items():
        if xs:
            ax.plot(xs, ys, label=tag)
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.set_yscale("log")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
