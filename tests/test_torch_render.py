"""The port's renderer (``mfvae_tpu_torch/envs/render.py``) against the JAX
package's.

- ``render_state`` of one injected state, in each of the four scenarios,
  is bit-equal to the JAX renderer's frame (both rasterize in numpy);
  agents beyond the shown extent are clipped alike.
- ``rollout_frames`` steps the dict surface from a ``torch.Generator``
  until every agent is done, by default and under a given policy.
- ``save_png``, ``save_gif`` and ``plot_metrics`` write their files.
"""

import json

import numpy as np
import pytest
import torch

from mfvae_tpu.envs import render as jrender
from mfvae_tpu_torch.envs import render as trender
from tests.test_torch_scenarios import envs, inject, uniform_state

POPS = {
    "MPE_simple_tag_v3": dict(num_good_agents=2, num_adversaries=3, num_obs=2),
    "MPE_simple_spread_v3": dict(num_good_agents=3),
    "MPE_simple_adversary_v3": dict(num_good_agents=3),
    "MPE_simple_world_comm_v3": dict(num_good_agents=2, num_adversaries=4, num_obs=1),
}
EXTRA = {"MPE_simple_adversary_v3": dict(goal=np.int32(2)),
         "MPE_simple_world_comm_v3": dict(leader_comm=np.zeros(4, np.float32))}


@pytest.mark.parametrize("size", [64, 256])
@pytest.mark.parametrize("name", sorted(POPS))
def test_frames_are_bit_equal_to_jax(name, size):
    jenv, tenv = envs(name, **POPS[name])
    pos, vel, lm = uniform_state(jenv, 0, span=1.4)  # some agents beyond the extent 1.3
    js, ts = inject(tenv, pos, vel, lm, **EXTRA.get(name, {}))
    got = trender.render_state(tenv, ts, size=size)
    want = jrender.render_state(jenv, js, size=size)
    assert got.dtype == np.uint8 and got.shape == (size, size, 3)
    np.testing.assert_array_equal(got, want)
    assert (got != 255).any()


@pytest.mark.parametrize("name", sorted(POPS))
def test_rollout_frames_until_done(name):
    _, tenv = envs(name, max_steps=4, **POPS[name])
    frames = trender.rollout_frames(tenv, torch.Generator().manual_seed(0), n_steps=10, size=32)
    assert len(frames) == 5 and all(f.shape == (32, 32, 3) for f in frames)
    held = {a: torch.tensor(0, dtype=torch.int32) for a in tenv.agents}
    frames = trender.rollout_frames(tenv, torch.Generator().manual_seed(0), policy=lambda obs, g: held,
                                    n_steps=2, size=32)
    # the no-op from rest leaves everything in place, contacts aside
    assert len(frames) == 3


def test_files_are_written(tmp_path):
    _, tenv = envs("MPE_simple_tag_v3", max_steps=3, **POPS["MPE_simple_tag_v3"])
    frames = trender.rollout_frames(tenv, torch.Generator().manual_seed(1), size=32)
    assert trender.save_png(frames[0], str(tmp_path / "f.png")) and (tmp_path / "f.png").stat().st_size > 0
    assert trender.save_gif(frames, str(tmp_path / "e.gif")) and (tmp_path / "e.gif").stat().st_size > 0
    log = tmp_path / "metrics.jsonl"
    log.write_text("".join(json.dumps({"tag": "Loss/Train", "step": s, "value": 1.0 / (s + 1)}) + "\n"
                           for s in range(4)))
    trender.plot_metrics(str(log), str(tmp_path / "curves.png"))
    assert (tmp_path / "curves.png").stat().st_size > 0
