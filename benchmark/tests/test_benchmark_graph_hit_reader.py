"""The reader ``graph_hit_pct.rollout`` on a synthetic profiled stretch:
the share of the step spans that hold a replay span, worked by hand, and
nothing where the program keeps no step span."""

import pytest
import torch

from benchmark import common


def _read(host):
    prof = common.Profiled(torch.device("cpu"))
    prof.host = sorted(host)
    return common.load_module("metrics", "graph_hit_pct.rollout").read(
        {"prof": prof, "profiled": {"requests": 1, "wall_s": 1.0}})


STEPS = [(0.0, 100.0), (200.0, 300.0), (400.0, 500.0), (600.0, 700.0)]


def _steps(spans=STEPS):
    return [(lo, hi, "mfvae.rollout.step") for lo, hi in spans]


@pytest.mark.parametrize("replays,want", [
    ([(10.0, 90.0), (210.0, 290.0), (410.0, 490.0), (610.0, 690.0)], 100.0),  # every step replayed
    ([(210.0, 290.0)], 25.0),  # one step of four
    ([], 0.0),  # the eager loop: steps, no replay
    ([(110.0, 190.0), (800.0, 900.0)], 0.0),  # replays outside every step
], ids=["all", "one_of_four", "eager", "outside"])
def test_graph_hit_pct(replays, want):
    others = [(20.0, 30.0, "aten::copy_"), (150.0, 160.0, "mfvae.rollout.refeed"), (-10.0, 1000.0, "mfvae.rollout")]
    host = _steps() + [(lo, hi, "mfvae.rollout.replay") for lo, hi in replays] + others
    assert _read(host) == pytest.approx(want)


def test_graph_hit_pct_reads_nothing_without_step_spans():
    assert _read([(10.0, 90.0, "mfvae.rollout.replay"), (0.0, 100.0, "mfvae.rollout")]) is None
