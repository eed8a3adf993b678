"""The readers of the program's spans (``sample_ms.train``,
``step_host_ms.rollout``) on a synthetic profiled stretch: each reads the
value worked by hand, and nothing where a count is off or the program
keeps no such span."""

import pytest
import torch

from benchmark import common

STEPS = 2


def _read(metric, data):
    return common.load_module("metrics", metric).read(data)


def _train(host=()):
    prof = common.Profiled(torch.device("cpu"))
    prof.host = sorted(host)
    return {"prof": prof, "profiled": {"steps": STEPS, "wall_s": 1.0}}


def test_sample_ms():
    host = [(0.0, 1500.0, "mfvae.train.sample"), (100.0, 200.0, "aten::index"),
            (2000.0, 2500.0, "mfvae.train.sample"), (2600.0, 9000.0, "mfvae.train.forward")]
    assert _read("sample_ms.train", _train(host)) == pytest.approx((1500 + 500) * 1e-3 / 2)
    assert _read("sample_ms.train", _train(host[1:])) is None  # a step's span missing
    assert _read("sample_ms.train", _train(host[1:2])) is None  # no such span


def _rollout(requests, steps, others=()):
    prof = common.Profiled(torch.device("cpu"))
    prof.host = sorted([(lo, hi, "mfvae.rollout") for lo, hi in requests]
                       + [(lo, hi, "mfvae.rollout.step") for lo, hi in steps] + list(others))
    return {"prof": prof, "profiled": {"requests": 2, "wall_s": 1.0}}


REQUESTS = [(0.0, 10000.0), (20000.0, 30000.0)]
STEP_SPANS = [(100.0, 1100.0), (2000.0, 4000.0), (5000.0, 8000.0),
              (20100.0, 21100.0), (22000.0, 24000.0), (25000.0, 28000.0)]


def test_step_host_ms():
    others = [(8100.0, 8200.0, "mfvae.rollout.refeed"), (150.0, 900.0, "aten::bmm")]
    assert _read("step_host_ms.rollout", _rollout(REQUESTS, STEP_SPANS, others)) == pytest.approx(
        (1000 + 2000 + 3000) * 2 * 1e-3 / 6)


@pytest.mark.parametrize("requests,steps", [
    (REQUESTS, STEP_SPANS[:-1]),  # a step's span missing
    (REQUESTS[:1], STEP_SPANS[:3]),  # a request's span missing
    (REQUESTS, STEP_SPANS + [(40000.0, 41000.0)]),  # a step outside every request
    (REQUESTS, []),  # no such span
], ids=["step_missing", "request_missing", "step_outside", "none"])
def test_step_host_ms_reads_nothing_when_a_count_is_off(requests, steps):
    assert _read("step_host_ms.rollout", _rollout(requests, steps)) is None
