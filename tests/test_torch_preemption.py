"""Preemption and restarts in the port (``mfvae_tpu_torch/training/experiment.py``),
after tests/test_preemption.py.

SIGTERM during training checkpoints the full payload at the next epoch
boundary and returns with ``preempted_at``; a restart with
``train.resume`` continues from a later epoch.  The process test drives
``python -m mfvae_tpu_torch ... --device cpu`` and sends a real SIGTERM
once periodic checkpoints show the epoch loop is live; the in-process
tests raise the signal inside an epoch.  ``run_resilient`` rebuilds and
resumes after a failure.
"""

import ast
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from mfvae_tpu_torch.training.checkpoint import CheckpointManager
from mfvae_tpu_torch.training.experiment import Experiment, run_resilient
from tests.test_torch_experiment import one_torch_thread  # noqa: F401
from tests.test_torch_experiment import parity_small

REPO = Path(__file__).resolve().parents[1]
WORKER = [
    "env.num_good_agents=1", "env.num_adversaries=2", "env.num_obs=1", "env.max_steps=16",
    "model.idx_features=8", "model.obs_features=8", "model.action_features=8", "model.encoder_hidden=16",
    "model.decoder_hidden=32", "model.compute_dtype=float32", "buffer.max_size=64", "buffer.min_size=4",
    "buffer.batch_size=8", "train.batch_size=8", "train.sample_num=8", "train.train_num=2", "train.test_num=2",
    "train.epoch_num=100000", "train.checkpoint_every=5", "train.resume=true",
]


def _spawn(workdir):
    env = dict(os.environ, PYTHONPATH=f"{REPO}{os.pathsep}" + os.environ.get("PYTHONPATH", ""))
    args = [*WORKER, f"train.log_dir={workdir}/results", f"train.checkpoint_dir={workdir}/ckpt"]
    return subprocess.Popen([sys.executable, "-m", "mfvae_tpu_torch", *args, "--device", "cpu"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=str(workdir))


def _latest(workdir) -> int:
    d = Path(workdir, "ckpt")
    return CheckpointManager(str(d)).latest_step() if d.exists() else -1


def _wait_for_ckpt_past(p, workdir, step, timeout=240) -> int:
    """Block until a checkpoint past ``step`` exists: periodic saves come
    from inside the epoch loop, so the handlers are installed by then."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        assert p.poll() is None, p.communicate()[0]
        latest = _latest(workdir)
        if latest is not None and latest > step:
            return latest
        time.sleep(0.2)
    p.kill()
    raise AssertionError(f"no checkpoint past step {step} within {timeout}s")


def _result(out: str) -> dict:
    return ast.literal_eval(out.strip().splitlines()[-1])


def _preempt(workdir, past):
    """Spawn the worker, SIGTERM it once a checkpoint past ``past`` exists,
    and return its output; the process never outlives the call."""
    p = _spawn(workdir)
    try:
        _wait_for_ckpt_past(p, workdir, past)
        p.send_signal(signal.SIGTERM)
        out, _ = p.communicate(timeout=120)
    finally:
        p.kill()
        p.wait()
    assert p.returncode == 0, out
    return out


def test_sigterm_checkpoints_and_a_restart_resumes(tmp_path):
    out = _preempt(tmp_path, -1)
    assert "preempted: checkpointing epoch" in out and "resumed from" not in out, out
    first = _result(out)
    saved = _latest(tmp_path)
    assert first["preempted_at"] == first["epoch"] == saved

    out2 = _preempt(tmp_path, saved)
    assert f"resumed from checkpoint step {saved} (epoch {saved + 1})" in out2, out2
    assert _result(out2)["preempted_at"] > saved


def _preempt_at(exp, epoch_to_signal, sig=signal.SIGTERM):
    """Raise ``sig`` inside the epoch ``epoch_to_signal`` of ``exp``."""
    epoch_fn, seen = exp._epoch_fn, []

    def wrapped(carry):
        seen.append(None)
        if len(seen) - 1 + exp.start_epoch == epoch_to_signal:
            signal.raise_signal(sig)
        return epoch_fn(carry)

    exp._epoch_fn = wrapped


@pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGINT], ids=["SIGTERM", "SIGINT"])
def test_signal_in_an_epoch_saves_it_and_returns(tmp_path, sig):
    assert threading.current_thread() is threading.main_thread()
    before = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    cfg = parity_small(tmp_path)
    cfg.train.epoch_num = 6
    exp = Experiment(cfg, device="cpu").setup()
    _preempt_at(exp, 2, sig)
    out = exp.run()
    assert out["preempted_at"] == out["epoch"] == 2 and len(out["epoch_wall_s"]) == 3
    assert exp.ckpt.latest_step() == 2
    assert {s: signal.getsignal(s) for s in before} == before  # the old handlers are back
    cfg.train.resume = True
    again = Experiment(cfg, device="cpu").setup()
    assert again.start_epoch == 3
    done = again.run()
    assert done["epoch"] == 5 and "preempted_at" not in done


def test_preempted_and_resumed_run_equals_a_straight_run(tmp_path):
    straight = parity_small(tmp_path / "a")
    straight.train.epoch_num = 4
    want = Experiment(straight, device="cpu").setup().run()
    split = parity_small(tmp_path / "b")
    split.train.epoch_num = 4
    exp = Experiment(split, device="cpu").setup()
    _preempt_at(exp, 1)
    assert exp.run()["preempted_at"] == 1
    split.train.resume = True
    got = Experiment(split, device="cpu").setup().run()
    assert got["loss_train"] == want["loss_train"] and got["loss_test"] == want["loss_test"]


class FailOnce:
    """An experiment factory whose first experiment fails after two epochs
    (checkpointed every epoch); later ones train normally."""

    def __init__(self):
        self.built = []

    def __call__(self, cfg, device):
        exp = Experiment(cfg, device)
        self.built.append(exp)
        if len(self.built) == 1:
            run = exp.run

            def failing_run():
                cfg.train.epoch_num, want = 2, cfg.train.epoch_num
                run()
                cfg.train.epoch_num = want
                raise RuntimeError("simulated preemption")

            exp.run = failing_run
        return exp


def test_run_resilient_recovers_from_one_failure(tmp_path, capsys):
    cfg = parity_small(tmp_path)
    cfg.train.epoch_num = 4
    cfg.train.checkpoint_every = 1
    factory = FailOnce()
    out = run_resilient(cfg, max_restarts=3, experiment_factory=factory, device="cpu")
    assert "training attempt 1 failed (RuntimeError: simulated preemption)" in capsys.readouterr().out
    assert len(factory.built) == 2 and cfg.train.resume
    assert factory.built[1].start_epoch == 2 and out["epoch"] == 3


def test_run_resilient_gives_up_after_max_restarts(tmp_path):
    calls = []

    def broken(cfg, device):
        calls.append(device)
        raise RuntimeError("always")

    with pytest.raises(RuntimeError, match="always"):
        run_resilient(parity_small(tmp_path), max_restarts=2, experiment_factory=broken, device="cpu")
    assert calls == ["cpu"] * 3
