"""Scale-out in the port (``mfvae_tpu_torch/parallel``): placements,
the data-parallel step and the mesh's entry points, on the CPU.

Multi-rank tests run real gloo process groups on 127.0.0.1: one spawned
process per rank (``spawn_ranks``), each with one torch thread, a timeout
on the process group and on the spawn, so a rank that hangs or dies fails
its own test.  The workers live in the test modules and import nothing of
JAX; the JAX references run in the test process (conftest's CPU mesh,
matmul precision "highest").

Here:
- ``mavae_param_shardings`` equal to JAX's ``_spec_for`` leaf by leaf on
  one bridged tree (fused decoders; unfused with LayerNorm, det_features
  and the shared latent), and ``check_divisibility`` with JAX's messages;
- ``make_dp_train_step`` at one data rank bit-equal to the plain step
  (Adam and POPART);
- the PopArt ``mu``/``nu``/``sigma`` after one 2-rank DP step within rtol
  1e-6 of JAX's ``make_dp_train_step`` on 2 devices (they do not depend on
  eps);
- ``mesh.enable`` with one env equal to no mesh, ``n_envs`` not divisible
  by the data axis refused, a mesh larger than the world refused;
- the eval in chunks of whole eval batches equal to one forward (rtol
  1e-6: the chunks' means are summed in another order);
- two processes through ``init_distributed`` (tcp) and one DP step each,
  printing ``mesh {'data': 2, 'model': 1}`` (tests/test_multihost.py's
  counterpart), and ``python -m mfvae_tpu_torch`` under torchrun's
  environment (env://) on two processes.
"""

from __future__ import annotations

import copy
import multiprocessing
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mfvae_tpu_torch.config import ExperimentConfig, LossConfig, ModelConfig, TrainConfig
from mfvae_tpu_torch.data.transitions import VaeBatch
from mfvae_tpu_torch.models.mavae import MAVAE, AgentSpec, GroupedBatch
from mfvae_tpu_torch.parallel import make_dp_train_step, make_mesh
from mfvae_tpu_torch.parallel.mesh import Mesh, init_distributed
from mfvae_tpu_torch.parallel.sharding import check_divisibility, mavae_param_shardings
from mfvae_tpu_torch.training import experiment
from mfvae_tpu_torch.training.experiment import Experiment
from mfvae_tpu_torch.training.trainer import create_train_state, make_train_step
from tests.test_torch_experiment import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 150
GROUP_TIMEOUT_S = 60


# --------------------------------------------------------------- spawning
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, out, args):
    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo", timeout_s=GROUP_TIMEOUT_S)
    try:
        torch.save(fn(rank, *args), f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, out: Path, *args, timeout_s: float = SPAWN_TIMEOUT_S) -> list:
    """Run ``fn(rank, *args)`` on ``world`` gloo ranks, one spawned process
    each; returns what each rank's ``fn`` returned.  A rank that has not
    finished after ``timeout_s`` is killed and fails the test."""
    out.mkdir(parents=True, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, port, str(out), args)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} still running after {timeout_s} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"rank exit codes {codes}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ------------------------------------------------------------------ configs
def small_cfg(tmp, n_envs=4, epochs=2, **options) -> ExperimentConfig:
    """Groups of 2 and 2 agents (both divide a model axis of 2), float32."""
    cfg = ExperimentConfig()
    cfg.env.num_good_agents, cfg.env.num_adversaries, cfg.env.num_obs, cfg.env.max_steps = 2, 2, 2, 16
    m = cfg.model
    m.compute_dtype = "float32"
    m.idx_features = m.obs_features = m.action_features = 8
    m.encoder_hidden, m.decoder_hidden = (16,), (32, 16, 16, 32)
    cfg.buffer.max_size, cfg.buffer.min_size, cfg.buffer.batch_size = 256, 8, 16
    t = cfg.train
    t.batch_size, t.epoch_num, t.sample_num, t.train_num, t.test_num = 16, epochs, 16, 3, 4
    t.n_envs = n_envs
    t.log_dir, t.checkpoint_dir = f"{tmp}/results", ""
    for key, value in options.items():
        section, name = key.split("__")
        setattr(getattr(cfg, section), name, value)
    return cfg


def tiny_model(seed=0, **model_kw):
    agents = ("adversary_0", "adversary_1", "agent_0", "agent_1")
    obs = {"adversary_0": 10, "adversary_1": 10, "agent_0": 6, "agent_1": 6}
    spec = AgentSpec.from_dicts(agents, obs, {a: 5 for a in agents})
    mc = ModelConfig(idx_features=8, obs_features=8, action_features=8, encoder_hidden=(16,),
                     decoder_hidden=(32, 16), compute_dtype="float32", **model_kw)
    return spec, mc, MAVAE.from_config(mc, spec, device="cpu", generator=torch.Generator().manual_seed(seed))


def numpy_batch(spec, b, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "obs": [rng.normal(size=(b, len(idxs), od)).astype(np.float32) for (od, _), idxs in spec.groups],
        "act": [rng.integers(0, 5, size=(b, len(idxs))).astype(np.int32) for _, idxs in spec.groups],
        "next": rng.normal(size=(b, sum(spec.obs_dims))).astype(np.float32),
        "rew": (3.0 + 2.0 * rng.normal(size=(b, spec.n_agents))).astype(np.float32),
    }


def vae_batch(nb, rows=slice(None)) -> VaeBatch:
    return VaeBatch(
        inputs=GroupedBatch(obs=tuple(torch.from_numpy(o[rows]) for o in nb["obs"]),
                            actions=tuple(torch.from_numpy(a[rows]) for a in nb["act"])),
        next_state=torch.from_numpy(nb["next"][rows]),
        rewards=torch.from_numpy(nb["rew"][rows]),
    )


# -------------------------------------------------- placements against JAX
JAX_SMALL = dict(idx_features=8, obs_features=8, action_features=8, encoder_hidden=(16,),
                 decoder_hidden=(32, 16, 16, 32), compute_dtype="float32")


def _jax_params(model_kw):
    import jax
    import jax.numpy as jnp

    from mfvae_tpu.config import ModelConfig as JModelConfig
    from mfvae_tpu.models.mavae import MAVAE as JMAVAE
    from mfvae_tpu.models.mavae import AgentSpec as JSpec
    from mfvae_tpu.models.mavae import GroupedBatch as JBatch

    agents = ("adversary_0", "adversary_1", "adversary_2", "adversary_3", "agent_0", "agent_1")
    obs = {a: (10 if a.startswith("adversary") else 6) for a in agents}
    jspec = JSpec.from_dicts(agents, obs, {a: 5 for a in agents})
    jmodel = JMAVAE.from_config(JModelConfig(**JAX_SMALL, **model_kw), jspec)
    batch = JBatch(
        obs=tuple(jnp.zeros((2, len(idxs), od)) for (od, _), idxs in jspec.groups),
        actions=tuple(jnp.zeros((2, len(idxs)), jnp.int32) for _, idxs in jspec.groups),
    )
    return jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0), batch, None, jax.random.PRNGKey(1)))


def port_name(keys) -> str:
    """The port's parameter name of a flax path (without 'params')."""
    from mfvae_tpu_torch.models.convert import params_from_jax

    tree = np.zeros(1)
    for k in reversed(keys):
        tree = {k: tree}
    return next(iter(params_from_jax(tree)))


MODEL_VARIANTS = {
    "fused": {},
    "unfused_layernorm_det_shared": dict(fused_decoders=False, decoder_layernorm=True, det_features=4,
                                         latent_structure="shared_private", shared_latent=4),
}


@pytest.mark.parametrize("variant", sorted(MODEL_VARIANTS))
def test_param_shardings_match_jax(variant):
    import jax

    from mfvae_tpu.parallel.sharding import _spec_for
    from mfvae_tpu_torch.models.convert import params_from_jax

    variables = _jax_params(MODEL_VARIANTS[variant])
    mine = mavae_param_shardings(params_from_jax(variables), Mesh({"data": 2, "model": 2}))
    want = {
        port_name([str(p.key) for p in path]): tuple(_spec_for(path, leaf))
        for path, leaf in jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    }
    assert {n: tuple(s.spec) for n, s in mine.items()} == want
    assert sum("model" in s.spec for s in mine.values()) >= 8


def test_check_divisibility_matches_jax():
    from mfvae_tpu.parallel.mesh import make_mesh as j_make_mesh
    from mfvae_tpu.parallel.sharding import check_divisibility as j_check
    from mfvae_tpu.parallel.sharding import mavae_param_shardings as j_shardings
    from mfvae_tpu_torch.models.convert import params_from_jax

    variables = _jax_params({})
    # 4 adversaries and 2 good agents, decoder widths 32 and 16, over a model axis of 3
    j_issues = j_check(variables, j_shardings(variables, j_make_mesh(n_data=2, n_model=3)))
    sd = params_from_jax(variables)
    issues = check_divisibility(sd, mavae_param_shardings(sd, Mesh({"data": 2, "model": 3})))
    # JAX's keys are keystr paths: ['params']['encoders_0']['fc0']['kernel']
    want = {port_name([k.strip("'") for k in key.strip("[]").split("][")][1:]): msg
            for key, msg in j_issues.items()}
    assert issues and issues == want


# ------------------------------------------------------ the DP step, world 1
@pytest.mark.parametrize("mode", ["Adam", "POPART"])
def test_dp_step_at_one_rank_is_the_plain_step(mode):
    spec, mc, model = tiny_model()
    nb = numpy_batch(spec, 8)
    states = [create_train_state(copy.deepcopy(model), TrainConfig()) for _ in range(2)]
    dp = make_dp_train_step(LossConfig(), make_mesh(), mode, 0.3)
    plain = make_train_step(LossConfig(), mode, 0.3)
    outs = []
    for state, step in zip(states, (dp, plain)):
        for seed in range(2):
            _, o = step(state, vae_batch(nb), torch.Generator().manual_seed(seed))
        outs.append(o)
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    for a, b in zip(states[0].model.parameters(), states[1].model.parameters()):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(states[0].popart, states[1].popart))


# -------------------------------------------- PopArt stats against JAX's DP
def _popart_dp_rank(rank, nb):
    spec, mc, model = tiny_model()
    state = create_train_state(model, TrainConfig())
    mesh = make_mesh(n_data=2)
    step = make_dp_train_step(LossConfig(), mesh, "POPART", 0.3)
    b = nb["rew"].shape[0] // 2
    _, out = step(state, vae_batch(nb, slice(rank * b, (rank + 1) * b)), torch.Generator().manual_seed(0))
    return {"popart": [x.numpy() for x in state.popart], "loss": float(out.loss), "mesh": dict(mesh.shape),
            "params": {n: p.detach().clone() for n, p in state.model.named_parameters()}}


def test_dp_popart_stats_match_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from mfvae_tpu.config import LossConfig as JLossConfig
    from mfvae_tpu.config import ModelConfig as JModelConfig
    from mfvae_tpu.config import TrainConfig as JTrainConfig
    from mfvae_tpu.data.transitions import VaeBatch as JVaeBatch
    from mfvae_tpu.models.mavae import MAVAE as JMAVAE
    from mfvae_tpu.models.mavae import AgentSpec as JSpec
    from mfvae_tpu.models.mavae import GroupedBatch as JBatch
    from mfvae_tpu.parallel.dp import make_dp_train_step as j_dp_step
    from mfvae_tpu.parallel.mesh import make_mesh as j_make_mesh
    from mfvae_tpu.training.trainer import create_train_state as j_state

    spec, mc, _ = tiny_model()
    nb = numpy_batch(spec, 16)
    ranks = spawn_ranks(_popart_dp_rank, 2, tmp_path, nb)

    jspec = JSpec.from_dicts(spec.agents, dict(zip(spec.agents, spec.obs_dims)), {a: 5 for a in spec.agents})
    jmodel = JMAVAE.from_config(JModelConfig(**{k: getattr(mc, k) for k in (
        "idx_features", "obs_features", "action_features", "encoder_hidden", "decoder_hidden", "compute_dtype")}),
        jspec)
    jbatch = JBatch(obs=tuple(map(jnp.asarray, nb["obs"])), actions=tuple(map(jnp.asarray, nb["act"])))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jbatch, None, jax.random.PRNGKey(1))
    jvb = JVaeBatch(inputs=jbatch, next_state=jnp.asarray(nb["next"]), rewards=jnp.asarray(nb["rew"]))
    mesh = j_make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])
    state, _ = jax.jit(j_dp_step(JLossConfig(), mesh, mode="POPART", popart_beta=0.3))(
        j_state(jmodel, variables, JTrainConfig()), jvb, jax.random.PRNGKey(0))
    for r in ranks:
        assert r["mesh"] == {"data": 2, "model": 1}
        for got, want in zip(r["popart"], state.popart):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)
    # the ranks' updates are one update
    assert ranks[0]["loss"] == ranks[1]["loss"]
    for n, p in ranks[0]["params"].items():
        assert torch.equal(p, ranks[1]["params"][n]), n


# --------------------------------------------------------- the mesh options
def test_mesh_with_one_env_is_no_mesh(tmp_path):
    """As in the JAX package, mesh.enable acts on the batched epoch only."""
    results = []
    for enable in (False, True):
        cfg = small_cfg(tmp_path / str(enable), n_envs=1, mesh__enable=enable)
        exp = Experiment(cfg, "cpu")
        assert exp.mesh is None
        results.append(exp.setup().run())
    assert [(r["loss_train"], r["loss_test"]) for r in results[:1]] == [
        (r["loss_train"], r["loss_test"]) for r in results[1:]]


def test_world_one_mesh_is_the_unsharded_run(tmp_path):
    """``python -m mfvae_tpu_torch examples/data_parallel.yaml`` on one
    process: the batched epoch over a world-1 mesh, bit-equal."""
    results = []
    for enable in (False, True):
        exp = Experiment(small_cfg(tmp_path / str(enable), mesh__enable=enable), "cpu")
        assert (exp.mesh is not None) == enable
        results.append(exp.setup().run())
    assert results[0]["loss_train"] == results[1]["loss_train"]
    assert results[0]["loss_test"] == results[1]["loss_test"]


def test_n_envs_not_divisible_by_the_data_axis_refused(tmp_path, monkeypatch):
    monkeypatch.setattr(experiment, "make_mesh", lambda n_data, n_model: Mesh({"data": 2, "model": 1}))
    with pytest.raises(ValueError, match="not divisible by the mesh's data axis"):
        Experiment(small_cfg(tmp_path, n_envs=3, mesh__enable=True), "cpu")


def test_mesh_larger_than_the_world_refused(tmp_path):
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        Experiment(small_cfg(tmp_path, mesh__enable=True, mesh__data_axis=2), "cpu")
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        make_mesh(n_data=1, n_model=2)


@pytest.mark.parametrize("options", [
    dict(n_envs=1), dict(n_envs=4), dict(n_envs=4, loss__contact_weight=1.0, loss__contact_threshold=-10.0),
], ids=["one_env", "batched", "batched_contact"])
def test_eval_in_chunks_equals_one_forward(tmp_path, monkeypatch, options):
    """Past EVAL_CHUNK_ROWS rows the eval runs in chunks of whole eval
    batches (the eval of data_parallel.yaml took 61.6 GB in one forward),
    on the same draws: the same losses up to the order of the sums."""
    from mfvae_tpu_torch.training import trainer

    results = []
    for rows in (trainer.EVAL_CHUNK_ROWS, 48):  # 4 x 16 rows in one forward; 3 batches a chunk
        monkeypatch.setattr(trainer, "EVAL_CHUNK_ROWS", rows)
        results.append(Experiment(small_cfg(tmp_path / str(rows), **options), "cpu").setup().run())
    assert results[0]["loss_train"] == results[1]["loss_train"]
    np.testing.assert_allclose(results[1]["loss_test"], results[0]["loss_test"], rtol=1e-6)


# ---------------------------------------------------- multi-process entry
def _multihost_rank(rank, nb):
    out = _popart_dp_rank(rank, nb)
    print(f"mesh {out['mesh']}")
    print(f"proc {rank}: OK", flush=True)
    return out


def test_two_process_dp_step(tmp_path, capfd):
    spec, _, _ = tiny_model()
    ranks = spawn_ranks(_multihost_rank, 2, tmp_path, numpy_batch(spec, 8))
    printed = capfd.readouterr().out
    for pid in range(2):
        assert f"proc {pid}: OK" in printed, printed
    assert "mesh {'data': 2, 'model': 1}" in printed, printed
    assert np.isfinite(ranks[0]["loss"]) and ranks[0]["loss"] == ranks[1]["loss"]


def test_cli_under_torchrun_environment(tmp_path):
    """``torchrun --nproc_per_node 2 -m mfvae_tpu_torch cfg.yaml`` as the
    two processes torchrun starts: its environment, env:// rendezvous, one
    rank per process, rank 0 alone writing the run's metrics."""
    port = free_port()
    overrides = [
        "env.num_good_agents=2", "env.num_adversaries=2", "env.num_obs=2", "env.max_steps=16",
        "model.compute_dtype=float32", "model.encoder_hidden=[16]", "model.decoder_hidden=[32,16]",
        "model.idx_features=8", "model.obs_features=8", "model.action_features=8",
        "train.n_envs=4", "train.batch_size=16", "buffer.batch_size=16", "buffer.max_size=256",
        "buffer.min_size=8", "train.epoch_num=1", "train.sample_num=16", "train.train_num=2",
        "train.test_num=2", f"train.log_dir={tmp_path}/results", "train.checkpoint_dir=",
        "train.run_name=dp2",
    ]
    procs = []
    for rank in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=f"{REPO}{os.pathsep}{os.environ.get('PYTHONPATH', '')}")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mfvae_tpu_torch", str(REPO / "examples" / "data_parallel.yaml"),
             *overrides, "--device", "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=str(tmp_path)))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        assert "'loss_train'" in out, out
    assert outs[0].splitlines()[-1].split("'wall_s'")[0] == outs[1].splitlines()[-1].split("'wall_s'")[0]
    assert (tmp_path / "results" / "dp2" / "metrics.jsonl").exists()
