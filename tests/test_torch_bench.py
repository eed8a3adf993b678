"""The port's measurement entry points (``mfvae_tpu_torch/bench/``) against
the JAX package's ``bench.py``, ``__graft_entry__._flagship`` and
``scripts/{perf_matrix,mfu_ceiling,pallas_probe,bench_inference,
native_env_bench}.py``, at tiny widths on the CPU.

- The flagship's inputs are bit-equal to JAX's (numpy draws both sides);
  a forward through JAX's parameters, bridged by ``models/convert.py``,
  matches JAX's ``model.apply`` at float32 within rtol 1e-5 (atol 1e-5 for
  outputs near 0).
- Each entry point's JSON keys are its JAX counterpart's, read from the
  JAX source by AST, beside the extras each module names.  The ``null``
  keys are the ones named in ``"absent"`` and, on the CPU, the MFU keys.
- ``step_flops`` equals ``FlopCounterMode``'s count of one train step, and
  the ``dot_general`` FLOPs of JAX's ``value_and_grad`` of the same step
  less the one-hot products of its ``StackedEmbedding`` (a gather here).
- Every entry point raises without a card unless it is asked for the CPU.

The JAX scripts are read, never imported: they set a compilation cache at
import time.
"""

import ast
import itertools
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import __graft_entry__ as graft
from mfvae_tpu.config import LossConfig as JLossConfig
from mfvae_tpu.data.transitions import VaeBatch as JVaeBatch
from mfvae_tpu.models.losses import elbo_losses as jelbo_losses
from mfvae_tpu.models.mavae import GroupedBatch as JGroupedBatch
from mfvae_tpu_torch.bench import __main__ as bench_main
from mfvae_tpu_torch.bench import bench_inference, common, flagship, mfu_ceiling, native_env_bench, pallas_probe, perf_matrix
from mfvae_tpu_torch.config import LossConfig, ModelConfig, TrainConfig
from mfvae_tpu_torch.models.convert import params_from_jax
from mfvae_tpu_torch.training.trainer import create_train_state, make_train_step
from mfvae_tpu_torch.training.unroll import make_unroll_train_step
from tests.test_torch_experiment import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
CUT_MAIN = dict(n_scan=2, n_pipelined=2, n_wall=1, n_multiseed=1, n_scaling=1, n_unroll=1, n_epochs=1,
                reps=1, reps_rows=1, warmup=1)
CUT_INFERENCE = dict(n_predict=1, n_latency=1, n_rollout=1, reps=1, n_episodes=1, ep_len=2)
CUT_MEASURE = dict(device="cpu", tiny=True, reps=1, warmup=1)
# what each port module prints beside its JAX counterpart's keys
MAIN_EXTRAS = {"absent", "device", "peak_flops", "step_flops_source", "mfu_pct_note", "multiseed_4x_discipline",
               "counts"}
ROW_EXTRAS = {"device", "compute_dtype", "route", "steps", "max_memory_allocated"}
TABLE_EXTRAS = {"device", "step_flops_source", "mfu_pct_note"}


# ---------------------------------------------------------------- the JAX source
def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _function(tree: ast.Module, name: str) -> ast.FunctionDef:
    return next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name)


def _printed_keys(fn: ast.FunctionDef) -> set:
    """The keys of the dict literal in the last ``print(json.dumps({...}))``."""
    dumps = [n.args[0] for n in ast.walk(fn) if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "dumps"
             and n.args and isinstance(n.args[0], ast.Dict)]
    return {k.value for k in dumps[-1].keys}


def _jax_flagship_batch(spec, batch: int):
    """scripts/perf_matrix.py's ``flagship_batch``, executed from its source."""
    fn = _function(_tree(SCRIPTS / "perf_matrix.py"), "flagship_batch")
    ns = {"np": np, "jnp": jnp, "VaeBatch": JVaeBatch, "GroupedBatch": JGroupedBatch}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "perf_matrix.py", "exec"), ns)
    return ns["flagship_batch"](spec, batch)


def _bench_inference_keys() -> set:
    """bench_inference.py's ``out`` keys: its f-strings rendered over the
    values their names take in the script (the loop tuple, HORIZON, the
    ``actors`` names)."""
    path = SCRIPTS / "bench_inference.py"
    main = _function(_tree(path), "main")
    values = {}
    for n in ast.walk(main):
        if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name) and isinstance(n.value, ast.Constant):
            values[n.targets[0].id] = [n.value.value]
        if isinstance(n, ast.For) and isinstance(n.target, ast.Name) and isinstance(n.iter, ast.Tuple):
            values[n.target.id] = list(ast.literal_eval(n.iter))
    actors = common.source_dict_keys(path, "main", "actors") | {
        n.targets[0].slice.value for n in ast.walk(main)
        if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Subscript)
        and getattr(n.targets[0].value, "id", "") == "actors"
    }
    values["name"] = sorted(actors)
    keys = common.source_dict_keys(path, "main", "out")
    for n in ast.walk(main):
        if not (isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Subscript)
                and getattr(n.targets[0].value, "id", "") == "out"):
            continue
        key = n.targets[0].slice
        if isinstance(key, ast.Constant):
            keys.add(key.value)
            continue
        names = [v.value.id for v in key.values if isinstance(v, ast.FormattedValue)]
        for combo in itertools.product(*(values[nm] for nm in names)):
            it = iter(combo)
            keys.add("".join(str(next(it)) if isinstance(v, ast.FormattedValue) else v.value for v in key.values))
    return keys


# ---------------------------------------------------------------- the flagship
@pytest.mark.parametrize("batch", [1, 5])
def test_flagship_inputs_bit_equal_to_jax(batch):
    jspec, _, jin = graft._flagship(batch_size=batch)
    spec, _, tin = flagship.flagship(batch, tiny=True, device="cpu")
    assert spec.groups == jspec.groups and spec.obs_dims == jspec.obs_dims and spec.agents == jspec.agents
    assert sum(spec.obs_dims) == 5660 and spec.n_agents == 40
    for t, j in zip(tin.obs + tin.actions, jin.obs + jin.actions):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # bench.py's next_state and rewards: a second default_rng(0)
    rng = np.random.default_rng(0)
    vb = flagship.bench_targets(np.random.default_rng(0), spec, tin, "cpu")
    np.testing.assert_array_equal(vb.next_state.numpy(), np.asarray(
        jnp.asarray(rng.normal(size=(batch, sum(jspec.obs_dims))), jnp.float32)))
    np.testing.assert_array_equal(vb.rewards.numpy(), np.asarray(
        jnp.asarray(rng.normal(size=(batch, jspec.n_agents)), jnp.float32)))
    # perf_matrix.py's flagship_batch: one default_rng(0) for all four
    jb, tb = _jax_flagship_batch(jspec, batch), flagship.flagship_batch(spec, batch, "cpu")
    for t, j in zip(tb.inputs.obs + tb.inputs.actions + (tb.next_state, tb.rewards),
                    jb.inputs.obs + jb.inputs.actions + (jb.next_state, jb.rewards)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_flagship_population_arguments_keep_their_meaning():
    jspec, _, jin = graft._flagship(batch_size=3, n_adv=4, n_good=2, n_obs=1, tiny=True)
    spec, model, tin = flagship.flagship(3, n_adv=4, n_good=2, n_obs=1, tiny=True, device="cpu")
    assert spec.groups == jspec.groups and spec.obs_dims == jspec.obs_dims
    for t, j in zip(tin.obs + tin.actions, jin.obs + jin.actions):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert model.dtype == torch.float32 and model.obs_features == 8


def test_bridged_forward_matches_jax():
    jspec, jmodel, jin = graft._flagship(batch_size=4, tiny=True)
    _, model, tin = flagship.flagship(4, tiny=True, device="cpu")
    variables = jmodel.init(jax.random.PRNGKey(0), jin, None, jax.random.PRNGKey(1))
    model.load_state_dict(params_from_jax(jax.device_get(variables)))
    key = jax.random.PRNGKey(7)
    eps = np.asarray(jmodel.apply(variables, key, (4, jspec.n_agents, 8), method=lambda m, k, s: m._eps(k, s)))
    with torch.no_grad():
        outs = model(tin, None, eps=torch.from_numpy(eps))
    for t, j in zip(outs, jmodel.apply(variables, jin, None, key)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- the FLOPs
def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


RECIPE = dict(det_features=128, residual_state=True, state_skip=True, decoder_layernorm=True, fused_decoders=False)


@pytest.mark.parametrize("options", [{}, {"det_features": 128}, RECIPE, dict(RECIPE, action_delta_head=True)],
                         ids=["default", "det128", "recipe", "control"])
def test_step_flops_equal_flop_counter(options):
    spec = flagship.flagship_spec()
    model = flagship.build_model(flagship.tiny_config(ModelConfig(**options)), spec, "cpu")
    batch = flagship.flagship_batch(spec, 4, "cpu")
    step = make_train_step(LossConfig(s_weight=300.0))
    state = create_train_state(model, TrainConfig())
    g = torch.Generator().manual_seed(0)
    assert common.step_flops(model, 4) == _counted(lambda: step(state, batch, g))


def test_unroll_step_flops_equal_flop_counter():
    spec = flagship.flagship_spec()
    model = flagship.build_model(flagship.tiny_config(ModelConfig(**RECIPE)), spec, "cpu")
    wbatch = bench_main._window_batch(np.random.default_rng(0), spec, 2, "cpu")
    step = make_unroll_train_step(spec, LossConfig(s_weight=300.0), bench_main.W_UNROLL)
    state = create_train_state(model, TrainConfig())
    g = torch.Generator().manual_seed(0)
    assert common.step_flops(model, 2, bench_main.W_UNROLL) == _counted(lambda: step(state, wbatch, g))


def _dot_flops(jaxpr) -> int:
    """2·|out|·|contracted| summed over every dot_general, sub-jaxprs included."""
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lhs_contract, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            total += 2 * math.prod(eqn.outvars[0].aval.shape) * math.prod(lhs[d] for d in lhs_contract)
        for p in eqn.params.values():
            for sub in p if isinstance(p, (tuple, list)) else (p,):
                if hasattr(sub, "eqns"):
                    total += _dot_flops(sub)
                elif hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                    total += _dot_flops(sub.jaxpr)
    return total


def test_step_flops_equal_jax_dot_general_less_one_hot():
    b = 4
    jspec, jmodel, jin = graft._flagship(batch_size=b, tiny=True)
    rng = np.random.default_rng(0)
    next_state = jnp.asarray(rng.normal(size=(b, sum(jspec.obs_dims))), jnp.float32)
    rewards = jnp.asarray(rng.normal(size=(b, jspec.n_agents)), jnp.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), jin, None, jax.random.PRNGKey(1))

    def loss(params):
        outs = jmodel.apply(params, jin, None, jax.random.PRNGKey(2))
        return jelbo_losses(*outs[:2], next_state, rewards, *outs[2:], JLossConfig()).loss

    jax_flops = _dot_flops(jax.make_jaxpr(jax.value_and_grad(loss))(variables).jaxpr)
    _, model, _ = flagship.flagship(b, tiny=True, device="cpu")
    # StackedEmbedding's one-hot product [B, A_g, K] x [A_g, K, F], forward
    # and its kernel's gradient: a gather in the port
    af = flagship.TINY["action_features"]
    one_hot = sum(2 * (2 * b * len(idxs) * act * af) for (_, act), idxs in jspec.groups)
    assert common.step_flops(model, b) == jax_flops - one_hot


# ---------------------------------------------------------------- the key sets
def test_bench_keys_are_bench_py_keys():
    jax_keys = common.source_dict_keys(ROOT / "bench.py", "main", "out")
    out = bench_main.run("cpu", tiny=True, batch=8, batches=(16,), **CUT_MAIN)
    assert set(out) - MAIN_EXTRAS == jax_keys
    nulls = {k for k, v in out.items() if v is None}
    mfu_keys = {k for k in jax_keys if k.endswith("mfu_pct")}
    assert set(out["absent"]) == set(bench_main.ABSENT) and set(out["absent"]) <= jax_keys
    # on the card only the absent keys are null; a CPU run has no MFU
    assert nulls == set(out["absent"]) | mfu_keys
    assert all(v["mfu_pct"] is None and set(v) == {"samples_per_sec", "mfu_pct"} for v in out["batch_scaling"].values())
    assert out["device"]["platform"] == "cpu" and out["device"]["kind"] == "cpu"
    assert out["step_flops_source"] == "matmul shapes" and out["value_discipline"] == "eager2_one_sync"
    assert out["mfu_pct_note"] == common.MFU_PCT_NOTE
    finite = [v for k, v in out.items() if isinstance(v, float)]
    assert all(math.isfinite(v) and v > 0 for v in finite)


def test_measure_rows_have_perf_matrix_keys():
    tree = _tree(SCRIPTS / "perf_matrix.py")
    row_keys = common.source_dict_keys(SCRIPTS / "perf_matrix.py", "measure", "row")
    out = perf_matrix.run(batches=(4,), batch=4, n_scan=1, populations=((3, 1),), **CUT_MEASURE)
    assert set(out) - TABLE_EXTRAS == _printed_keys(_function(tree, "main")) == {"matrix"}
    labels = [r["label"] for r in out["matrix"]]
    assert labels == ["default_bf16", "pallas", "separate_decoders", "det64", "f32", "agents_4"]
    for r in out["matrix"]:
        assert set(r) - ROW_EXTRAS == row_keys
        assert r["mfu_pct"] is None and r["max_memory_allocated"] is None and r["device"]["platform"] == "cpu"
        assert r["steps"] == 2 and r["route"] == ("kernels" if r["label"] == "pallas" else "plain")
        assert r["flops_per_step"] > 0 and math.isfinite(r["samples_per_sec"])
    assert out["matrix"][-1]["flops_per_step"] < out["matrix"][0]["flops_per_step"]


def test_mfu_ceiling_and_pallas_probe_rows():
    ceiling = mfu_ceiling.run(batch=4, n_scan=1, **CUT_MEASURE)
    tree = _tree(SCRIPTS / "mfu_ceiling.py")
    assert set(ceiling) - TABLE_EXTRAS == _printed_keys(_function(tree, "main"))
    jax_labels = {kw.value.value for n in ast.walk(tree) if isinstance(n, ast.Call)
                  for kw in n.keywords if kw.arg == "label"}
    assert [r["label"] for r in ceiling["mfu_ceiling"]] == ["reference_arch", "no_bottleneck_512", "wide_2048",
                                                            "big_4096"]
    assert {r["label"] for r in ceiling["mfu_ceiling"]} == jax_labels
    probe = pallas_probe.run(batches=(4, 8), n_scan=1, **CUT_MEASURE)
    assert set(probe) - TABLE_EXTRAS == _printed_keys(_function(_tree(SCRIPTS / "pallas_probe.py"), "main"))
    assert [(r["label"], r["route"]) for r in probe["pallas_probe"]] == [
        ("det128_b4_xla", "plain"), ("det128_b4_pallas", "kernels"),
        ("det128_b8_xla", "plain"), ("det128_b8_pallas", "kernels")]
    # one state, one generator seed: the routes compute the same steps
    assert probe["pallas_probe"][0]["flops_per_step"] == probe["pallas_probe"][1]["flops_per_step"]


def test_bench_inference_keys():
    out = bench_inference.run("cpu", tiny=True, **CUT_INFERENCE)
    assert set(out) - {"device"} == _bench_inference_keys()
    assert all(math.isfinite(v) and v > 0 for k, v in out.items() if k not in ("device", "horizon"))
    assert out["horizon"] == 25 and out["device"]["platform"] == "cpu"


def test_dist_fact_offsets():
    """The score reads each adversary's relative prey positions: columns
    102-121 of its obs (4 + 2·20 + 2·29)."""
    states = torch.zeros(2, 3, 5660)
    adv = states[..., : 30 * 142].view(2, 3, 30, 142)
    adv[..., 102:122] = 3.0  # every prey at (3, 3): distance 3·sqrt(2)
    adv[:, :, 0, 104:106] = torch.tensor([0.0, 1.0])  # adversary 0: prey 1 at distance 1
    score = bench_inference.dist_fact(states, None)
    assert score.shape == (3, 30)
    torch.testing.assert_close(score[:, 0], torch.full((3,), -2.0))
    torch.testing.assert_close(score[:, 1:], torch.full((3, 29), -2 * 3 * math.sqrt(2)))


def test_native_env_bench_keys():
    main = _function(_tree(SCRIPTS / "native_env_bench.py"), "main")
    names = {t.id for n in ast.walk(main) if isinstance(n, ast.Assign) for t in n.targets if isinstance(t, ast.Name)}
    assert set(native_env_bench.JAX_NAMES) == names
    out = native_env_bench.run("cpu", n_single=4, n_batched=2, n_envs=2, n_local=2)
    figures = out["native_env_bench"]
    assert set(figures) == set(native_env_bench.JAX_NAMES.values()) | {"speedup_single", "speedup_batched"}
    assert all(math.isfinite(v) and v > 0 for v in figures.values()) and out["device"]["platform"] == "cpu"


# ---------------------------------------------------------------- no card, no run
@pytest.mark.parametrize("entry", [
    lambda: bench_main.run(tiny=True),
    lambda: perf_matrix.run(tiny=True),
    lambda: perf_matrix.measure(ModelConfig(), 4, 1, tiny=True),
    lambda: mfu_ceiling.run(tiny=True),
    lambda: pallas_probe.run(tiny=True),
    lambda: bench_inference.run(tiny=True),
    lambda: native_env_bench.run(),
], ids=["bench", "perf_matrix", "measure", "mfu_ceiling", "pallas_probe", "bench_inference", "native_env_bench"])
def test_entry_points_raise_without_a_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_cli_runs_on_the_cpu_when_asked(capsys, tmp_path):
    native_env_bench.main(["--device", "cpu", "--out", str(tmp_path / "n.json")])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert (tmp_path / "n.json").read_text().strip() == last
