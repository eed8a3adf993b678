"""``scripts/torch_distill_seed_ci.py``: its protocol equals the JAX
package's (``scripts/distill_seed_ci.py``, ``sticky_study.train_sticky``,
``dreamer_iteration_study.behavior_cfg``, read by AST, so no JAX study
script is imported), and a run on the CPU at a cut depth and width writes
the keys of ``results/r4/distill_seed_ci.json`` plus the port's own.
"""

import ast
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import torch_distill_seed_ci as ci  # noqa: E402

from tests.test_torch_experiment import one_torch_thread  # noqa: E402,F401

# where a run writes, not what it computes
PATHS = {"train.run_name", "train.log_dir", "train.checkpoint_dir"}
TINY = [
    "env.num_good_agents=1", "env.num_adversaries=2", "env.num_obs=1", "env.max_steps=16",
    "model.det_features=8", "model.idx_features=8", "model.obs_features=8", "model.action_features=8",
    "model.encoder_hidden=16", "model.decoder_hidden=32", "model.compute_dtype=float32",
    "buffer.max_size=256", "buffer.min_size=16", "buffer.batch_size=16",
    "train.epoch_num=2", "train.sample_num=16", "train.train_num=1", "train.test_num=1",
    "behavior.start_pool=8", "behavior.start_burn_in=2", "behavior.n_starts=4",
    "behavior.m_rollouts=2", "behavior.horizon=2", "behavior.visit_steps=1", "behavior.hidden=8",
]


def function(path: Path, name: str) -> ast.FunctionDef:
    tree = ast.parse(path.read_text())
    return next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name)


def module_constants(path: Path) -> dict:
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = node.value.value
    return out


def defaults(fn: ast.FunctionDef) -> dict:
    args = fn.args.args
    return {a.arg: ast.literal_eval(d) for a, d in zip(args[len(args) - len(fn.args.defaults):], fn.args.defaults)}


def cfg_assignments(fn: ast.FunctionDef, names: dict) -> dict:
    """{'section.field': value} of every ``cfg.section.field = value`` in
    ``fn`` but the paths, names resolved from ``names``."""
    out = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Attribute):
            t = node.targets[0]
            if isinstance(t.value, ast.Attribute) and getattr(t.value.value, "id", None) == "cfg":
                key, v = f"{t.value.attr}.{t.attr}", node.value
                if key not in PATHS:
                    out[key] = names[v.id] if isinstance(v, ast.Name) else ast.literal_eval(v)
    return out


def jax_protocol():
    """The JAX seed CI's protocol: main's defaults, the world model's
    config (train_sticky called as distill_seed_ci calls it) and the
    behavior settings."""
    scripts = ROOT / "scripts"
    ci_path = scripts / "distill_seed_ci.py"
    consts = module_constants(ci_path)
    main = function(ci_path, "main")
    call = next(n for n in ast.walk(main) if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "train_sticky")
    call_args = dict(zip(("unroll", "epochs"), (ast.literal_eval(a) for a in call.args)))
    for kw in call.keywords:
        call_args[kw.arg] = consts[kw.value.id] if isinstance(kw.value, ast.Name) else ast.literal_eval(kw.value)
    sticky = function(scripts / "sticky_study.py", "train_sticky")
    world = cfg_assignments(sticky, {**defaults(sticky), **call_args})
    behavior = cfg_assignments(function(scripts / "dreamer_iteration_study.py", "behavior_cfg"),
                               {**module_constants(scripts / "dreamer_iteration_study.py"),
                                "updates": defaults(main)["updates"]})
    # PRNGKey(1000 + s) and PRNGKey(1234 + c)
    seeds = sorted(n.left.value for n in ast.walk(main)
                   if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Add) and isinstance(n.left, ast.Constant))
    anchor = next(v for n in ast.walk(main) if isinstance(n, ast.Dict)
                  for k, v in zip(n.keys, n.values) if getattr(k, "value", None) == "headline_anchor")
    return consts, defaults(main), world, behavior, seeds, ast.literal_eval(anchor)


def test_protocol_equals_the_jax_scripts(tmp_path):
    consts, main_defaults, world, behavior, seeds, anchor = jax_protocol()
    assert ci.HOLD == consts["HOLD"]
    assert (ci.SEEDS, ci.UPDATES, ci.N_EPISODES, ci.EP_LEN, ci.CHUNKS) == tuple(
        main_defaults[k] for k in ("seeds", "updates", "n_episodes", "ep_len", "chunks"))
    assert seeds == [ci.BEHAVIOR_SEED, ci.EVAL_SEED]
    assert ci.HEADLINE_ANCHOR == anchor
    cfg = ci.build_config(ci.UPDATES, tmp_path, tmp_path / "ck", [])
    assert len(world) == 19 and len(behavior) == 10  # every edit was read
    for key, want in {**world, **behavior}.items():
        section, field = key.split(".")
        assert getattr(getattr(cfg, section), field) == want, key


def cut_args(tmp_path, seed: int, out: Path):
    return ["--device", "cpu", "--seeds", str(seed), "--updates", "2", "--episodes", "2", "--ep-len", "8",
            "--chunks", "1", "--work", str(tmp_path / "work"), "--ckpt", str(tmp_path / "ck"),
            "--out", str(out), *TINY]


def test_cut_run_writes_the_jax_keys(tmp_path):
    out_path = tmp_path / "out.json"
    out = ci.main(cut_args(tmp_path, 0, out_path))
    want = json.loads((ROOT / "results" / "r4" / "distill_seed_ci.json").read_text())
    assert set(out) == set(want) | {"card", "walls_s", "world_model", "protocol"}
    assert json.loads(out_path.read_text()) == out
    assert out["card"] == "cpu" and out["seeds"] == 1 and out["updates"] == 2
    assert [r["seed"] for r in out["per_seed"]] == [0]
    assert set(out["per_seed"][0]) >= set(want["per_seed"][0])
    assert set(out["random_anchor"]) == set(want["random_anchor"])
    assert set(out["across_seeds"]) == set(want["across_seeds"])
    assert out["world_model"]["epochs"] == 2 and out["world_model"]["loss_test"] is not None
    assert {"world_model", "random_eval", "distill_seed0", "eval_seed0", "total"} <= set(out["walls_s"])

    # a second run over another seed reuses the saved world model, and the
    # merge joins the two
    out2 = ci.main(cut_args(tmp_path, 1, tmp_path / "out2.json"))
    assert out2["world_model"] == out["world_model"] and out2["random_anchor"] == out["random_anchor"]
    merged = ci.merge([out_path, tmp_path / "out2.json"])
    assert [r["seed"] for r in merged["per_seed"]] == [0, 1] and merged["seeds"] == 2
    with pytest.raises(ValueError, match="repeat a seed"):
        ci.merge([out_path, out_path])
