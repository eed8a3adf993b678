"""``BENCHMARK.json`` against the shape the file must keep, every name resolving
to its file, and the run's refusal without a card."""

import json
import os
import re
import subprocess
import sys

import pytest

from benchmark import common, harness

BENCH = common.load_json(common.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((common.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert (common.ROOT / BENCH["command"][1]).is_file()


def test_names_units_and_lines():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in BENCH[k]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for k in ("end_to_end", "per_layer"):
        assert len({e["name"] for e in BENCH[k]}) == len(BENCH[k])
        for e in BENCH[k]:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    texts = [e["why"] for k in ("configs", "workloads") for e in BENCH[k]] + [e["layer"] for e in BENCH["per_layer"]]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t and t.isascii() for t in texts)


def test_every_name_resolves_to_its_file():
    for c in BENCH["configs"]:
        assert (common.ROOT / c["file"]).is_file()
        assert common.config_dict(c["name"])["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        work = common.workload(w["name"])
        assert work["config"] == w["config"] and w["chips"] == 1
        assert (common.HERE / "drivers" / f"{work['driver']}.py").is_file()
        driver = common.load_module("drivers", work["driver"])
        assert all(hasattr(driver, f) for f in ("setup", "window", "trace", "release", "check", "stand_in"))
    for m in BENCH["per_layer"]:
        assert callable(common.load_module("metrics", m["name"]).read)


def test_every_workload_file_resolves_listed_or_not():
    for path in sorted((common.HERE / "workloads").glob("*.json")):
        work = common.workload(path.stem)
        assert (common.HERE / "configs" / f"{work['config']}.json").is_file()
        assert (common.HERE / "drivers" / f"{work['driver']}.py").is_file()
        assert work["limits"] and 1 <= len(work["why"]) <= 200


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    e2e_names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e_names
    for cell in CELLS:
        e2e, layer = harness.cell_metrics(BENCH, cell)
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer
        assert all(m["moves"] in names for m in layer)
        assert any("mfu" in m["name"] for m in layer)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_without_a_card_the_run_prints_no_result(cell, tmp_path):
    out = subprocess.run(
        [sys.executable, str(common.ROOT / "benchmark" / "run.py"), "--workload", cell, "--seed", "3000000017",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=240, cwd=tmp_path,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "", "TMPDIR": str(tmp_path), "HOME": str(tmp_path)},
    )
    assert out.returncode != 0
    assert "no CUDA card" in out.stderr
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_without_the_program_the_run_fails(tmp_path):
    import shutil

    shutil.copytree(common.HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=240, cwd=tmp_path,
        env={"PATH": "/usr/bin:/bin", "TMPDIR": str(tmp_path), "HOME": str(tmp_path)},
    )
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_overrides_reach_both_sides():
    run = harness.Run("tag_ref.train_b128", 5, __import__("torch").device("cpu"), ["model.decoder_hidden=[16,8]"])
    assert run.cfg.model.decoder_hidden == (16, 8) and run.conf["model"]["decoder_hidden"] == [16, 8]
    assert run.cfg.train.batch_size == 128 and run.cfg.train.seed == 5
    assert json.loads(json.dumps(run.traffic)) == run.traffic


def test_two_cores_on_different_physical_cores():
    from benchmark import host

    pairs = lambda shift: lambda c: {c % shift, c % shift + shift}  # noqa: E731
    assert host.choose(set(range(8)), pairs(4)) == [6, 7]
    assert host.choose(set(range(8)), lambda c: {c - c % 2, c - c % 2 + 1}) == [5, 7]
    assert host.choose({2, 3, 9}, lambda c: {c}) == [3, 9]
    assert host.choose({4}, lambda c: {c}) == [4]
    assert host.choose({0, 1, 2}, lambda c: {0, 1, 2}) == [1, 2]


def test_a_steady_process_has_one_thread_on_its_pinned_cores():
    from benchmark import host

    code = (
        "import json, os, sys; sys.path.insert(0, %r)\n"
        "from benchmark import host; cpus = host.steady(); load = host.Load()\n"
        "import torch; sum(range(10**5))\n"
        "print(json.dumps([cpus, sorted(os.sched_getaffinity(0)), torch.get_num_threads(), load.read()]))\n"
        % str(common.ROOT)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    cpus, pinned, threads, load = json.loads(out.stdout.strip().splitlines()[-1])
    assert cpus == pinned == host.choose(os.sched_getaffinity(0)) and threads == 1
    assert load["pinned"] == pinned and 0.0 <= load["steal_pct"] <= 100.0
    assert 0.0 <= load["others_busy_pct"] <= 100.0 and load["involuntary_switches"] >= 0


class _Prof:
    device_ops = [("k", 0.0, 2e5, True), ("k", 1e5, 3e5, True), ("k", 6e5, 7e5, True)]  # busy 0.4 s

    def busy_s(self):
        return common.Profiled.busy_s(self)


@pytest.mark.parametrize("metric,key", [("idle_pct.epoch", "epochs"), ("idle_pct.train", "steps"),
                                        ("idle_pct.rollout", "requests")])
def test_idle_share_is_against_the_untraced_wall(metric, key):
    data = {"prof": _Prof(), "profiled": {"wall_s": 4.0, key: 2}, "plain": {"wall_s": 2.0, key: 4}}
    assert common.load_module("metrics", metric).read(data) == pytest.approx(60.0)
