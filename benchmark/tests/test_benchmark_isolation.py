"""Nothing the benchmark runs loads JAX or the JAX package: an AST scan of
``benchmark/`` and a look at ``sys.modules`` after a CPU import of every
driver and metric reader.  Top-level names are compared whole, because
``mfvae_tpu_torch`` begins with ``mfvae_tpu``."""

import ast
import json
import subprocess
import sys

from benchmark import common


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    found = {}
    for path in sorted(common.HERE.rglob("*.py")):
        bad = [m for m in _imports(path) if m.split(".")[0] in common.FORBIDDEN]
        if bad:
            found[str(path.relative_to(common.ROOT))] = bad
    assert not found


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((common.HERE / "reference").rglob("*.py")):
        assert not [m for m in _imports(path) if m.split(".")[0] == "mfvae_tpu_torch"], path


def test_the_top_level_name_is_compared_whole():
    assert "mfvae_tpu_torch" not in common.FORBIDDEN
    assert "mfvae_tpu" in common.FORBIDDEN


def test_sys_modules_after_importing_every_driver_and_reader():
    code = (
        "import json, sys; sys.path.insert(0, %r)\n"
        "from benchmark import common, harness\n"
        "import mfvae_tpu_torch.training.experiment, mfvae_tpu_torch.inference\n"
        "for p in sorted((common.HERE / 'drivers').glob('*.py')):\n"
        "    p.stem != '__init__' and common.load_module('drivers', p.stem)\n"
        "for p in sorted((common.HERE / 'metrics').glob('*.py')):\n"
        "    common.load_module('metrics', p.stem)\n"
        "print(json.dumps(common.forbidden_modules()))\n" % str(common.ROOT)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
