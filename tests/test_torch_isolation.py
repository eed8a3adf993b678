"""The PyTorch port and its chip smoke script import nothing of JAX and
nothing of the JAX package (an AST scan of every import statement)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# the scripts/torch_* that run the port alone on the card; torch_seed_band,
# torch_vdn_seed_band and torch_tooling_band (through torch_seed_band)
# measure JAX's seed bands and import both packages
CARD_SCRIPTS = ("ab_smoke", "baseline_run", "canonical_run", "distill_seed_ci", "epoch_breakdown", "k3_variants",
                "span_split")
FILES = sorted((ROOT / "mfvae_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"] + [
    ROOT / "scripts" / f"torch_{name}.py" for name in CARD_SCRIPTS]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "mfvae_tpu")


def imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_whole_package():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for must in ("mfvae_tpu_torch/ops/fused_elbo.py", "mfvae_tpu_torch/training/trainer.py",
                 "mfvae_tpu_torch/training/popart.py", "mfvae_tpu_torch/envs/policies.py",
                 "mfvae_tpu_torch/training/unroll.py", "mfvae_tpu_torch/inference.py",
                 "mfvae_tpu_torch/rollout_eval.py", "mfvae_tpu_torch/planning.py",
                 "mfvae_tpu_torch/envs/render.py", "mfvae_tpu_torch/imagination.py",
                 "mfvae_tpu_torch/behavior.py", "mfvae_tpu_torch/baselines/vdn.py",
                 "mfvae_tpu_torch/baselines/iql.py", "mfvae_tpu_torch/baselines/qmix.py",
                 "mfvae_tpu_torch/baselines/dyna.py", "mfvae_tpu_torch/baselines/collect_policy.py",
                 "mfvae_tpu_torch/models/qlearning.py", "mfvae_tpu_torch/envs/wrappers.py",
                 "mfvae_tpu_torch/utils/native_build.py", "mfvae_tpu_torch/envs/native_engine.py",
                 "mfvae_tpu_torch/data/host_buffer.py", "mfvae_tpu_torch/envs/host_adapter.py",
                 "mfvae_tpu_torch/training/host_experiment.py", "mfvae_tpu_torch/data/compat.py",
                 "mfvae_tpu_torch/data/synthetic.py", "mfvae_tpu_torch/models/vae.py",
                 "mfvae_tpu_torch/models/factorized.py", "mfvae_tpu_torch/training/vae_trainer.py",
                 "mfvae_tpu_torch/training/vae_experiment.py", "mfvae_tpu_torch/parallel/__init__.py",
                 "mfvae_tpu_torch/parallel/mesh.py", "mfvae_tpu_torch/parallel/sharding.py",
                 "mfvae_tpu_torch/parallel/tp.py", "mfvae_tpu_torch/parallel/dp.py",
                 "mfvae_tpu_torch/parallel/pp.py", "mfvae_tpu_torch/bench/common.py", "chip_smoke.py",
                 *(f"scripts/torch_{name}.py" for name in CARD_SCRIPTS)):
        assert must in names
