"""The port and chip_smoke.py import neither JAX nor the JAX package."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "featurematching_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN_TOP = {"jax", "jaxlib", "flax", "optax", "orbax", "featurematching_tpu"}


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN_TOP]
    assert not bad, f"{path.name} imports {bad}"


def test_files_found():
    assert len(FILES) > 10


def test_training_modules_are_checked():
    names = {str(p.relative_to(ROOT / "featurematching_tpu_torch")) for p in FILES[:-1]}
    assert {"ops/swin_block_train.py", "ops/sparse_focal_loss.py", "matching/supervision.py",
            "losses/loss.py", "train/optimizer.py", "train/step.py", "data/synthetic.py",
            "models/matcher.py"} <= names
