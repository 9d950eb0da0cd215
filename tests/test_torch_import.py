"""The port stands alone: it imports neither JAX nor the JAX package, and
its chip check refuses to run without a GPU or without the package."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "deepfm_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "deepfm_tpu"}

IMPORT_ALL = """
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in %r:
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
import deepfm_tpu_torch
names = []
for m in pkgutil.walk_packages(deepfm_tpu_torch.__path__, "deepfm_tpu_torch."):
    if not m.name.endswith("__main__"):
        importlib.import_module(m.name)
        names.append(m.name)
assert not [k for k in sys.modules if k.split(".")[0] in %r]
print(len(names))
""" % (FORBIDDEN, FORBIDDEN)


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_every_module_imports_with_jax_and_reference_blocked():
    out = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


@pytest.mark.parametrize(
    "path", _sources(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_source_has_no_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        bad = FORBIDDEN.intersection(roots)
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def _run_smoke(cwd):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
        text=True, timeout=120,
    )


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a GPU")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
