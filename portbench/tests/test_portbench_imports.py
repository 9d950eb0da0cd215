"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names, and the reference takes nothing from the port."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from portbench.registry import HERE
from portbench.run import FORBIDDEN, forbidden_modules

ROOT = HERE.parent


def imported_tops(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not imported_tops(path) & FORBIDDEN, path


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "deepfm_tpu_torch_lookalike", sys)
    assert "deepfm_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "deepfm_tpu.models", sys)
    assert forbidden_modules() == ["deepfm_tpu"]


def test_a_run_loads_the_port_and_no_jax():
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(HERE / 'tests')!r}]\n"
        "from portbench_helpers import run_tiny, tiny_benchmark\n"
        "from portbench.run import forbidden_modules\n"
        "run_tiny(tiny_benchmark(), 'tiny-xdeepfm.score', seconds=0.2)\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'deepfm_tpu_torch' in tops, 'the port was not loaded'\n"
        "print('FOUND', forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout


def test_reference_is_independent_of_the_port():
    for path in (HERE / "reference").rglob("*.py"):
        text = path.read_text()
        for name in ("deepfm_tpu", "jax", "flax"):
            assert name not in text, (path, name)
        assert imported_tops(path) <= {"__future__", "contextlib", "math",
                                       "torch"}, path
    # the model kinds' files hold the rest of the reference
    for path in (HERE / "models").glob("*.py"):
        text = path.read_text()
        for name in ("deepfm_tpu", "jax", "flax", "portbench.port",
                     "portbench.entries"):
            assert name not in text, (path, name)
        assert imported_tops(path) <= {"__future__", "math", "torch",
                                       "portbench"}, path
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}]\n"
        "from portbench.registry import Registry\n"
        "reg = Registry()\n"
        "for name in reg.names('models', '.py'):\n"
        "    reg.model(name)\n"
        "print('TOPS', sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "'deepfm_tpu_torch'" not in out.stdout
    assert "'jax'" not in out.stdout
