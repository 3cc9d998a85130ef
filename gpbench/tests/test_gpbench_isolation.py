"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: ``friedrich_tpu_torch`` begins with ``friedrich_tpu``."""

import ast
import subprocess
import sys

from gpbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "friedrich_tpu"}


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax():
    for path in harness.PACKAGE.rglob("*.py"):
        assert not top_level_imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.PACKAGE / "reference").rglob("*.py"):
        names = top_level_imports(path)
        assert names <= {"__future__", "contextlib", "math", "torch"}, (path, names)
        assert "friedrich_tpu_torch" not in names and "gpbench" not in names


def test_a_run_loads_no_jax():
    """In a fresh interpreter, a whole tiny run leaves no forbidden module
    in ``sys.modules``."""
    code = ("import sys; from gpbench.tests.tiny import run_tiny; from gpbench import harness; "
            "r = run_tiny('gp50k-bo', seconds=0.3); "
            "print(harness.forbidden_modules(), r['correct'])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "friedrich_tpu_torch_like", sys)
    assert "friedrich_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]
