"""Nothing the benchmark runs loads JAX or the JAX package (top-level
names compared whole: ``onepose_tpu_torch`` is the system under test),
and the plain reference loads nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys

from portbench.common import FORBIDDEN
from portbench.manifest import PACKAGE, ROOT


def imported(path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_imports_jax_or_the_jax_package():
    for path in PACKAGE.rglob("*.py"):
        assert not imported(path) & set(FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (PACKAGE / "reference").glob("*.py"):
        assert imported(path) <= {"__future__", "typing", "math", "numpy",
                                  "torch", "portbench"}, path


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys\n"
        "from portbench.tests.small import small_work\n"
        "from portbench.run import run_cell\n"
        "from portbench.common import forbidden_modules\n"
        "for name in ('pose-fp32-b128', 'detect-fp32-15views'):\n"
        "    run_cell(small_work(name), 3, 0.5, False, 'cpu')\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
