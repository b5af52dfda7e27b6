"""Nothing under ``bench/`` imports JAX or the JAX package, and the
reference imports nothing of the program.  Top-level module names are
compared whole: the port's name, ``repro_torch``, begins with the JAX
package's, ``repro``."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                out.add(node.args[0].value.split(".")[0])
    return out


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & NEVER


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    mods = top_level_imports(path)
    assert not mods & (NEVER | {"repro_torch", "bench"}), mods
    assert mods <= {"__future__", "concurrent", "dataclasses", "numpy",
                    "torch"}


def test_whole_names_are_compared():
    assert "repro_torch".split(".")[0] not in NEVER
    assert "repro.core".split(".")[0] in NEVER


def test_a_run_leaves_no_jax_module_loaded():
    import subprocess
    import sys
    code = ("import sys; sys.path[:0] = ['src', '.']\n"
            "from bench import harness, control, knee\n"
            "from bench.drivers import fit_loop, open_loop\n"
            "import repro_torch.federation, repro_torch.serving\n"
            "bad = harness.forbidden_modules()\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                   check=True, timeout=120)
