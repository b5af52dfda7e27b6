"""The port stands alone: importing every module of ``repro_torch`` loads
neither JAX nor any module of the JAX package ``repro``, and
``chip_smoke.py`` imports neither."""
import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _port_modules() -> list[str]:
    import repro_torch
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]


def test_port_imports_no_jax_and_no_repro():
    mods = _port_modules()
    assert {"repro_torch.kernels.histogram", "repro_torch.federation.session",
            "repro_torch.convert", "repro_torch.serving.plan"} <= set(mods)
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(mods) <= set(loaded)
    assert [m for m in loaded if _forbidden(m)] == []


def _imported_names(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    return names


def test_chip_smoke_imports_no_jax_and_no_repro():
    names = _imported_names(ROOT / "chip_smoke.py")
    assert "torch" in names and any(n.startswith("repro_torch") for n in names)
    assert [n for n in names if _forbidden(n)] == []


def test_port_sources_import_no_jax_and_no_repro():
    """The same check on the sources, so that a lazy import inside a
    function cannot slip past the subprocess check."""
    bad = {str(p.relative_to(SRC)): n
           for p in (SRC / "repro_torch").rglob("*.py")
           for n in _imported_names(p) if _forbidden(n)}
    assert bad == {}
