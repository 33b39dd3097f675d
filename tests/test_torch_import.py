"""The port stands alone: ``repro_torch`` imports with jax blocked, loads
no module of the reference package, and neither it nor ``chip_smoke.py``
names ``jax`` or ``repro`` in an import."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any "import jax" now raises
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                     "repro_torch."))
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and (m in ("repro", "jax") or m.startswith(("repro.", "jax."))))
print(len(names))
print(",".join(leaked))
"""


def test_every_module_imports_with_jax_blocked_and_loads_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert int(lines[0]) >= 25
    assert lines[1:] in ([], [""]), lines[1:]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_reference(path):
    bad = [m for m in _imported_roots(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == [], f"{path}: {bad}"
