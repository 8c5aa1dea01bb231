"""Nothing the harness runs loads JAX or the JAX package, and the plain
reference imports nothing of the program. Module names are compared by
their top-level part whole: ``quiver_tpu_torch`` begins with
``quiver_tpu`` and is not it."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from qbench.manifest import ROOT
from qbench.run import FORBIDDEN, forbidden_modules

SOURCES = sorted(p for p in ROOT.rglob("*.py") if "__pycache__" not in p.parts)


def imported_tops(path) -> set:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.partition(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.partition(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_benchmark_file_imports_jax_or_the_jax_package(path):
    assert not imported_tops(path) & set(FORBIDDEN)
    if "reference" in path.relative_to(ROOT).parts:
        assert "quiver_tpu_torch" not in imported_tops(path)


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "quiver_tpu_torch_lookalike", object())
    assert "quiver_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "quiver_tpu.sub", object())
    assert "quiver_tpu" in forbidden_modules()


def test_what_a_run_imports_holds_no_jax():
    """A fresh interpreter imports every module of the harness and the
    program's modules that its systems and entries load."""
    code = """
import json, sys, importlib
from qbench import manifest
for p in sorted(manifest.ROOT.rglob('*.py')):
    if '__pycache__' in p.parts or 'tests' in p.parts:
        continue
    rel = p.relative_to(manifest.ROOT.parent).with_suffix('')
    if any('.' in part for part in rel.parts):
        manifest.load_module(p)
    else:
        importlib.import_module('.'.join(rel.parts))
for m in ('quiver_tpu_torch', 'quiver_tpu_torch.index.ivf', 'quiver_tpu_torch.ops.ivf_cuda'):
    importlib.import_module(m)
from qbench.run import forbidden_modules
print(json.dumps(forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT.parent, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
