"""The import guard: nothing a run loads is JAX or the JAX package, and
the reference loads nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys
import types

import pytest

from rdfbench import registry, run

FORBIDDEN_IN_SOURCES = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in sorted(registry.HERE.rglob("*.py")):
        assert not _imports(path) & FORBIDDEN_IN_SOURCES, path


def test_reference_sources_import_nothing_of_the_program():
    for path in [*sorted((registry.HERE / "reference").rglob("*.py")),
                 *sorted((registry.HERE / "data").rglob("*.py"))]:
        assert "repro_torch" not in _imports(path), path
        assert "torch" not in _imports(path), path


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import rdfbench.reference.rdfs_cq, rdfbench.data.lubm;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'torch'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=registry.ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_extra", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    assert run.forbidden_modules() == ["repro"]


def test_a_run_that_loaded_jax_prints_no_result(tiny_root, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(SystemExit, match="jax"):
        run.main(["--workload", "lubm-50.workload", "--seed", "1",
                  "--seconds", "0.2"], device="cpu", root=tiny_root)
    assert capsys.readouterr().out == ""
