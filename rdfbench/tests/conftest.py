"""A checkout root of the benchmark at a size the CPU holds."""
from __future__ import annotations

import json
import shutil
import sys

import pytest

from rdfbench import registry, run

TINY_UNIVERSITIES = 1
# one query a request, each through its own operator tree: the harness's
# second kind of request, which no cell of BENCHMARK.json sends yet
PER_QUERY = {"request": "group", "draw": "weights", "loop": "closed",
             "clients": 1}


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """`tmp_path` as a checkout root: BENCHMARK.json and rdfbench's
    configs, traffic mixes and metric readers, the configurations cut to
    one university, and a per-query cell `lubm-50.perquery`."""
    monkeypatch.setenv("TORCH_EXTENSIONS_DIR", str(tmp_path / "ext"))
    monkeypatch.setenv("TRITON_CACHE_DIR", str(tmp_path / "triton"))
    bench = tmp_path / registry.HERE.name
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(registry.HERE / d, bench / d)
    for path in (bench / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["universities"] = TINY_UNIVERSITIES
        path.write_text(json.dumps(cfg))
    (bench / "traffic" / "perquery.json").write_text(json.dumps(PER_QUERY))
    spec = json.loads((registry.ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "lubm-50.perquery", "config": "lubm-50",
                              "traffic": "perquery", "chips": 1,
                              "why": "the per-query path, for the tests"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path


@pytest.fixture(autouse=True)
def _hide_jax_modules(monkeypatch):
    """Other test files may have loaded JAX and the JAX package into this
    worker; a harness run checks `sys.modules` for them, so they are out
    of it for the length of each test here and put back after."""
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
