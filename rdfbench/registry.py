"""Find a cell's files by name.

`BENCHMARK.json` at the checkout's root names each cell's configuration
and traffic mix and each metric; the files themselves sit under this
folder: `configs/<config>.json`, `traffic/<mix>.json` and
`metrics/<metric>.py`.  A new cell, configuration, mix or metric is new
files and new entries, never an edit of code here.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list       # BENCHMARK.json entries this cell reports
    per_layer: list


def _reported(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root/BENCHMARK.json`, with its files read."""
    spec = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[name]
    bench = root / HERE.name
    config = _json(bench / "configs" / f"{w['config']}.json")
    traffic = _json(bench / "traffic" / f"{w['traffic']}.json")
    return Cell(name=name, config=config, traffic=traffic,
                chips=int(w["chips"]),
                end_to_end=[m for m in spec["end_to_end"]
                            if _reported(m, name)],
                per_layer=[m for m in spec["per_layer"]
                           if _reported(m, name)])


def metric_reader(name: str, root: Path = ROOT):
    """`read(ctx) -> float | None` from `metrics/<name>.py`."""
    path = root / HERE.name / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"rdfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
