"""The harness on the CPU: the result line, data-driven files, traffic."""
from __future__ import annotations

import collections
import itertools
import json
import subprocess
import sys

import pytest

from rdfbench import loadgen, registry, run

CELLS = ["lubm-50.workload", "lubm-50.perquery"]


def _line(capsys) -> dict:
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_last_line_holds_the_result(tiny_root, capsys, cell, trace):
    rc = run.main(["--workload", cell, "--seed", str(2**31 + 7),
                   "--seconds", "1", "--trace", str(trace)],
                  device="cpu", root=tiny_root)
    assert rc == 0
    line = _line(capsys)
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert line["checks"]["wrong_rows"] == {"value": 0, "limit": 0}
    spec = registry.load_cell(cell, tiny_root)
    wanted = spec.per_layer if trace else spec.end_to_end
    names = {m["name"] for m in wanted}
    assert set(line["metrics"]) <= names
    for name, m in line["metrics"].items():
        assert m["value"] > 0 or "recompiles" in name
        assert m["unit"] == next(w["unit"] for w in wanted
                                 if w["name"] == name)
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert names == set(line["metrics"])   # every end-to-end metric


def test_without_a_card_it_exits_non_zero_and_prints_nothing():
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "rdfbench.run", "--workload",
         "lubm-50.workload", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=registry.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""


def test_dropped_in_files_are_found_by_name(tiny_root, capsys):
    bench = tiny_root / registry.HERE.name
    cfg = json.loads((bench / "configs" / "lubm-50.json").read_text())
    cfg["universities"] = 3
    (bench / "configs" / "tiny-3.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "q1only.json").write_text(json.dumps(
        {"request": "group", "loop": "closed", "clients": 1}))
    (bench / "metrics" / "requests_done.py").write_text(
        "def read(ctx):\n    return len(ctx.latencies_s) - ctx.failed\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-3", "source": "a test",
                            "file": "rdfbench/configs/tiny-3.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny-3.q1only", "config": "tiny-3",
                              "traffic": "q1only", "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "requests_done", "unit": "requests",
                               "better": "higher", "bound": 0.01,
                               "source": "host_clock",
                               "workloads": ["tiny-3.q1only"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    assert run.main(["--workload", "tiny-3.q1only", "--seed", "4",
                     "--seconds", "0.5"], device="cpu", root=tiny_root) == 0
    line = _line(capsys)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"requests_done", "setup_s"}
    assert line["metrics"]["requests_done"]["value"] == line["attempted"]


@pytest.mark.parametrize("weights", [
    {"q1": 10, "q2": 5, "q3": 3, "q4": 8, "q5": 2, "q6": 1},
    json.loads((registry.HERE / "configs" / "lubm-50.json").read_text())
    ["weights"]])
def test_group_traffic_keeps_the_weights_in_every_block(weights):
    mix = {"request": "group", "loop": "closed", "clients": 1}
    n = sum(weights.values())
    for seed in (0, 2**33 + 1):
        reqs = list(itertools.islice(loadgen.requests(mix, weights, seed),
                                     3 * n))
        for block in range(3):
            assert collections.Counter(reqs[n * block: n * block + n]) \
                == weights
    a = list(itertools.islice(loadgen.requests(mix, weights, 1), n))
    b = list(itertools.islice(loadgen.requests(mix, weights, 2), n))
    assert a != b


def test_unknown_traffic_is_refused():
    with pytest.raises(ValueError):
        next(loadgen.requests({"request": "stream"}, {}, 0))


def test_benchmark_json_names_files_that_exist():
    spec = json.loads((registry.ROOT / "BENCHMARK.json").read_text())
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        assert (registry.ROOT / c["file"]).is_file()
        assert json.loads((registry.ROOT / c["file"]).read_text())["name"] \
            == c["name"]
    for w in spec["workloads"]:
        assert w["config"] in configs
        cell = registry.load_cell(w["name"])
        loadgen.check_mix(cell.traffic)
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(registry.metric_reader(m["name"]))
