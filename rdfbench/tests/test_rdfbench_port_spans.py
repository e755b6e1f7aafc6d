"""The per-layer metrics read from the port's own spans and phases
(`repro_torch.trace`): reported by a traced run of the workload cell,
absent from an untraced one, and absent, without an error, where the
program has no such module (an earlier commit of the port)."""
from __future__ import annotations

import json
import sys

import pytest

from rdfbench import program, registry, run
from rdfbench.trace import TraceSummary

REQUEST_METRICS = ("driver.host_ms.workload",
                   "executor.sync_wait_ms.workload",
                   "executor.syncs.workload", "answers.d2h_mb.workload")
SETUP_METRICS = ("store.sort_s", "views.materialize_s")
SPAN_METRICS = REQUEST_METRICS + SETUP_METRICS


def _run(root, capsys, monkeypatch, trace: int):
    """One CPU run of `lubm-50.workload`; its result line and the rows
    of each member of one more request to its program."""
    made = []
    real = program.set_up

    def set_up(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(program, "set_up", set_up)
    assert run.main(["--workload", "lubm-50.workload", "--seed",
                     str(2**31 + 11), "--seconds", "1", "--trace",
                     str(trace)], device="cpu", root=root) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return line, made[0].run_workload()


def test_a_traced_run_reports_the_span_metrics(tiny_root, capsys,
                                               monkeypatch):
    line, members = _run(tiny_root, capsys, monkeypatch, trace=1)
    assert line["correct"] is True
    metrics = line["metrics"]
    assert set(SPAN_METRICS) <= set(metrics)
    for name in SPAN_METRICS:
        assert metrics[name]["value"] > 0
    # a flag transfer, then each member's count and, where it has any,
    # its rows
    filled = sum(rows.nbytes > 0 for rows in members.values())
    assert metrics["executor.syncs.workload"]["value"] == \
        1 + len(members) + filled
    assert metrics["store.sort_s"]["unit"] == "s"


def test_an_untraced_run_reports_none_of_them(tiny_root, capsys,
                                              monkeypatch):
    line, _ = _run(tiny_root, capsys, monkeypatch, trace=0)
    assert line["correct"] is True
    assert not set(SPAN_METRICS) & set(line["metrics"])


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_program_without_the_span_module_reads_none(name, monkeypatch):
    import repro_torch

    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    monkeypatch.delattr(repro_torch, "trace", raising=False)
    ctx = run.Context(
        cell="lubm-50.workload", kind="workload", setup_s=1.0,
        steps={"store.build_s": 1.0, "session.apply_s": 1.0}, window_s=1.0,
        latencies_s=[0.001], failed=0, telemetry={},
        trace=TraceSummary(window_s=1.0, busy_s=0.1, requests=1))
    assert registry.metric_reader(name)(ctx) is None


@pytest.mark.parametrize("name", REQUEST_METRICS)
def test_request_metrics_read_none_outside_a_traced_workload(name):
    traced = TraceSummary(window_s=1.0, busy_s=0.1, requests=1)
    read = registry.metric_reader(name)
    for kind, summary in (("group", traced), ("workload", None)):
        ctx = run.Context(
            cell="lubm-50.workload", kind=kind, setup_s=1.0, steps={},
            window_s=1.0, latencies_s=[0.001], failed=0, telemetry={},
            trace=summary)
        assert read(ctx) is None
