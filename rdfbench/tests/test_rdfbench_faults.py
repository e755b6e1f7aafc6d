"""`correct` comes out false when the timed path is broken underneath,
and under the control (the program without the RDFS guarantee)."""
from __future__ import annotations

import numpy as np
import pytest

from rdfbench import control, run

engine = pytest.importorskip("repro_torch.query.engine")


def _altered(real):
    def to_numpy(rel):
        out = real(rel).copy()
        if len(out):
            out[0, 0] += 1          # one answer altered where it is made
        return out
    return to_numpy


def _half(real):
    def to_numpy(rel):
        out = real(rel)
        return out[: len(out) // 2]   # half of each answer left out
    return to_numpy


@pytest.mark.parametrize("fault", ["altered", "half", "control"])
@pytest.mark.parametrize("cell", ["lubm-50.workload", "lubm-50.perquery"])
def test_correct_is_false(tiny_root, monkeypatch, cell, fault):
    overrides = None
    if fault == "control":
        overrides = control.BROKEN
    else:
        wrap = _altered if fault == "altered" else _half
        monkeypatch.setattr(engine, "to_numpy", wrap(engine.to_numpy))
    res = run.run_cell(cell, 31, 0.5, False, device="cpu", root=tiny_root,
                       overrides=overrides)
    assert res["attempted"] > 0
    assert res["correct"] is False
    assert res["checks"]["wrong_rows"]["value"] > 0
    assert list(res)[-1] == "checks"
    assert np.isfinite(res["metrics"]["setup_s"]["value"])
