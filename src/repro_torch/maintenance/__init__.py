"""Streaming incremental view maintenance.

The counterpart of `repro/maintenance/`, with the same `__all__`.

The subsystem that turns the tuner from a one-shot wizard into a system
that survives a write-heavy graph without stopping serving:

  * `UpdateStream` / `Delta` — batched triple insert/delete ingestion
    (stream.py);
  * `build_delta_plans` — per-view incremental plans derived from the
    view CQs, canonicalized into one shared workload DAG (delta_plan.py);
  * `ViewMaintainer` — the per-batch device maintenance pass: host
    membership deletes + CUDA scatter-append inserts over capacity-
    class buffers, measured costs into the quality model (maintainer.py);
  * `DriftDetector` — update-rate and selectivity-shift monitoring that
    recommends a retune (drift.py).

Session integration lives in `api/session.py` (`TuningSession.ingest`,
measured costs at retune).
"""
from repro_torch.maintenance.delta_plan import (DELTA_VID_BASE, DeltaLeaf,
                                                DeltaPlanSet,
                                                build_delta_plans,
                                                delta_plan_for_atom)
from repro_torch.maintenance.drift import DriftDetector, DriftReport
from repro_torch.maintenance.maintainer import (MaintenanceConfig,
                                                MaintenanceReport,
                                                ViewMaintainer)
from repro_torch.maintenance.stream import Delta, UpdateStream

__all__ = [
    "DELTA_VID_BASE", "Delta", "DeltaLeaf", "DeltaPlanSet", "DriftDetector",
    "DriftReport", "MaintenanceConfig", "MaintenanceReport", "UpdateStream",
    "ViewMaintainer", "build_delta_plans", "delta_plan_for_atom",
]
