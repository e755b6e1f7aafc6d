"""Maintenance-plan analysis: streaming-update hazards, before serving.

The counterpart of `repro/analysis/maintenance_check.py`, copied.

The incremental maintainer (`repro_torch.maintenance`) keeps steady-state
maintenance recompile-free by construction — fixed delta capacity
classes, padded TT uploads, extent headroom at attach.  Those guarantees
hold only under a configuration + update-rate envelope; this analyzer
checks the envelope statically, in the same spirit as `capacity.py`:

  maint/delta-cap        delta_cap is not a positive power-of-two class
                         (error: every batch re-buckets and recompiles)
                         or the expected batch exceeds it (warning: each
                         batch splits into multiple device passes)
  maint/extent-headroom  a view extent's capacity class is projected to
                         be outgrown within the hazard horizon at the
                         configured update rate — every growth promotes
                         the class and recompiles the consumer buckets
  maint/tt-headroom      the padded triple-table class itself is
                         projected to be outgrown within the horizon —
                         a TT class promotion recompiles EVERY bucket
  maint/oracle-fallback  a view is maintained by the host oracle (not a
                         full projection, or its delta plan would be
                         cartesian): per-batch re-evaluation and a full
                         extent re-upload (info)
  maint/alignment        live maintainer only: the host extent mirror
                         diverged from the device valid prefix — the
                         delete path would scrub the wrong rows (error)

Static mode (a tuned `State` + statistics) simulates the maintainer's
attach packing — `capacity_for(est_rows, growth_safety)` — so a default
`MaintenanceConfig` over a sane store analyzes clean by construction;
live mode (a bound `ViewMaintainer`) checks the REAL buffer classes,
row counts and measured per-triple costs instead of estimates.
"""
from __future__ import annotations

import math

from repro_torch.analysis.findings import Finding
from repro_torch.query import cost as cost_mod
from repro_torch.query.buckets import CAP_CEIL

# warn when a capacity class is projected to be outgrown within this
# many update batches at the configured rate
GROWTH_HORIZON = 8


def _f(rule: str, severity: str, message: str, location: str = "") -> Finding:
    return Finding("maint", rule, severity, message, location)


def _check_delta_cap(cfg) -> list[Finding]:
    out: list[Finding] = []
    dcap = int(cfg.delta_cap)
    if dcap <= 0 or (dcap & (dcap - 1)) != 0:
        out.append(_f(
            "maint/delta-cap", "error",
            f"delta_cap {dcap} is not a positive power of two: delta "
            "relations would leave the capacity-class system and every "
            "batch would compile its own program"))
        return out
    if dcap > CAP_CEIL:
        out.append(_f(
            "maint/delta-cap", "error",
            f"delta_cap {dcap} exceeds the capacity ceiling {CAP_CEIL}"))
        return out
    if int(cfg.expected_batch) > dcap:
        passes = math.ceil(int(cfg.expected_batch) / dcap)
        out.append(_f(
            "maint/delta-cap", "warning",
            f"expected update batch ({cfg.expected_batch} triples) "
            f"exceeds delta_cap {dcap}: every batch splits into "
            f"{passes} chunked device passes — raise delta_cap to "
            "amortize the per-pass overhead"))
    return out


def _headroom_finding(rule: str, what: str, cap: int, rows: float,
                      growth_per_batch: float, horizon: int,
                      consequence: str, location: str) -> Finding | None:
    """Warn when `cap` is projected to be outgrown within `horizon`
    batches; None when the envelope holds."""
    if growth_per_batch <= 0:
        return None
    batches = (cap - rows) / growth_per_batch
    if batches >= horizon:
        return None
    return _f(
        rule, "warning",
        f"{what}: capacity class {cap} holds {rows:.0f} rows with "
        f"~{growth_per_batch:.1f} rows/batch projected growth — outgrown "
        f"in ~{max(batches, 0.0):.1f} batches (< horizon {horizon}); "
        f"{consequence}", location)


def analyze_maintenance(state=None, stats=None, cfg=None, *,
                        maintainer=None, update_rate: float | None = None,
                        horizon: int = GROWTH_HORIZON) -> list[Finding]:
    """Check a maintenance configuration against an update-rate envelope.

    Static mode: pass a tuned `state` + `stats` (+ optionally a
    `MaintenanceConfig`); extent sizes come from the cost estimates and
    capacities from the simulated attach packing.  Live mode: pass
    `maintainer=` (a bound `ViewMaintainer`); real device buffer
    classes, host mirrors and measured per-triple costs are checked.
    `update_rate` is triples per batch (defaults to the config's
    `expected_batch`).
    """
    from repro_torch.maintenance import MaintenanceConfig, build_delta_plans

    live = maintainer is not None
    if live:
        ex = maintainer.executor
        state, stats, cfg = ex.state, ex.store.stats, maintainer.cfg
        plans = maintainer.plans
    else:
        if state is None or stats is None:
            raise ValueError("static mode needs state= and stats=")
        cfg = cfg or MaintenanceConfig()
        plans = build_delta_plans(state)
    rate = float(update_rate if update_rate is not None
                 else cfg.expected_batch)

    out: list[Finding] = []
    out.extend(_check_delta_cap(cfg))

    n_tt = max(float(stats.n_triples), 1.0)
    for vid in sorted(state.views):
        cq = state.views[vid].cq
        loc = f"view {vid}"
        if vid in plans.oracle_vids:
            out.append(_f(
                "maint/oracle-fallback", "info",
                "maintained by the host oracle (not a full projection or "
                "cartesian delta plan): every batch re-evaluates the view "
                "and re-uploads its extent", loc))
            continue
        if live:
            rel = maintainer.executor.device_views.get(vid)
            if rel is None:
                continue
            cap = int(rel.data.shape[0])
            rows = float(len(maintainer.executor.extents[vid].rows))
            host_rows = rows
            dev_n = float(int(rel.n))
            if host_rows != dev_n:
                out.append(_f(
                    "maint/alignment", "error",
                    f"host extent mirror has {host_rows:.0f} rows but the "
                    f"device valid prefix is {dev_n:.0f}: the delete mask "
                    "would scrub the wrong rows", loc))
            units = maintainer.costs.measured.get(cq.canonical_key())
            growth = rate * (units if units is not None
                             else rows / n_tt)
        else:
            rows = cost_mod.cq_rel_info(cq, stats).rows
            cap = cost_mod.capacity_for(rows, cfg.growth_safety)
            growth = rate * rows / n_tt
        f = _headroom_finding(
            "maint/extent-headroom", "extent growth", cap, rows, growth,
            horizon,
            "each class promotion recompiles the consumer buckets; "
            "raise growth_safety or re-attach with more headroom", loc)
        if f is not None:
            out.append(f)

    # the padded triple-table class: inserts land here every batch, and
    # outgrowing it re-buckets every scan in the program
    if live:
        tt_cap = int(maintainer.tt_cap)
        tt_rows = float(len(maintainer.executor.store))
    else:
        tt_cap = cost_mod.capacity_for(n_tt, cfg.tt_safety)
        tt_rows = n_tt
    f = _headroom_finding(
        "maint/tt-headroom", "triple-table growth", tt_cap, tt_rows,
        rate, horizon,
        "a TT class promotion recompiles every bucket of the serving "
        "program; raise tt_safety", "tt")
    if f is not None:
        out.append(f)
    return out
