"""Capacity & recompile-hazard analysis.

The counterpart of `repro/analysis/capacity.py`, copied.

The engine's buffers are statically sized from cardinality estimates
(`cost.capacity_for`); an undersized buffer overflows at serve time and
the adaptive driver pays an overflow→promote→recompile cycle for it —
correct, but a latency cliff on the hot path.  This analyzer predicts
those cliffs from the same estimates BEFORE anything executes:

  cap/undersized       planned capacity below the estimated row demand —
                       the first run is already predicted to overflow
                       and recompile (per bucket: the whole bucket pays)
  cap/ceiling          demand exceeds the engine's capacity ceiling; the
                       promote chain cannot absorb it and the driver
                       will raise at serve time
  cap/headroom         capacity covers the estimate but with less than
                       2x slack — one modest mis-estimate triggers the
                       recompile cycle (warning)
  cap/chain-unbounded  the promote chain from a planned class fails to
                       reach the ceiling monotonically in bounded steps
                       (the driver would recompile forever)
  cap/invalid          a sized node carries a non-positive or
                       non-power-of-two capacity class
"""
from __future__ import annotations

from repro_torch.analysis.findings import Finding
from repro_torch.errors import InvariantViolation
from repro_torch.query import cost as cost_mod
from repro_torch.query.buckets import (CAP_CEIL, BucketedProgram,
                                       plan_capacities)
from repro_torch.query.dag import WorkloadDAG

HEADROOM_WARN = 2.0  # flag sized buffers with < 2x slack over the estimate


def _f(rule: str, severity: str, message: str, location: str = "") -> Finding:
    return Finding("capacity", rule, severity, message, location)


def analyze_capacity(dag: WorkloadDAG, stats, view_infos, *,
                     caps: list[int] | None = None,
                     demands: list[float] | None = None,
                     safety: float = 4.0, ceil: int = CAP_CEIL,
                     program: BucketedProgram | None = None) -> list[Finding]:
    """Predict overflow/recompile hazards for a workload DAG.

    With `program` given, its planned capacities and demands are checked
    (including carried/promoted ones); otherwise capacities are planned
    fresh from the estimates like `BucketedProgram` would.
    """
    if program is not None:
        caps, demands = program.caps, program.demands
    if caps is None or demands is None:
        ests = cost_mod.estimate_dag(dag, stats, view_infos)
        planned, _s, _j, planned_demands = plan_capacities(
            dag, stats, view_infos, safety=safety, ests=ests)
        caps = caps if caps is not None else planned
        demands = demands if demands is not None else planned_demands

    out: list[Finding] = []
    checked_chains: set[int] = set()
    for node in dag.nodes:
        cap = caps[node.id]
        if node.kind not in ("scan", "join"):
            continue
        loc = f"node {node.id} ({node.kind})"
        if program is not None and node.id in program.node_bucket:
            loc += f", bucket {program.node_bucket[node.id].label}"
        demand = float(demands[node.id])
        if cap <= 0 or (cap & (cap - 1)) != 0:
            out.append(_f("cap/invalid", "error",
                          f"capacity {cap} is not a positive power of two "
                          "— bucketing by capacity class is broken", loc))
            continue
        if cap > ceil:
            out.append(_f("cap/invalid", "error",
                          f"capacity {cap} exceeds the ceiling {ceil}", loc))
            continue
        if demand > ceil:
            out.append(_f(
                "cap/ceiling", "error",
                f"estimated demand {demand:.0f} rows exceeds the capacity "
                f"ceiling {ceil}; the promote chain cannot absorb it and "
                "the adaptive driver will raise at serve time", loc))
            continue
        if demand > cap:
            promotions = 0
            c = cap
            while c < demand and c < ceil:
                c = cost_mod.promote_capacity(c, ceil)
                promotions += 1
            out.append(_f(
                "cap/undersized", "warning",
                f"planned capacity {cap} < estimated demand {demand:.0f} "
                f"rows: predicted to overflow and pay {promotions} "
                "promote+recompile cycle(s) at serve time — size it now",
                loc))
        elif demand > 0 and cap < ceil and cap / max(demand, 1.0) \
                < HEADROOM_WARN:
            out.append(_f(
                "cap/headroom", "warning",
                f"capacity {cap} holds only {cap / max(demand, 1.0):.2f}x "
                f"the estimated {demand:.0f} rows; a modest mis-estimate "
                "triggers the recompile cycle", loc))
        # promote chain must be bounded from every planned class
        if cap not in checked_chains:
            checked_chains.add(cap)
            try:
                chain = cost_mod.promotion_chain(cap, ceil)
            except InvariantViolation as e:
                out.append(_f("cap/chain-unbounded", "error", str(e), loc))
            else:
                if chain and chain[-1] != ceil:
                    out.append(_f(
                        "cap/chain-unbounded", "error",
                        f"promotion chain from {cap} stops at {chain[-1]} "
                        f"short of the ceiling {ceil}", loc))
    return out
