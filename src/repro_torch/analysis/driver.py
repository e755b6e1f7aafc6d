"""Analysis driver: compose the analyzer families into one report.

The counterpart of `repro/analysis/driver.py`.  `analyze_state` builds
its program on a device (the card unless `device="cpu"`): the program
uploads its per-member constants when it is built.  Nothing runs there.

Three entry granularities, all execution-free:

  * `analyze_workload` — lowest level: a DAG (+ optionally its
    `BucketedProgram`) with statistics and view infos in hand.  This is
    what `WorkloadExecutor.analyze()` calls.
  * `analyze_state` — a search `State` (tuned but not applied): builds
    the device DAG from the rewritings, estimates extent infos from the
    view CQs (`cost.cq_rel_info`), constructs the shape-bucketed
    program WITHOUT running it, and analyzes.  This is how the CLI
    and CI verify a workload nothing has executed yet.
  * `verify_session` — a `TuningSession`: prefers the live executor
    (real extent statistics, real learned capacities, real view buffer
    shapes) when one is applied; falls back to `analyze_state` on the
    tuned-but-unapplied best state.

`analyze_repo` runs the AST repo rules over the installed `repro_torch`
package tree (or any root).
"""
from __future__ import annotations

import os

from repro_torch.analysis import capacity as capacity_mod
from repro_torch.analysis import (body_lint, ir_verifier, maintenance_check,
                                  repo_rules)
from repro_torch.analysis.findings import AnalysisReport
from repro_torch.query import cost as cost_mod
from repro_torch.query.dag import WorkloadDAG, build_dag
from repro_torch.query.plan import has_cartesian


def analyze_workload(dag: WorkloadDAG, stats, view_infos, *,
                     program=None, n_tt: int | None = None,
                     view_caps: dict[int, int] | None = None,
                     expected_members: set[str] | None = None
                     ) -> AnalysisReport:
    """Run the IR verifier, the capacity analyzer and — when a bucketed
    `program` is supplied — the body lint over one workload."""
    report = AnalysisReport()
    report.extend(ir_verifier.verify_dag(dag, expected_members),
                  count_key="nodes", count=len(dag.nodes))
    report.extend(capacity_mod.analyze_capacity(dag, stats, view_infos,
                                                program=program),
                  count_key="sized_nodes",
                  count=sum(1 for n in dag.nodes
                            if n.kind in ("scan", "join")))
    if program is not None:
        if n_tt is None:
            n_tt = max(int(stats.n_triples), 1)
        report.extend(body_lint.lint_program(program, n_tt, view_caps),
                      count_key="buckets", count=len(program.buckets))
    return report


def analyze_state(state, stats, *, use_kernels: bool = True,
                  with_program: bool = True, n_tt: int | None = None,
                  device=None) -> AnalysisReport:
    """Statically analyze a tuned `State` before anything materializes.

    The device DAG is built exactly as `QueryExecutor` would build it
    (cartesian rewritings stay on the oracle and are excluded); extent
    infos are ESTIMATED from the view CQs, so the capacity findings are
    predictions, not measurements.  Constructing the `BucketedProgram`
    plans shapes and uploads its constants to `device` — nothing runs.
    """
    from repro_torch.query.buckets import BucketedProgram

    device_plans = {}
    oracle = 0
    for name, plan in state.rewritings.items():
        if has_cartesian(plan):
            oracle += 1
        else:
            device_plans[name] = plan
    dag = build_dag(device_plans)
    view_infos = {vid: cost_mod.cq_rel_info(v.cq, stats)
                  for vid, v in state.views.items()}
    program = None
    if with_program and dag.nodes:
        program = BucketedProgram(dag, stats, view_infos,
                                  device=device, use_kernels=use_kernels)
    report = analyze_workload(dag, stats, view_infos, program=program,
                              n_tt=n_tt,
                              expected_members=set(device_plans))
    report.extend(maintenance_check.analyze_maintenance(state, stats),
                  count_key="maint_views", count=len(state.views))
    if oracle:
        report.checked["oracle_fallbacks"] = oracle
    return report


def verify_session(session, *, n_tt: int | None = None) -> AnalysisReport:
    """Verify a `TuningSession`'s current configuration.

    With an applied executor: analyzes the live DAG against the real
    materialized extent statistics and the real compiled-shape program
    (including adaptively learned capacities), passing the actual view
    buffer shapes to the body lint.  Tuned but not applied: falls back
    to the estimate-based `analyze_state`.
    """
    ex = session.executor
    if ex is not None and not session.pending:
        expected = set(ex.state.rewritings) - ex._oracle_names
        stats = ex.store.stats
        program = None
        view_caps = None
        if ex.workload.mode == "bucketed":
            program = ex.workload._program()
            view_caps = {vid: int(rel.data.shape[0])
                         for vid, rel in ex.device_views.items()}
        report = analyze_workload(
            ex.dag, stats, ex.infos, program=program,
            n_tt=n_tt if n_tt is not None else int(ex.tt["spo"].shape[0]),
            view_caps=view_caps, expected_members=expected)
        maintainer = getattr(session, "_maintainer", None)
        if maintainer is not None and maintainer.executor is ex:
            # live maintenance envelope: real buffer classes, host
            # mirrors and measured per-triple costs
            maint = maintenance_check.analyze_maintenance(
                maintainer=maintainer)
        else:
            maint = maintenance_check.analyze_maintenance(ex.state, stats)
        report.extend(maint, count_key="maint_views",
                      count=len(ex.state.views))
        if ex._oracle_names:
            report.checked["oracle_fallbacks"] = len(ex._oracle_names)
        return report
    if session.best is None:
        raise RuntimeError("nothing to verify: retune() first")
    return analyze_state(session.best, session.store.stats,
                         use_kernels=session.cfg.use_kernels, n_tt=n_tt,
                         device=session.device)


def analyze_repo(root: str | None = None) -> AnalysisReport:
    """Run the AST repo rules; `root` defaults to the installed
    `repro_torch` package directory."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    report = AnalysisReport()
    findings, n_files = repo_rules.run_repo_rules(root)
    report.extend(findings, count_key="files", count=n_files)
    return report
