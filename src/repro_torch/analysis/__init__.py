"""Static verification of the tuning pipeline (no execution).

The counterpart of `repro/analysis/`, with the same exports; the JAX
package's `jaxpr_lint` becomes `body_lint`, a lint of the bucket bodies
run on torch's `meta` device (rule family `body`).

Four analyzer families over a tuned workload and the library source:

  * `ir_verifier`  — structural soundness of the shared-subplan DAG,
    including canonical-key collision/instability detection
  * `capacity`     — predicted buffer overflows and recompile hazards
    from the cost model, before anything runs
  * `body_lint`    — every bucket body run on `meta` tensors and its
    ops checked against the engine contract (int32/bool, static shapes,
    no host reads) plus compile-cache key soundness
  * `maintenance_check` — streaming-update envelope: delta capacity
    classes, extent/TT growth headroom under the configured update
    rate, oracle-fallback maintenance, host/device alignment
  * `repo_rules`   — AST lint of the library source (bare asserts,
    mutable defaults, unhashable jit static args)

Entry points: `analyze_workload` / `analyze_state` / `verify_session` /
`analyze_repo` (driver.py), `WorkloadExecutor.analyze()`,
`TuningSession.verify()`, and the `python -m repro_torch.analysis` CLI.
"""
from repro_torch.analysis.capacity import analyze_capacity
from repro_torch.analysis.driver import (analyze_repo, analyze_state,
                                   analyze_workload, verify_session)
from repro_torch.analysis.findings import SEVERITIES, AnalysisReport, Finding
from repro_torch.analysis.ir_verifier import verify_dag
from repro_torch.analysis.body_lint import (check_cache_keys, lint_program,
                                            lint_traced)
from repro_torch.analysis.maintenance_check import analyze_maintenance
from repro_torch.analysis.repo_rules import check_source, run_repo_rules

__all__ = [
    "SEVERITIES", "AnalysisReport", "Finding",
    "analyze_capacity", "analyze_maintenance", "analyze_repo",
    "analyze_state", "analyze_workload", "check_cache_keys",
    "check_source", "lint_program", "lint_traced", "run_repo_rules",
    "verify_dag", "verify_session",
]
