"""`python -m repro_torch.analysis` — the port's static verification gate.

The counterpart of `repro/analysis/cli.py`, with `--device`: the
reference session and its program are built on the card unless
`--device cpu` is given.

Runs the full analyzer stack with no device execution: tunes a
reference workload (search only — nothing materializes, nothing
runs), statically verifies the resulting plan IR / capacities /
bucket bodies, and lints the library source with the AST repo rules.

    PYTHONPATH=src python -m repro_torch.analysis --strict
    PYTHONPATH=src python -m repro_torch.analysis --strict --device cpu
    PYTHONPATH=src python -m repro_torch.analysis --workload lubm --json
    PYTHONPATH=src python -m repro_torch.analysis --rules-only

Exit status: 0 when the run passes the selected bar — `--strict`
demands ZERO findings (warnings included; the CI bar), the default
demands zero errors.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.driver import analyze_repo, verify_session
from repro_torch.analysis.findings import AnalysisReport

WORKLOADS = ("quickstart", "lubm", "none")


def build_session(workload: str, max_states: int,
                  universities: int | None = None, device=None):
    """Generate the reference universe and tune it (search only)."""
    from repro_torch.api.session import TuningSession
    from repro_torch.core.quality import QualityWeights
    from repro_torch.core.search import SearchConfig
    from repro_torch.core.wizard import WizardConfig
    from repro_torch.rdf.generator import generate, lubm_workload

    if universities is None:
        universities = 1 if workload == "quickstart" else 2
    uni = generate(n_universities=universities, seed=0)
    queries = lubm_workload(uni.dictionary)
    cfg = WizardConfig(
        search=SearchConfig(strategy="greedy", max_states=max_states,
                            weights=QualityWeights()))
    session = TuningSession(uni.store, queries, schema=uni.schema,
                            type_id=uni.type_id, cfg=cfg, device=device)
    session.retune()
    return session


def run(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static verification of the tuning pipeline")
    ap.add_argument("--workload", default="quickstart", choices=WORKLOADS,
                    help="reference workload to tune and verify "
                         "(none: skip the workload analyzers)")
    ap.add_argument("--strict", action="store_true",
                    help="fail on ANY finding, warnings included (CI bar)")
    ap.add_argument("--rules-only", action="store_true",
                    help="run only the AST repo rules")
    ap.add_argument("--no-rules", action="store_true",
                    help="skip the AST repo rules")
    ap.add_argument("--root", default=None,
                    help="library root for the repo rules "
                         "(default: the installed repro_torch package)")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON")
    ap.add_argument("--max-states", type=int, default=80,
                    help="search budget for the reference tuning run")
    ap.add_argument("--universities", type=int, default=None,
                    help="scale of the generated universe")
    ap.add_argument("--device", default=None,
                    help="device of the reference session and its program "
                         "(default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    report = AnalysisReport()
    if not args.rules_only and args.workload != "none":
        session = build_session(args.workload, args.max_states,
                                args.universities, args.device)
        wl = verify_session(session)
        report.findings.extend(wl.findings)
        report.checked.update(wl.checked)
        report.checked["workload_members"] = len(session.groups) or \
            len(session.workload)
    if not args.no_rules:
        rr = analyze_repo(args.root)
        report.findings.extend(rr.findings)
        report.checked.update(rr.checked)

    if args.json:
        print(json.dumps(report.to_json(), indent=2))
    else:
        print(report.format())
    passed = report.clean() if args.strict else report.ok
    return 0 if passed else 1


def main() -> None:
    sys.exit(run())
