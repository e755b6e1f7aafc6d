"""Finding / report model shared by every analyzer family.

The counterpart of `repro/analysis/findings.py`, copied.

A `Finding` is one violated (or hazarded) invariant: which analyzer saw
it, a stable rule id, where it points (a DAG node, a bucket label, a
file:line), and what is wrong.  Analyzers return lists of findings;
`AnalysisReport` aggregates them for the CLI, `TuningSession.verify()`
and the CI gate.
"""
from __future__ import annotations

from dataclasses import dataclass, field

# severity ladder: "error" breaks the completeness guarantee (wrong
# answers / crash), "warning" is a serve-time hazard (recompile storm,
# unbounded growth), "info" is advisory.
SEVERITIES = ("error", "warning", "info")


@dataclass(frozen=True)
class Finding:
    analyzer: str        # "ir" | "capacity" | "body" | "maint" | "rules"
    rule: str            # stable rule id, e.g. "ir/key-collision"
    severity: str        # one of SEVERITIES
    message: str
    location: str = ""   # "node 7", "bucket w1:join:...", "file.py:42"

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    def format(self) -> str:
        loc = f" [{self.location}]" if self.location else ""
        return f"{self.severity:>7}  {self.rule}{loc}: {self.message}"


@dataclass
class AnalysisReport:
    """Aggregated findings of one analysis run."""

    findings: list[Finding] = field(default_factory=list)
    # how much was analyzed (for "zero findings" to mean something)
    checked: dict[str, int] = field(default_factory=dict)

    def extend(self, findings, analyzer: str | None = None,
               count_key: str | None = None, count: int = 0) -> None:
        self.findings.extend(findings)
        if count_key is not None:
            self.checked[count_key] = self.checked.get(count_key, 0) + count
        del analyzer  # kept for call-site readability

    def by_analyzer(self, analyzer: str) -> list[Finding]:
        return [f for f in self.findings if f.analyzer == analyzer]

    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    @property
    def ok(self) -> bool:
        """No errors (warnings allowed outside --strict)."""
        return not self.errors()

    def clean(self) -> bool:
        """No findings at all (the --strict bar)."""
        return not self.findings

    def summary(self) -> str:
        n_err, n_warn = len(self.errors()), len(self.warnings())
        n_info = len(self.findings) - n_err - n_warn
        scope = ", ".join(f"{k}={v}" for k, v in sorted(self.checked.items()))
        status = "clean" if self.clean() else \
            f"{n_err} error(s), {n_warn} warning(s), {n_info} info"
        return f"analysis: {status}" + (f" ({scope})" if scope else "")

    def format(self) -> str:
        lines = [f.format() for f in sorted(
            self.findings,
            key=lambda f: (SEVERITIES.index(f.severity), f.analyzer, f.rule))]
        lines.append(self.summary())
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "findings": [vars(f) for f in self.findings],
            "checked": dict(self.checked),
            "summary": self.summary(),
        }
