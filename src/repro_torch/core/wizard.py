"""The storage tuning wizard: end-to-end pipeline of Figure 1.

The counterpart of `repro/core/wizard.py`.  Workload Processor (RDFS
reformulation) -> initial state -> States Navigator (search) -> View
Materializer -> Query Executor.

`tune()` is the one-shot entry point, kept as a compatibility shim: it
runs a throwaway `repro_torch.api.TuningSession` (retune + apply) and
repackages the result as a `WizardReport`.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field

from repro_torch.core.executor import QueryExecutor
from repro_torch.core.quality import QualityBreakdown
from repro_torch.core.search import SearchConfig, SearchResult
from repro_torch.core.state import State
from repro_torch.rdf.schema import RDFSchema
from repro_torch.rdf.triples import TripleStore


@dataclass
class WizardConfig:
    search: SearchConfig = field(default_factory=SearchConfig)
    use_schema: bool = True
    max_reformulations: int = 2048
    # join probes through the hand-written CUDA kernel (the plain version
    # on the CPU); stands in for the JAX package's opt-in `use_pallas`
    use_kernels: bool = True


@dataclass
class WizardReport:
    initial: State
    initial_quality: QualityBreakdown
    result: SearchResult
    executor: QueryExecutor
    groups: dict[str, list[str]]

    def summary(self) -> str:
        lines = [
            f"initial: total={self.initial_quality.total:.1f} "
            f"({len(self.initial.views)} views)",
            f"search:  {self.result.summary()}",
            "chosen views:",
        ]
        for vid, v in sorted(self.result.best.views.items()):
            lines.append(
                f"  v{vid}: {len(v.cq.atoms)} atoms / {len(v.cq.head)} cols "
                f"(~{self.result.best_quality.per_view_rows.get(vid, 0):.0f} rows est)"
            )
        return "\n".join(lines)


def tune(store: TripleStore, workload, schema: RDFSchema | None = None,
         type_id: int | None = None, cfg: WizardConfig | None = None,
         device=None) -> WizardReport:
    """One-shot wizard run (deprecated): prefer `repro_torch.api.TuningSession`.

    `type_id=None` with a schema infers the rdf:type predicate from the
    workload when unambiguous; a `ValueError` is raised otherwise.
    """
    from repro_torch.api.session import TuningSession  # lazy: import cycle

    warnings.warn(
        "repro_torch.core.wizard.tune() is a one-shot shim; use "
        "repro_torch.api.TuningSession for incremental re-tuning",
        DeprecationWarning, stacklevel=2)
    session = TuningSession(store, workload=list(workload), schema=schema,
                            type_id=type_id, cfg=cfg, device=device)
    rep = session.retune()
    session.apply()
    return WizardReport(initial=rep.seed, initial_quality=rep.seed_quality,
                        result=rep.result, executor=session.executor,
                        groups=session.groups)
