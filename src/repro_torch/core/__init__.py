"""RDFViewS core: the paper's contribution.

Modules:
  queries        — conjunctive-query model (CQ/Atom/Var/Const)
  state          — search states S = (V, R) + initial_state
  transitions    — selection cut / join cut / view fusion
  quality        — the quality function epsilon(S)
  search         — exhaustive + heuristic strategies
  reformulation  — RDFS-aware query reformulation (CQ -> UCQ)
  executor       — the Query Executor over materialized views
  wizard         — end-to-end tune() pipeline

Public names are re-exported lazily to avoid import cycles with
repro.query (which uses the CQ model).
"""
_EXPORTS = {
    "CQ": "repro_torch.core.queries", "Atom": "repro_torch.core.queries",
    "Const": "repro_torch.core.queries", "Var": "repro_torch.core.queries",
    "full_projection": "repro_torch.core.queries",
    "State": "repro_torch.core.state", "View": "repro_torch.core.state",
    "initial_state": "repro_torch.core.state",
    "QualityWeights": "repro_torch.core.quality", "quality": "repro_torch.core.quality",
    "SearchConfig": "repro_torch.core.search", "SearchResult": "repro_torch.core.search",
    "search": "repro_torch.core.search",
    "WizardConfig": "repro_torch.core.wizard", "WizardReport": "repro_torch.core.wizard",
    "tune": "repro_torch.core.wizard",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module(_EXPORTS[name])
        return getattr(mod, name)
    raise AttributeError(f"module 'repro_torch.core' has no attribute {name!r}")
