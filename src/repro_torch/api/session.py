"""TuningSession: the stateful lifecycle API of the storage wizard.

The counterpart of `repro/api/session.py` for the wizard's query path
and its serverless streaming half.  A session owns the triple store, the
RDFS schema and an evolving workload, and drives the pipeline
incrementally on one device:

    session = TuningSession(store, workload, schema=schema)
    session.retune()            # cold: search from the initial state
    session.apply()             # materialize + build the chosen views
    session.add_query(q_new)    # the workload drifts...
    session.retune()            # warm: search resumes from the last best
    session.apply()             # delta swap: only new views materialize
    session.ingest(ins, dels)   # maintain the views under a write batch

`retune()` warm-starts the States Navigator from the previous best
state (grafting added queries in their initial-state shape, dropping
removed ones).  `apply()` diffs old vs new view configurations by
canonical key so the materializer only evaluates genuinely new views,
dead extents are dropped, and the executor hot-swaps its workload
program in place.  `ingest()` maintains the applied views and the TT
indexes in place under a triple delta (`repro_torch.maintenance`); the
maintenance costs it measures replace the static estimate in the next
`retune()`.

The session runs on the card (`device=None`) unless it is given
`device="cpu"`.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import repro_torch
from repro_torch.core.executor import QueryExecutor
from repro_torch.core.quality import (MaintenanceCostModel, QualityBreakdown,
                                      quality)
from repro_torch.core.queries import CQ
from repro_torch.core.reformulation import infer_type_id, reformulate_workload
from repro_torch.core.search import SearchResult, search
from repro_torch.core.state import (State, drop_queries, graft_queries,
                                    initial_state)
from repro_torch.core.wizard import WizardConfig
from repro_torch.maintenance import (Delta, MaintenanceConfig,
                                     MaintenanceReport, ViewMaintainer)
from repro_torch.rdf.schema import RDFSchema
from repro_torch.rdf.triples import TripleStore


@dataclass
class RetuneReport:
    """One navigator run inside a session."""

    result: SearchResult
    seed: State                 # state the navigator started from
    seed_quality: QualityBreakdown
    warm: bool                  # resumed from the previous best?
    added: list[str] = field(default_factory=list)    # member names grafted
    removed: list[str] = field(default_factory=list)  # member names dropped

    def summary(self) -> str:
        mode = "warm" if self.warm else "cold"
        return (f"{mode} retune (+{len(self.added)}/-{len(self.removed)} "
                f"members): seed total={self.seed_quality.total:.1f}; "
                f"{self.result.summary()}")


@dataclass
class SessionSnapshot:
    """Every binding a retune/apply cycle mutates, captured so an
    online edit can be rolled back atomically (`TuningSession.restore`).
    The executor is snapshotted alongside because `apply()` hot-swaps
    it in place."""

    workload: dict[str, CQ]
    groups: dict[str, list[str]]
    best: State | None
    best_quality: QualityBreakdown | None
    applied: State | None
    type_id: int | None
    store: TripleStore
    executor: QueryExecutor | None
    executor_snap: object | None    # core.executor.ExecutorSnapshot


@dataclass
class ApplyReport:
    """One view swap: which extents were touched."""

    materialized: list[int]     # view ids actually evaluated
    reused: list[int]           # view ids carried over by canonical key
    dropped: list[int]          # previous view ids discarded
    full: bool                  # first apply (everything materialized)

    def summary(self) -> str:
        kind = "full" if self.full else "delta"
        return (f"{kind} apply: materialized={len(self.materialized)} "
                f"reused={len(self.reused)} dropped={len(self.dropped)}")


class TuningSession:
    """Stateful wizard: evolve the workload, retune incrementally, swap
    view configurations online."""

    def __init__(self, store: TripleStore, workload=(),
                 schema: RDFSchema | None = None, type_id: int | None = None,
                 cfg: WizardConfig | None = None, device=None):
        self.device = repro_torch.device(device)
        self.store = store
        self.schema = schema
        self.cfg = cfg or WizardConfig()
        self._type_id = type_id
        self._workload: dict[str, CQ] = {}
        for q in workload:
            self.add_query(q)
        self._groups: dict[str, list[str]] = {}
        self._best: State | None = None
        self._best_quality: QualityBreakdown | None = None
        self._applied: State | None = None
        self.executor: QueryExecutor | None = None
        # measured per-view maintenance costs (EWMA units/triple, keyed
        # by canonical view key).  The session's `ViewMaintainer` shares
        # this object and fills it in; once populated, retune() optimizes
        # against the MEASURED costs instead of the static estimate.
        self.maintenance_costs = MaintenanceCostModel()
        self._maintainer: ViewMaintainer | None = None

    # ------------------------------------------------------------------
    # workload evolution
    # ------------------------------------------------------------------
    def add_query(self, q: CQ) -> None:
        if not q.name:
            raise ValueError("workload queries must be named")
        if q.name in self._workload:
            raise ValueError(f"duplicate query name {q.name!r}")
        self._workload[q.name] = q

    def remove_query(self, name: str) -> CQ:
        if name not in self._workload:
            raise KeyError(f"unknown query {name!r}")
        return self._workload.pop(name)

    @property
    def workload(self) -> list[CQ]:
        return list(self._workload.values())

    @property
    def groups(self) -> dict[str, list[str]]:
        return self._groups

    @property
    def best(self) -> State | None:
        return self._best

    @property
    def best_quality(self) -> QualityBreakdown | None:
        return self._best_quality

    # ------------------------------------------------------------------
    # retune: warm-started States Navigator
    # ------------------------------------------------------------------
    def _resolve_type_id(self) -> int | None:
        if not (self.cfg.use_schema and self.schema is not None):
            return None
        if self._type_id is None:
            self._type_id = infer_type_id(self.workload, self.schema)
        if self._type_id is None:
            raise ValueError(
                "type_id is required for schema reformulation and could "
                "not be inferred unambiguously from the workload; pass "
                "type_id= explicitly")
        return self._type_id

    def _members(self) -> tuple[list[CQ], dict[str, list[str]]]:
        if self.cfg.use_schema and self.schema is not None:
            return reformulate_workload(self.workload, self.schema,
                                        self._resolve_type_id(),
                                        self.cfg.max_reformulations)
        return self.workload, {q.name: [q.name] for q in self.workload}

    def _search_cfg(self):
        """The session's search config with measured maintenance costs
        (if a maintainer has observed any) overriding the static
        estimate in the quality objective."""
        if len(self.maintenance_costs):
            return replace(self.cfg.search,
                           maint_model=self.maintenance_costs)
        return self.cfg.search

    def retune(self) -> RetuneReport:
        """Re-run the States Navigator against the current workload.

        First call searches cold from the paper's initial state; later
        calls warm-start from the previous best: kept queries retain
        their already-relaxed views and rewritings, added queries are
        grafted in initial-state shape, removed queries are dropped (and
        their now-dead views garbage-collected).
        """
        if not self._workload:
            raise ValueError("cannot retune an empty workload")
        members, groups = self._members()
        added: list[str] = []
        removed: list[str] = []
        if self._best is None:
            seed = initial_state(members)
            warm = False
        else:
            warm = True
            seed = self._best
            prev_names = {q.name for q in seed.queries}
            new_names = {m.name for m in members}
            removed = sorted(prev_names - new_names)
            if removed:
                seed = drop_queries(seed, set(removed))
            grafts = [m for m in members if m.name not in prev_names]
            added = [m.name for m in grafts]
            if grafts:
                seed = graft_queries(seed, grafts)
        cfg = self._search_cfg()
        seed_q = quality(seed, self.store.stats, cfg.weights,
                         cfg.maint_model)
        result = search(seed, self.store.stats, cfg)
        self._best, self._best_quality = result.best, result.best_quality
        self._groups = groups
        return RetuneReport(result=result, seed=seed, seed_quality=seed_q,
                            warm=warm, added=added, removed=removed)

    # ------------------------------------------------------------------
    # apply: delta view swap
    # ------------------------------------------------------------------
    def apply(self, warm: bool = True) -> ApplyReport:
        """Install the last retune's best configuration.

        The first apply materializes everything and builds the fused
        executor; every later apply is a delta swap — only views whose
        canonical key changed are materialized, surviving extents are
        reused (column-permuted), dead extents dropped, and the workload
        program is hot-swapped on the SAME executor object.

        With `warm=True` (default) the incoming program runs once before
        apply returns: capacities the old program learned adaptively are
        carried over and the workload results are cached.
        """
        if self._best is None:
            raise RuntimeError("retune() before apply()")
        if self.executor is None:
            self.executor = QueryExecutor(self.store, self._best,
                                          self._groups,
                                          use_kernels=self.cfg.use_kernels,
                                          device=self.device)
            if warm:
                self.executor.warmup()
            report = ApplyReport(materialized=sorted(self._best.views),
                                 reused=[], dropped=[], full=True)
        else:
            swap = self.executor.swap_state(self._best, self._groups,
                                            warm=warm)
            report = ApplyReport(full=False, **swap)
            if self._maintainer is not None:
                # same executor object, new view set: rebuild delta plans
                # and re-establish the capacity-class invariants
                self._maintainer.rebind(self.executor)
        self._applied = self._best
        return report

    @property
    def pending(self) -> bool:
        """True when the last retune has not been applied yet."""
        return self._best is not None and self._best is not self._applied

    # ------------------------------------------------------------------
    # transactional edits
    # ------------------------------------------------------------------
    def snapshot(self) -> SessionSnapshot:
        """Capture the session (and its live executor) before an online
        edit, so a failed add/remove + retune + apply can be rolled back
        as one transaction (`restore`)."""
        return SessionSnapshot(
            workload=dict(self._workload),
            groups={k: list(v) for k, v in self._groups.items()},
            best=self._best, best_quality=self._best_quality,
            applied=self._applied, type_id=self._type_id, store=self.store,
            executor=self.executor,
            executor_snap=(self.executor.snapshot()
                           if self.executor is not None else None))

    def restore(self, snap: SessionSnapshot) -> None:
        """Roll the session back to a snapshot.  The executor OBJECT is
        restored in place, so after a crashed retune/apply the previous
        program keeps answering."""
        self._workload = dict(snap.workload)
        self._groups = {k: list(v) for k, v in snap.groups.items()}
        self._best, self._best_quality = snap.best, snap.best_quality
        self._applied = snap.applied
        self._type_id = snap.type_id
        self.store = snap.store
        if snap.executor is None:
            self.executor = None
        else:
            self.executor = snap.executor
            self.executor.restore(snap.executor_snap)

    # ------------------------------------------------------------------
    # answering
    # ------------------------------------------------------------------
    def _ensure_applied(self) -> QueryExecutor:
        if self._best is None:
            self.retune()
        if self.executor is None or self.pending:
            self.apply()
        return self.executor

    def answer(self, name: str) -> set[tuple[int, ...]]:
        """Union-group semantics over the original workload query."""
        return self._ensure_applied().answer_group(name)

    # ------------------------------------------------------------------
    # streaming ingestion (serverless path)
    # ------------------------------------------------------------------
    def maintainer(self, cfg: MaintenanceConfig | None = None
                   ) -> ViewMaintainer:
        """The session's incremental `ViewMaintainer`, created lazily
        against the applied executor.  Shares `maintenance_costs` so
        measured costs flow into later retunes."""
        ex = self._ensure_applied()
        if self._maintainer is None or self._maintainer.executor is not ex:
            self._maintainer = ViewMaintainer(
                ex, cfg or MaintenanceConfig(),
                costs=self.maintenance_costs)
        return self._maintainer

    def ingest(self, inserts=None, deletes=None) -> MaintenanceReport:
        """Apply one triple delta batch incrementally: view extents and
        TT indexes are maintained in place on the device (no refresh, no
        rebuilt program in steady state) and the session's store
        advances to the post-delta table.  Returns the
        `MaintenanceReport`."""
        report = self.maintainer().apply(Delta.of(inserts, deletes))
        self.store = self.executor.store
        return report
