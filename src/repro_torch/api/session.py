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
    session.verify(strict=True) # static check of the live configuration
    server = session.serve()    # batched serving + online retuning
    session.save("ckpt/")       # persist; TuningSession.load resumes

`retune()` warm-starts the States Navigator from the previous best
state (grafting added queries in their initial-state shape, dropping
removed ones).  `apply()` diffs old vs new view configurations by
canonical key so the materializer only evaluates genuinely new views,
dead extents are dropped, and the executor hot-swaps its workload
program in place.  `ingest()` maintains the applied views and the TT
indexes in place under a triple delta (`repro_torch.maintenance`); the
maintenance costs it measures replace the static estimate in the next
`retune()`.  `serve()` / `serve_async()` put the degradation-ladder
`QueryServer` (`repro_torch.serve`) and its async frontend in front of
the executor; `save()` / `load()` persist the session in the JAX
package's layout, so a session saved by either package loads in the
other.

The session runs on the card (`device=None`) unless it is given
`device="cpu"`; `load(..., device=)` likewise.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, replace

import numpy as np

import repro_torch
from repro_torch.api import serde
from repro_torch.checkpoint import checkpoint as ckpt
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
from repro_torch.rdf.dictionary import Dictionary
from repro_torch.rdf.schema import RDFSchema
from repro_torch.rdf.triples import TripleStore

_SESSION_FILE = "session.json"
_PAYLOAD_VERSION = 1


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
    view configurations online, serve, persist and resume."""

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
        # chaos injector (duck-typed: .fire(site)); set by a QueryServer
        # constructed with chaos= so retune/apply become fault boundaries
        self.fault_hook = None

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
        if self.fault_hook is not None:
            self.fault_hook.fire("retune")
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
        if self.fault_hook is not None:
            self.fault_hook.fire("apply")
        if self.executor is None:
            self.executor = QueryExecutor(self.store, self._best,
                                          self._groups,
                                          use_kernels=self.cfg.use_kernels,
                                          device=self.device,
                                          fault_hook=self.fault_hook)
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
    # answering / serving
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

    def serve(self, maintenance=None, chaos=None, policy=None):
        """Batched query server bound to this session's executor; the
        server survives `retune()+apply()` (hot swap) and can trigger
        them itself via `QueryServer.retune_online`.

        Pass `maintenance=` (True, a `repro_torch.maintenance.
        MaintenanceConfig` or a pre-built `ViewMaintainer`) to serve a
        STREAMING store: the server then accepts update batches
        (`submit`) and keeps answers within the configured staleness
        budget, with measured per-view maintenance costs feeding this
        session's retune objective.

        `chaos=` attaches a `repro_torch.serve.chaos.FaultInjector` to
        every serving fault boundary; `policy=` overrides the degradation
        ladder's `repro_torch.distributed.fault.RetryPolicy`."""
        from repro_torch.serve.query_server import QueryServer

        if maintenance is True:
            maintenance = MaintenanceConfig()
        return QueryServer(self._ensure_applied(), session=self,
                           maintenance=maintenance, chaos=chaos,
                           policy=policy)

    def serve_async(self, classes=None, frontend=None, maintenance=None,
                    chaos=None, policy=None, sharded=False, mesh=None,
                    clock=None, service_model=None):
        """Async serving frontend over this session's tuned workload:
        bounded request queue, micro-batching window, per-class latency
        SLOs with admission control — the `repro_torch.serve.frontend`
        subsystem, wired to a server bound to this session.

        `classes`: iterable of `repro_torch.serve.frontend.QueryClass`
        (default one best-effort class).  `frontend`: a `FrontendConfig`
        with the queue/window/admission knobs.  `clock`/`service_model`
        inject the virtual clock and batch service model (tests pin both
        for determinism).

        `sharded=True` serves through a `repro_torch.serve.sharded.
        ShardedBackend` over `mesh` (a `repro_torch.launch.mesh.Mesh`;
        default: one shard a visible device, on the executor's device)
        instead of the single-device `QueryServer`: per-shard health,
        quorum rollup, host fallback for degraded shards.  The sharded
        backend is static-store, so it cannot be combined with
        `maintenance=`.
        """
        from repro_torch.serve.frontend import (FrontendConfig, QueryClass,
                                                ServingFrontend)

        if classes is None:
            classes = [QueryClass("default")]
        if sharded:
            if maintenance is not None:
                raise ValueError(
                    "sharded serving is static-store: maintenance= is "
                    "only supported with sharded=False")
            from repro_torch.serve.sharded import ShardedBackend

            server = ShardedBackend(self._ensure_applied(), mesh=mesh,
                                    policy=policy)
        else:
            server = self.serve(maintenance=maintenance, chaos=chaos,
                                policy=policy)
        return ServingFrontend(server, classes,
                               cfg=frontend or FrontendConfig(),
                               clock=clock, service_model=service_model)

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

    # ------------------------------------------------------------------
    # static verification
    # ------------------------------------------------------------------
    def verify(self, strict: bool = False):
        """Statically verify the session's current configuration — plan-IR
        soundness, capacity/recompile hazards, bucket-body lint — without
        executing anything (`repro_torch.analysis`).  With an applied
        executor the live program (real extent statistics, learned
        capacities) is verified, and a bound maintainer's host mirrors
        are held against the device's valid prefixes; after a bare
        `retune()` the tuned best state is analyzed from cost estimates.
        Returns the `AnalysisReport`; `strict=True` raises
        `InvariantViolation` unless it is clean.
        """
        from repro_torch import analysis
        from repro_torch.errors import InvariantViolation

        report = analysis.verify_session(self)
        if strict and not report.clean():
            raise InvariantViolation(
                "session verification failed:\n" + report.format())
        return report

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def save(self, ckpt_dir: str, step: int | None = None) -> str:
        """Persist the session: triple table through the atomic array
        checkpointer, symbolic state (workload, schema, best state,
        groups, config) as a session.json sidecar — the JAX package's
        layout and payload.  The checkpointer keeps the newest three
        steps.  Returns the step directory."""
        if step is None:
            latest = ckpt.latest_step(ckpt_dir)
            step = 0 if latest is None else latest + 1
        path = ckpt.save(ckpt_dir, step, {"triples": self.store.triples})
        d = self.store.dictionary
        payload = {
            "version": _PAYLOAD_VERSION,
            "type_id": self._type_id,
            "cfg": serde.cfg_to_json(self.cfg),
            "dictionary": list(d._to_str) if d is not None else None,
            "schema": (serde.schema_to_json(self.schema)
                       if self.schema is not None else None),
            "workload": [serde.cq_to_json(q) for q in self.workload],
            "best": (serde.state_to_json(self._best)
                     if self._best is not None else None),
            "groups": self._groups,
        }
        with open(os.path.join(path, _SESSION_FILE), "w") as f:
            json.dump(payload, f)
        return path

    @classmethod
    def load(cls, ckpt_dir: str, step: int | None = None,
             cfg: WizardConfig | None = None, device=None
             ) -> "TuningSession":
        """Resume a session saved by either package, on `device` (the
        card unless "cpu"): the next retune() warm-starts from the
        restored best state.  The executor is rebuilt lazily on the first
        apply() (device buffers are not checkpointed).  The saved config
        — search strategy, budgets, quality weights, the kernel switch
        (`use_pallas` in the JSON) — is restored with the session so the
        tuning objective survives the round trip; pass cfg= only to
        deliberately override it."""
        dev = repro_torch.device(device)
        if step is None:
            step = ckpt.latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(f"no checkpoint under {ckpt_dir!r}")
        with open(os.path.join(ckpt_dir, f"step_{step:08d}",
                               _SESSION_FILE)) as f:
            payload = json.load(f)
        if payload["version"] != _PAYLOAD_VERSION:
            raise ValueError(
                f"unsupported session payload version {payload['version']}")
        arrays = ckpt.restore(ckpt_dir, step,
                              {"triples": np.zeros((0, 3), np.int32)})
        dictionary = None
        if payload["dictionary"] is not None:
            dictionary = Dictionary()
            dictionary.encode_many(payload["dictionary"])
        store = TripleStore(arrays["triples"], dictionary)
        schema = (serde.schema_from_json(payload["schema"])
                  if payload["schema"] is not None else None)
        if cfg is None:
            cfg = serde.cfg_from_json(payload["cfg"])
        session = cls(store,
                      workload=[serde.cq_from_json(q)
                                for q in payload["workload"]],
                      schema=schema, type_id=payload["type_id"], cfg=cfg,
                      device=dev)
        if payload["best"] is not None:
            session._best = serde.state_from_json(payload["best"])
            session._best_quality = quality(session._best, store.stats,
                                            session.cfg.search.weights)
            session._groups = {k: list(v)
                               for k, v in payload["groups"].items()}
        return session
