"""Workload query serving: batched requests through the fused executor.

The counterpart of `repro/serve/query_server.py`, with the same ladder,
stats and fault sites.  The paper's demo answers one query at a time; at
serving scale requests arrive in batches drawn from the tuned workload.
`QueryServer` front-ends a `QueryExecutor`: the whole workload is
answered by ONE device program run (shared subplans computed once; its
join probes launch the `join_count` kernel), so a batch of requests —
whatever its mix of queries — costs at most one program run, and repeat
batches are served from the cached workload results until the store or
state changes (`invalidate`).

Union semantics over RDFS reformulation groups are applied per request,
matching `QueryExecutor.answer_group`.

Serving is FAULT TOLERANT through a degradation ladder (docs/serving.md):

  tier 0  fused device program (fast path; circuit-broken on failure)
  tier 1  per-query path (each member's operator tree alone, no shared
          subplans; its join probes launch the kernel too)
  tier 2  host reference engine over the raw triple table (exact,
          independent of view extents and device state)
  tier 3  last-known-good cached answers, explicitly flagged stale

Tiers 0-2 are exact; an answer is never silently wrong — before the
fused path serves, an integrity probe checks host-mirror/device-buffer
row alignment of every extent (all device counts in one transfer) and
repairs via re-materialization.  The `ServingSupervisor`
(repro_torch.distributed.fault) owns a deterministic, batch-clocked
circuit breaker over tier 0 and the health state machine
HEALTHY / DEGRADED / STALE_ONLY / DOWN surfaced in `ServeStats` and the
`readiness()` probe.  When no tier can serve, `answer_batch` raises
`ServiceUnavailable` instead of returning wrong data.

A fault of the card is not one the ladder absorbs: a kernel that
cannot be built, loaded or launched, or a fault that CUDA reports at a
later read-back (`repro_torch.kernels._build.is_device_fault`).  No
lower tier may hide it by answering from the host while the views stay
on the card.  The batch that meets one, in the integrity probe, any
tier, a maintenance pass or a drift retune, takes the server DOWN and
re-raises it.

A server bound to a `repro_torch.api.TuningSession` can retune ONLINE:
the session's `apply()` hot-swaps the workload program on the same
executor object this server holds, so `retune_online()` evolves the
workload behind the batched endpoint without a server restart.  Both
`retune_online()` and drift-triggered retunes are TRANSACTIONAL: the
session and executor bindings are snapshotted first and restored on any
failure, so a crashed retune leaves the previous program serving.

With `maintenance=` configured the server also ingests streaming triple
deltas (`submit`) under a staleness budget: pending updates are applied
by the incremental `ViewMaintainer` (repro_torch.maintenance; its
appends launch the `scatter_append` kernel) between batches
whenever the backlog exceeds `staleness_budget` pending triples, so an
answered batch is never more than the budget stale.  A failed
maintenance pass requeues its delta at the head of the stream and the
batch is flagged stale if the backlog exceeds the budget.  The
maintainer's drift detector can trigger an automatic retune
(`auto_retune`), with measured per-view maintenance costs feeding the
retune's objective.

`chaos=` attaches a `repro_torch.serve.chaos.FaultInjector` to every
fault boundary for deterministic fault-injection testing.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import NoReturn

import torch

from repro_torch.core.executor import QueryExecutor
from repro_torch.distributed.fault import RetryPolicy, ServingSupervisor
from repro_torch.errors import ServiceUnavailable
from repro_torch.kernels._build import is_device_fault


@dataclass
class ServeStats:
    requests: int = 0
    batches: int = 0
    unknown: int = 0
    device_runs: int = 0
    compiles: int = 0
    recompiles: int = 0
    shared_nodes: int = 0
    node_reuse_count: int = 0
    retunes: int = 0
    # shape-bucketed compile telemetry (query/buckets.py)
    buckets: int = 0
    bucket_compiles: int = 0
    bucket_cache_hits: int = 0
    bucket_cache_misses: int = 0
    bucket_compile_seconds: float = 0.0
    compile_cache_entries: int = 0
    # streaming maintenance (repro_torch.maintenance)
    updates_submitted: int = 0     # triples ever submitted
    updates_applied: int = 0       # effective triples maintained
    refreshes: int = 0             # maintenance passes run
    backlog_batches: int = 0       # pending update batches right now
    backlog_triples: int = 0       # pending triples right now (lag)
    max_staleness_served: int = 0  # worst pending-triple count at answer
    maintenance_seconds: float = 0.0
    drift_retunes: int = 0
    # fault tolerance (degradation ladder, repro_torch.distributed.fault)
    health: str = "HEALTHY"        # HEALTHY|DEGRADED|STALE_ONLY|DOWN
    served_tier: int = 0           # tier that answered the last batch
    degraded_answers: int = 0      # answers served below tier 0
    stale_answers: int = 0         # answers flagged stale (budget/LKG)
    fused_failures: int = 0        # tier-0 batches lost after retries
    per_query_failures: int = 0
    ref_engine_failures: int = 0
    maintenance_failures: int = 0  # delta passes that failed (requeued)
    integrity_failures: int = 0    # extent misalignment detections
    repairs: int = 0               # successful integrity repairs
    retune_failures: int = 0       # drift retunes rolled back
    retune_rollbacks: int = 0      # retune_online calls rolled back
    breaker_state: str = "closed"
    breaker_opens: int = 0
    last_batch: dict = field(default_factory=lambda: {
        "tier": 0, "degraded": False, "stale": False})
    faults: list = field(default_factory=list)   # bounded fault log
    # async frontend summary (repro_torch.serve.frontend): queue
    # depth, batch occupancy, shed/downgrade counters, per-class latency
    # histograms — mirrored in by ServingFrontend._sync after each
    # completed batch
    frontend: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        d = dict(self.__dict__)
        d["last_batch"] = dict(self.last_batch)
        d["faults"] = list(self.faults)
        d["frontend"] = dict(self.frontend)
        return d


class QueryServer:
    MAX_FAULT_LOG = 64

    def __init__(self, executor: QueryExecutor, session=None,
                 maintenance=None, chaos=None, policy=None):
        """`maintenance`: None (static store), a
        `repro_torch.maintenance.MaintenanceConfig`, or a pre-built
        `ViewMaintainer` bound to this executor.  `chaos`: a
        `repro_torch.serve.chaos.FaultInjector` wired into every fault
        boundary (executor, session, maintainer).  `policy`: the
        degradation ladder's `RetryPolicy` (retries, breaker cooldown,
        backoff — all deterministic batch counts)."""
        self.executor = executor
        self.session = session
        self.chaos = chaos
        self.policy = policy or RetryPolicy()
        self.supervisor = ServingSupervisor(self.policy)
        self.stats = ServeStats()
        self.maintainer = None
        self.stream = None
        self._lkg: dict[str, set[tuple[int, ...]]] = {}
        if chaos is not None:
            executor.set_fault_hook(chaos)
            if session is not None:
                session.fault_hook = chaos
        if maintenance is not None:
            from repro_torch.maintenance import (MaintenanceConfig,
                                                 UpdateStream, ViewMaintainer)

            if isinstance(maintenance, ViewMaintainer):
                self.maintainer = maintenance
                if self.session is not None:
                    # session adopts the pre-built maintainer's measured
                    # costs so they flow into its retune objective
                    self.session.maintenance_costs = self.maintainer.costs
            else:
                cfg = maintenance if isinstance(maintenance,
                                                MaintenanceConfig) \
                    else MaintenanceConfig()
                costs = (self.session.maintenance_costs
                         if self.session is not None else None)
                self.maintainer = ViewMaintainer(executor, cfg, costs=costs)
            self.stream = UpdateStream()

    @classmethod
    def from_tuned(cls, store, workload, schema=None, type_id=None, cfg=None,
                   chaos=None, policy=None, device=None):
        """Convenience: one retained tuning session on `device` (the card
        unless "cpu"), served.  The server can retune online (unlike the
        deprecated one-shot `tune()`)."""
        from repro_torch.api.session import TuningSession

        session = TuningSession(store, workload=list(workload), schema=schema,
                                type_id=type_id, cfg=cfg, device=device)
        session.retune()
        session.apply()
        return cls(session.executor, session=session, chaos=chaos,
                   policy=policy)

    # ------------------------------------------------------------------
    def retune_online(self, add=(), remove=()) -> dict:
        """Evolve the workload behind the endpoint: add/remove queries,
        warm-retune, delta-swap the view set — all while this server
        object keeps serving (next batch sees the new configuration).
        The whole edit is validated before any of it is applied, and the
        retune+apply runs as ONE TRANSACTION: any failure rolls the
        session, workload and executor bindings back to their pre-call
        state (the previous compiled program keeps serving) and
        re-raises.  Returns {"retune": RetuneReport, "apply": ApplyReport}.
        """
        if self.session is None:
            raise RuntimeError(
                "retune_online needs a session-bound server; construct via "
                "TuningSession.serve() or QueryServer.from_tuned()")
        current = {q.name for q in self.session.workload}
        unknown = set(remove) - current
        if unknown:
            raise KeyError(f"unknown queries: {sorted(unknown)}")
        surviving = current - set(remove)
        for q in add:
            if not q.name:
                raise ValueError("workload queries must be named")
            if q.name in surviving:
                raise ValueError(f"duplicate query name {q.name!r}")
            surviving.add(q.name)
        snap = self.session.snapshot()
        try:
            for name in remove:
                self.session.remove_query(name)
            for q in add:
                self.session.add_query(q)
            retune = self.session.retune()
            apply_ = self.session.apply()  # hot swap: executor stays valid
        except Exception as exc:
            self.session.restore(snap)
            if self.maintainer is not None:
                self.maintainer.rebind(self.executor)
            self.stats.retune_rollbacks += 1
            self._note_fault("retune_online", exc)
            raise
        if self.maintainer is not None:
            self.maintainer.rebind(self.executor)
        self.stats.retunes += 1
        return {"retune": retune, "apply": apply_}

    # ------------------------------------------------------------------
    # streaming updates (repro_torch.maintenance)
    # ------------------------------------------------------------------
    def submit(self, inserts=None, deletes=None) -> None:
        """Enqueue one update batch.  Cheap: the device work happens at
        the next answer under the staleness budget (or at `flush`)."""
        if self.stream is None:
            raise RuntimeError(
                "server has no update stream; construct with maintenance=")
        from repro_torch.maintenance import Delta

        self.stream.push(Delta.of(inserts, deletes))
        self.stats.updates_submitted = self.stream.total_pushed

    def flush(self) -> list:
        """Apply the entire backlog now, regardless of budget."""
        return self._refresh(budget=0)

    def _refresh(self, budget: int | None = None) -> list:
        """Apply pending deltas while the backlog exceeds the budget;
        returns the MaintenanceReports of the applied passes.  A delta
        whose apply fails is requeued at the stream head (sequential
        semantics preserved) and the failure re-raised — `answer_batch`
        absorbs it and serves stale-flagged answers instead."""
        if self.stream is None or self.maintainer is None:
            return []
        if budget is None:
            budget = self.maintainer.cfg.staleness_budget
        reports = []
        while self.stream.pending_triples > budget:
            delta = self.stream.coalesce() if budget == 0 \
                else self.stream.pop()
            if delta is None:
                break
            try:
                report = self.maintainer.apply(delta)
            except Exception:
                self.stream.push_front(delta)
                self.stats.backlog_batches = self.stream.pending_batches
                self.stats.backlog_triples = self.stream.pending_triples
                raise
            reports.append(report)
            self.stats.refreshes += 1
            self.stats.updates_applied += (report.eff_inserts
                                           + report.eff_deletes)
            self.stats.maintenance_seconds += report.seconds
            if self.session is not None:
                self.session.store = self.executor.store
            if (report.drift is not None and report.drift.triggered
                    and self.maintainer.cfg.auto_retune
                    and self.session is not None):
                self._drift_retune()
        self.stats.backlog_batches = self.stream.pending_batches
        self.stats.backlog_triples = self.stream.pending_triples
        return reports

    def _drift_retune(self) -> None:
        """Drift-triggered retune: re-search with measured maintenance
        costs and the store's fresh statistics, hot-swap the program,
        and rebind the maintainer to the new view set.  Transactional:
        a failure restores the session/executor to their pre-retune
        bindings and is absorbed (counted in `retune_failures`) — an
        automatic background retune must never take serving down."""
        snap = self.session.snapshot()
        try:
            self.session.retune()
            self.session.apply()  # hot swap on the same executor object
        except Exception as exc:
            self.session.restore(snap)
            self.maintainer.rebind(self.executor)
            if is_device_fault(exc):
                raise
            self.stats.retune_failures += 1
            self._note_fault("drift_retune", exc)
            return
        self.maintainer.rebind(self.executor)
        self.stats.retunes += 1
        self.stats.drift_retunes += 1

    # ------------------------------------------------------------------
    # degradation ladder
    # ------------------------------------------------------------------
    def _integrity_ok(self) -> bool:
        """Probe the invariant streaming maintenance preserves: every
        materialized extent's host mirror has exactly the device
        buffer's logical row count.  A mismatch means one side is
        corrupt — the fused and per-query tiers (which read the device
        buffers and, for oracle fallbacks, the mirrors) must not serve
        until re-materialization repairs it.

        The device counts come to the host in ONE transfer (a stack of
        every buffer's count), not one blocking read per view."""
        ex = self.executor
        if not ex.device_views:
            return True
        host = []
        for vid in ex.device_views:
            rel = ex.extents.get(vid)
            if rel is None:
                return False
            host.append(len(rel.rows))
        dev = torch.stack([p.n.reshape(()) for p in ex.device_views.values()])
        return dev.cpu().tolist() == host

    def _note_fault(self, kind: str, exc) -> None:
        self.stats.faults.append(f"{kind}: {exc}")
        del self.stats.faults[:-self.MAX_FAULT_LOG]

    def _serve_names(self, known: list[str]
                     ) -> tuple[int, dict[str, set[tuple[int, ...]]], bool]:
        """Run the degradation ladder for this batch's known names.
        Returns (tier, answers, repaired); raises `ServiceUnavailable`
        when no tier (including the LKG cache) can serve."""
        pol, breaker = self.policy, self.supervisor.fused
        repaired = False

        # ---- tier 0: fused device program -------------------------
        extents_ok = self._integrity_ok()
        if not extents_ok:
            self.stats.integrity_failures += 1
            self._note_fault("integrity", "extent host/device misalignment")
            try:
                self.invalidate()  # repair: re-materialize from the store
                extents_ok = self._integrity_ok()
                if extents_ok:
                    self.stats.repairs += 1
                    repaired = True
            except Exception as exc:
                if is_device_fault(exc):
                    raise
                self._note_fault("repair", exc)
        if extents_ok and breaker.allow():
            for attempt in range(pol.max_attempts):
                try:
                    t0 = time.perf_counter()
                    self.executor.answer_workload()  # one program run
                    answers = {n: self.executor.answer_group(n)
                               for n in known}
                    elapsed = time.perf_counter() - t0
                    if (pol.call_timeout_seconds is not None
                            and elapsed > pol.call_timeout_seconds):
                        # soft budget: the answers are exact but the
                        # tier is too slow — trip the breaker so later
                        # batches degrade instead of stalling
                        breaker.record_failure()
                        self._note_fault(
                            "fused_slow",
                            f"{elapsed:.3f}s > {pol.call_timeout_seconds}s")
                    else:
                        breaker.record_success()
                    return 0, answers, repaired
                except Exception as exc:
                    if is_device_fault(exc):
                        raise
                    if attempt + 1 >= pol.max_attempts:
                        breaker.record_failure()
                        self.stats.fused_failures += 1
                        self._note_fault("fused", exc)

        # ---- tier 1: per-query path -------------------------------
        if extents_ok:
            try:
                if self.chaos is not None:
                    self.chaos.fire("per_query_call")
                answers = {n: self.executor.answer_group_per_query(n)
                           for n in known}
                return 1, answers, repaired
            except Exception as exc:
                if is_device_fault(exc):
                    raise
                self.stats.per_query_failures += 1
                self._note_fault("per_query", exc)

        # ---- tier 2: host reference engine over the raw TT --------
        try:
            if self.chaos is not None:
                self.chaos.fire("ref_engine_call")
            answers = {n: self.executor.answer_group_direct(n)
                       for n in known}
            return 2, answers, repaired
        except Exception as exc:
            if is_device_fault(exc):
                raise
            self.stats.ref_engine_failures += 1
            self._note_fault("ref_engine", exc)

        # ---- tier 3: last-known-good cache (stale) ----------------
        if known and all(n in self._lkg for n in known):
            return 3, {n: self._lkg[n] for n in known}, repaired
        raise ServiceUnavailable(
            "no serving tier available and no last-known-good answers "
            f"for {sorted(n for n in known if n not in self._lkg)}")

    # ------------------------------------------------------------------
    def answer_batch(self, names: list[str]) -> list[set[tuple[int, ...]] | None]:
        """Answer a batch of workload query names (union-group semantics)
        through the degradation ladder.

        Unknown names yield None instead of failing the batch.  With
        streaming maintenance configured, pending updates beyond the
        staleness budget are applied first; a failed maintenance pass
        requeues its delta and the batch is flagged stale if the
        backlog exceeds the budget.  Every returned answer is exact for
        the store snapshot it was computed on unless
        `stats.last_batch["stale"]` is set (tier-3 / over-budget
        serving).  Raises `ServiceUnavailable` — and goes DOWN — only
        when every tier and the last-known-good cache fail; re-raises a
        device fault (`is_device_fault`) of the integrity probe, any tier
        or a maintenance pass, also going DOWN.
        """
        self.supervisor.begin_batch()
        stale = False
        try:
            self._refresh()
        except Exception as exc:
            if is_device_fault(exc):
                self._device_down(names, exc)
            self.stats.maintenance_failures += 1
            self._note_fault("maintenance", exc)
        if self.stream is not None:
            pending = self.stream.pending_triples
            self.stats.max_staleness_served = max(
                self.stats.max_staleness_served, pending)
            if pending > self.maintainer.cfg.staleness_budget:
                stale = True
        known = [n for n in names if n in self.executor.groups]
        try:
            tier, answers, repaired = self._serve_names(known)
        except ServiceUnavailable:
            self.supervisor.observe(None, stale, reason="no servable tier")
            self._finish_batch(names, known, tier=None, stale=stale)
            raise
        except Exception as exc:
            if is_device_fault(exc):
                self._device_down(names, exc)
            raise
        if tier < 3:
            self._lkg.update(answers)
        else:
            stale = True
        self.supervisor.observe(tier, stale, degraded=repaired)
        degraded = tier > 0 or repaired
        out: list[set[tuple[int, ...]] | None] = []
        for name in names:
            if name in self.executor.groups:
                out.append(answers[name])
            else:
                self.stats.unknown += 1
                out.append(None)
        if degraded:
            self.stats.degraded_answers += len(known)
        if stale:
            self.stats.stale_answers += len(known)
        self._finish_batch(names, known, tier=tier, stale=stale,
                           degraded=degraded)
        return out

    def _device_down(self, names, exc: Exception) -> NoReturn:
        """The card failed (`is_device_fault`): a fault of the
        deployment, not of this batch, so the server goes DOWN and the
        error surfaces instead of a lower tier answering."""
        self._note_fault("device", exc)
        self.supervisor.observe(None, False, reason="device fault")
        self._finish_batch(names, [], tier=None, stale=False)
        raise exc

    def _finish_batch(self, names, known, tier, stale,
                      degraded: bool = False) -> None:
        self.stats.requests += len(names)
        self.stats.batches += 1
        self.stats.served_tier = tier if tier is not None else -1
        self.stats.last_batch = {"tier": tier, "degraded": degraded,
                                 "stale": stale}
        self.stats.health = self.supervisor.health
        self.stats.breaker_state = self.supervisor.fused.state
        self.stats.breaker_opens = self.supervisor.fused.opens
        self._sync_telemetry()

    def answer(self, name: str) -> set[tuple[int, ...]] | None:
        return self.answer_batch([name])[0]

    # ------------------------------------------------------------------
    def readiness(self) -> dict:
        """Readiness probe: can this server answer SOMETHING (possibly
        stale)?  Ready in every health state but DOWN."""
        probe = {
            "ready": self.supervisor.ready(),
            "health": self.supervisor.health,
            "breaker": self.supervisor.fused.state,
            "backlog_triples": (self.stream.pending_triples
                                if self.stream is not None else 0),
            "lkg_queries": len(self._lkg),
            "batches": self.supervisor.batches,
        }
        if self.stats.frontend:
            # async frontend attached: surface its queue/shed state too
            probe["frontend"] = {
                k: self.stats.frontend.get(k)
                for k in ("queue_depth", "shed", "downgraded",
                          "batch_occupancy")}
        return probe

    # ------------------------------------------------------------------
    def invalidate(self, store=None) -> None:
        """Refresh after TT maintenance: re-materialize view extents,
        re-upload the triple-table indexes (optionally from a replaced
        store), and drop cached results so the next batch re-runs the
        fused program against fresh data."""
        self.executor.refresh(store)
        if self.session is not None:
            # keep the session on the serving store: later retunes search
            # with its statistics, and save() persists its triple table
            self.session.store = self.executor.store
        if self.maintainer is not None:
            # refresh() rebuilt device state from scratch (unpadded TT,
            # exact-class extents): re-establish maintenance invariants
            self.maintainer.rebind(self.executor)

    def _sync_telemetry(self) -> None:
        t = self.executor.telemetry()
        self.stats.device_runs = t["runs"]
        self.stats.compiles = t["compiles"]
        self.stats.recompiles = t["recompiles"]
        self.stats.shared_nodes = t["shared_nodes"]
        self.stats.node_reuse_count = t["node_reuse_count"]
        self.stats.buckets = t["buckets"]
        self.stats.bucket_compiles = t["bucket_compiles"]
        self.stats.bucket_cache_hits = t["bucket_cache_hits"]
        self.stats.bucket_cache_misses = t["bucket_cache_misses"]
        self.stats.bucket_compile_seconds = t["bucket_compile_seconds"]
        self.stats.compile_cache_entries = t["compile_cache"]["entries"]
        if self.stream is not None:
            self.stats.backlog_batches = self.stream.pending_batches
            self.stats.backlog_triples = self.stream.pending_triples
