"""Query Executor: answers workload queries through the stored rewritings.

The counterpart of `repro/core/executor.py`.  The production path is
*workload-level*: every member rewriting (including reformulation-group
members) is canonicalized into one shared-subplan DAG (`query/dag.py`)
and run as one bucketed program (`query/workload.py`) that answers the
entire workload — each shared subtree computed once.  Capacity
overflows do not raise: the adaptive driver grows the offending buffer
and retries under a bounded retry budget (telemetry on
`executor.workload`).

Paths with identical answers:
  * `answer(name)` / `answer_workload()` — fused engine over
    materialized padded views on the device (adaptive),
  * `answer_per_query(name)` — per-query tree execution (kept for A/B
    comparisons; raises on overflow),
  * `answer_direct(name)` — oracle evaluation over the raw triple table
    (the paper's "before tuning" baseline).

Union groups from RDFS reformulation are answered by unioning member
rewritings (`answer_group`).  Disconnected rewritings (cartesian
products) are not device-compilable and fall back to the oracle over
the materialized extents.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import repro_torch
from repro_torch.core.state import State
from repro_torch.query import engine as E
from repro_torch.query import ref_engine as R
from repro_torch.query.dag import build_dag
from repro_torch.query.plan import has_cartesian
from repro_torch.query.workload import WorkloadExecutor
from repro_torch.rdf.triples import TripleStore
from repro_torch.views.materializer import (materialize_state,
                                            materialize_state_delta,
                                            materialize_state_device)


@dataclass
class ExecutorSnapshot:
    """Everything `swap_state`/`refresh` mutate, captured by reference
    (dicts shallow-copied) so a failed hot swap restores the executor
    object in place."""

    store: object
    state: State
    groups: dict
    queries: dict
    dag: object
    oracle_names: set
    extents: dict
    device_views: dict
    infos: dict
    tt: object
    workload: object
    results: dict | None


class QueryExecutor:
    def __init__(self, store: TripleStore, state: State,
                 groups: dict[str, list[str]] | None = None,
                 use_kernels: bool = True, safety: float = 4.0,
                 max_retries: int = 12, cap_planner=None,
                 device_materialize: bool = False,
                 workload_mode: str = "bucketed", device=None,
                 fault_hook=None):
        self.device = repro_torch.device(device)
        self.fault_hook = fault_hook
        self.store = store
        self.state = state
        self.groups = groups or {q.name: [q.name] for q in state.queries}
        self._use_kernels = use_kernels
        self._safety = safety
        self._max_retries = max_retries
        self._cap_planner = cap_planner
        self._device_materialize = device_materialize
        self._workload_mode = workload_mode
        self._queries = {q.name: q for q in state.queries}

        # ---- fused workload path: one DAG + one program ---------------
        self._build_dag()
        self._load_device_state(store)

        # per-query path: built lazily on first access (A/B only)
        self.__fns = None

    def _build_dag(self) -> None:
        device_plans = {}
        self._oracle_names: set[str] = set()
        for name, plan in self.state.rewritings.items():
            if has_cartesian(plan):
                self._oracle_names.add(name)
            else:
                device_plans[name] = plan
        self.dag = build_dag(device_plans)

    def _workload_executor(self, carry_caps: dict | None) -> WorkloadExecutor:
        return WorkloadExecutor(
            self.dag, self.store.stats, self.infos, device=self.device,
            safety=self._safety, use_kernels=self._use_kernels,
            max_retries=self._max_retries, cap_planner=self._cap_planner,
            mode=self._workload_mode, carry_caps=carry_caps,
            fault_hook=self.fault_hook)

    def _load_device_state(self, store: TripleStore,
                           carry_caps: dict | None = None) -> None:
        """(Re)materialize views and upload TT indexes + rebuild the
        fused executor against them.  `carry_caps` seeds the new program
        with capacities a previous one learned adaptively."""
        self.store = store
        if self._device_materialize:
            self.extents, self.device_views, self.infos = \
                materialize_state_device(self.state, store,
                                         use_kernels=self._use_kernels,
                                         device=self.device)
        else:
            self.extents, self.device_views, self.infos = \
                materialize_state(self.state, store, device=self.device)
        self.tt = E.tt_device_indexes(store, self.device)
        self.workload = self._workload_executor(carry_caps)
        self._results: dict[str, np.ndarray] | None = None

    # ------------------------------------------------------------------
    # transactional binding snapshots
    # ------------------------------------------------------------------
    def snapshot(self) -> ExecutorSnapshot:
        """Capture every binding `swap_state`/`refresh` mutate."""
        return ExecutorSnapshot(
            store=self.store, state=self.state, groups=dict(self.groups),
            queries=dict(self._queries), dag=self.dag,
            oracle_names=set(self._oracle_names),
            extents=dict(self.extents), device_views=dict(self.device_views),
            infos=dict(self.infos), tt=self.tt, workload=self.workload,
            results=self._results)

    def restore(self, snap: ExecutorSnapshot) -> None:
        """Roll the executor back to a snapshot, in place."""
        self.store = snap.store
        self.state = snap.state
        self.groups = snap.groups
        self._queries = snap.queries
        self.dag = snap.dag
        self._oracle_names = snap.oracle_names
        self.extents = snap.extents
        self.device_views = snap.device_views
        self.infos = snap.infos
        self.tt = snap.tt
        self.workload = snap.workload
        self._results = snap.results
        self.__fns = None

    def set_fault_hook(self, hook) -> None:
        """Attach a chaos injector to this executor and its current
        fused program (future programs inherit it automatically)."""
        self.fault_hook = hook
        self.workload.fault_hook = hook

    def refresh(self, store: TripleStore | None = None) -> None:
        """Point the executor at a maintained/replaced triple store:
        re-materializes every view extent, re-uploads the TT indexes,
        and rebuilds the fused program against the fresh statistics.
        With no argument, refreshes device state from the current store.
        Capacities the old program learned adaptively are carried into
        the new one.  Transactional: a failure mid-refresh restores the
        previous bindings."""
        snap = self.snapshot()
        carry = self.workload.learned_caps()
        try:
            self._load_device_state(
                store if store is not None else self.store,
                carry_caps=carry)
        except Exception:
            self.restore(snap)
            raise
        self.__fns = None

    def swap_state(self, state: State,
                   groups: dict[str, list[str]] | None = None,
                   warm: bool = True) -> dict:
        """Online view swap onto a retuned configuration: diff old vs new
        views by canonical key, materialize ONLY the genuinely new
        extents (reusing surviving ones through a column permutation),
        drop dead extents, and hot-swap the workload program.  The
        executor object stays valid throughout.

        Capacities the outgoing program learned adaptively are carried
        into the incoming one (keyed by DAG content key).  With
        `warm=True` (default) the new program runs once before the swap
        returns and the workload results are cached.  Returns the swap
        summary: {"materialized": [vid], "reused": [vid],
        "dropped": [prev_vid]}.

        The swap is TRANSACTIONAL: any failure rolls every binding back
        to the snapshot taken on entry and re-raises.
        """
        snap = self.snapshot()
        carry = self.workload.learned_caps()
        try:
            extents, device_views, infos, reused, fresh, dropped = \
                materialize_state_delta(state, self.store, self.state,
                                        self.extents, self.infos,
                                        self.device_views, device=self.device)
            self.state = state
            self.groups = groups or {q.name: [q.name] for q in state.queries}
            self._queries = {q.name: q for q in state.queries}
            self.extents, self.device_views, self.infos = \
                extents, device_views, infos
            self._build_dag()
            self.workload = self._workload_executor(carry)
            self._results = None
            self.__fns = None
            if warm:
                self.warmup()
        except Exception:
            self.restore(snap)
            raise
        return {"materialized": sorted(fresh), "reused": sorted(reused),
                "dropped": dropped}

    def note_maintenance(self, store: TripleStore) -> None:
        """In-place delta applied by `repro_torch.maintenance.
        ViewMaintainer`: extents, device buffers and TT were updated under
        the executor, so point at the new store and drop cached answers.
        The workload program survives — maintenance keeps operand shapes
        in their capacity classes precisely so this is NOT a refresh()."""
        self.store = store
        self._results = None
        self.__fns = None

    def warmup(self) -> None:
        """Build every bucket body of the current program and cache the
        workload results, so the next `answer*` call is pure reads."""
        roots = self.workload.warmup(self.tt, self.device_views)
        self._results = {name: E.to_numpy(rel) for name, rel in roots.items()}

    @property
    def _fns(self):
        if self.__fns is None:
            self.__fns = {}
            for q in self.state.queries:
                if q.name in self._oracle_names:
                    continue
                fn = E.build_executor(
                    self.state.rewritings[q.name], self.store.stats,
                    self.infos, safety=self._safety,
                    use_kernels=self._use_kernels,
                )
                self.__fns[q.name] = (fn, fn.out_columns)
        return self.__fns

    # ------------------------------------------------------------------
    def answer_workload(self) -> dict[str, np.ndarray]:
        """Answer every member rewriting in one fused program run
        (cached; overflow recovered adaptively)."""
        if self._results is None:
            roots = self.workload.run(self.tt, self.device_views)
            self._results = {name: E.to_numpy(rel)
                             for name, rel in roots.items()}
        return self._results

    def answer(self, name: str) -> np.ndarray:
        """Answer one (possibly reformulated-member) query via its rewriting."""
        if name in self._oracle_names:
            return R.execute(self.state.rewritings[name], self.store,
                             self.extents).rows
        return self.answer_workload()[name]

    def answer_group(self, original_name: str) -> set[tuple[int, ...]]:
        """Union semantics over the reformulation members of a query."""
        out: set[tuple[int, ...]] = set()
        for member in self.groups[original_name]:
            out |= {tuple(r) for r in self.answer(member).tolist()}
        return out

    # ------------------------------------------------------------------
    def answer_per_query(self, name: str) -> np.ndarray:
        """This member's rewriting executed alone as an operator tree."""
        fn, _cols = self._fns[name]
        out = fn(self.tt, self.device_views)
        if bool(out.overflow):
            raise RuntimeError(
                f"capacity overflow answering {name!r}; re-plan with a larger "
                f"safety factor"
            )
        return E.to_numpy(out)

    def answer_group_per_query(self, original_name: str
                               ) -> set[tuple[int, ...]]:
        """Union-group answer through the per-query path.  Each member
        runs alone (no shared subplans, raises on overflow); cartesian
        members fall back to the oracle over the materialized extents."""
        out: set[tuple[int, ...]] = set()
        for member in self.groups[original_name]:
            if member in self._oracle_names:
                out |= {tuple(r) for r in self.answer(member).tolist()}
            else:
                out |= {tuple(r)
                        for r in self.answer_per_query(member).tolist()}
        return out

    # ------------------------------------------------------------------
    def answer_direct(self, name: str) -> set[tuple[int, ...]]:
        """Baseline: evaluate the original CQ straight over the TT."""
        q = self._queries[name]
        return R.evaluate_cq(q, self.store).as_set()

    def answer_group_direct(self, original_name: str) -> set[tuple[int, ...]]:
        out: set[tuple[int, ...]] = set()
        for member in self.groups[original_name]:
            out |= self.answer_direct(member)
        return out

    # ------------------------------------------------------------------
    def telemetry(self) -> dict:
        t = self.workload.telemetry()
        t["oracle_fallbacks"] = len(self._oracle_names)
        return t
