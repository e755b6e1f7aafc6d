"""ViewMaintainer: applies streaming deltas to a live QueryExecutor.

The counterpart of `repro/maintenance/maintainer.py`, with the same
config, report and telemetry keys.  Per batch (one device maintenance
pass, shapes constant in steady state):

  1. net the batch against the store (effective inserts/deletes);
  2. deletion pass — wizard views are full projections, so a row dies
     iff one of its instantiated atom triples is deleted: a host-side
     membership mask over the extent mirror, uploaded to the executor's
     device and applied there by the stable-partition `E.compact`;
  3. upload TT' padded to a capacity class (`tt_device_indexes_padded`)
     — scan operand shapes never change while the store grows within
     the class;
  4. insertion pass — delta relations matched per atom pattern, then
     the per-(view, atom) delta plans run on the selected engine:
     "device" pads them to the `delta_cap` class and joins against TT'
     in ONE bucketed workload program for all views (see delta_plan.py,
     shapes batch-independent — the accelerator path; its join probes
     launch the `join_count` kernel); "host" evaluates the same plan IR
     with vectorized numpy joins (host_delta.py — selective scans and no
     dispatch overhead, the CPU path); "auto" picks "device" when the
     executor lives on the card.  Either way the candidates are deduped
     against the extent mirror; the device engine appends them with the
     CUDA scatter-append kernel (`kernels/ops.scatter_append`), into a
     new buffer (rollback snapshots share the old one), growing to
     the next capacity class only when the extent outgrows its headroom
     (amortized: each growth doubles it);
  5. measured maintenance cost (extent rows touched per update triple,
     EWMA) flows into `core.quality.MaintenanceCostModel`, replacing
     the static estimate at the next retune;
  6. the drift detector observes the batch and may recommend a retune.

The executor's host extent mirrors and device buffers stay row-aligned
throughout (appends concatenate, deletes stable-partition on both
sides) — that alignment is what lets the deletion mask be computed on
the host and applied on the device without a gather-back.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.quality import MaintenanceCostModel
from repro_torch.core.queries import Const
from repro_torch.errors import InvariantViolation
from repro_torch.kernels import ops as kops
from repro_torch.maintenance.delta_plan import DeltaPlanSet, build_delta_plans
from repro_torch.maintenance.drift import DriftDetector, DriftReport
from repro_torch.maintenance.host_delta import execute_host
from repro_torch.maintenance.stream import Delta
from repro_torch.query import engine as E
from repro_torch.query import ref_engine as R
from repro_torch.query.cost import capacity_for
from repro_torch.query.workload import WorkloadExecutor
from repro_torch.rdf.triples import TripleStore
from repro_torch.views.maintenance import (apply_delta as oracle_apply_delta,
                                           effective_delta, retract_mask)
from repro_torch.views.materializer import measured_info


@dataclass(frozen=True)
class MaintenanceConfig:
    delta_cap: int = 256        # capacity class of delta relations; also
    #                             the insert chunk size (bigger batches
    #                             run as several device passes)
    expected_batch: int = 64    # planning estimate for delta-join sizing
    staleness_budget: int = 0   # serve-path: max pending triples answered
    #                             stale (0 = always fresh)
    growth_safety: float = 2.0  # extent headroom when (re)packing buffers
    tt_safety: float = 1.5      # TT capacity-class headroom
    safety: float = 4.0         # delta-program buffer safety factor
    auto_retune: bool = True    # act on drift reports (server-side)
    drift_window: int = 8
    drift_rate_factor: float = 4.0
    drift_dist_threshold: float = 0.6
    drift_min_triples: int = 64
    insert_engine: str = "auto"  # "device" | "host" | "auto" (by device)

    def __post_init__(self):
        if self.delta_cap < 1 or self.delta_cap & (self.delta_cap - 1):
            raise ValueError(
                f"delta_cap must be a power of two, got {self.delta_cap}")
        if self.expected_batch < 1:
            raise ValueError("expected_batch must be positive")
        if self.staleness_budget < 0:
            raise ValueError("staleness_budget must be >= 0")
        if self.insert_engine not in ("auto", "device", "host"):
            raise ValueError(
                f"insert_engine must be auto|device|host, "
                f"got {self.insert_engine!r}")


@dataclass
class MaintenanceReport:
    n_inserts: int
    n_deletes: int
    eff_inserts: int
    eff_deletes: int
    appended: dict[int, int] = field(default_factory=dict)
    removed: dict[int, int] = field(default_factory=dict)
    delta_candidates: int = 0
    oracle_views: int = 0
    extents_scanned: int = 0    # deletion pass: extents actually visited
    extent_growths: list[int] = field(default_factory=list)
    tt_grew: bool = False
    seconds: float = 0.0
    drift: DriftReport | None = None

    @property
    def rows_touched(self) -> int:
        return (sum(self.appended.values()) + sum(self.removed.values())
                + self.delta_candidates)

    def summary(self) -> str:
        return (f"delta +{self.eff_inserts}/-{self.eff_deletes} "
                f"(of {self.n_inserts}/{self.n_deletes} requested): "
                f"appended {sum(self.appended.values())}, removed "
                f"{sum(self.removed.values())} extent rows across "
                f"{len(set(self.appended) | set(self.removed))} views "
                f"in {self.seconds * 1e3:.1f}ms"
                + (f"; grew {self.extent_growths}" if self.extent_growths else "")
                + ("; TT class grew" if self.tt_grew else ""))


def _rows_in(rows: np.ndarray, reference: np.ndarray) -> np.ndarray:
    """Membership mask for (n, w) int32 rows in a reference relation."""
    rows = np.asarray(rows, np.int32)
    reference = np.asarray(reference, np.int32)
    if len(rows) == 0:
        return np.zeros(0, dtype=bool)
    if len(reference) == 0:
        return np.zeros(len(rows), dtype=bool)
    w = rows.shape[1]
    dt = [(f"f{i}", np.int32) for i in range(w)]
    rv = np.ascontiguousarray(rows).view(dt).reshape(-1)
    fv = np.ascontiguousarray(reference).view(dt).reshape(-1)
    return np.isin(rv, fv)


def _row_bytes(rows: np.ndarray) -> list[bytes]:
    """Each (w,) int32 row as its raw bytes — a hashable key for the
    per-view extent sets (O(1) dedup per candidate, no void sorts)."""
    rows = np.ascontiguousarray(np.asarray(rows, np.int32))
    if len(rows) == 0:
        return []
    return rows.view(f"V{4 * rows.shape[1]}").reshape(-1).tolist()


class ViewMaintainer:
    """Binds to a `QueryExecutor` and maintains its extents in place."""

    def __init__(self, executor, cfg: MaintenanceConfig | None = None,
                 costs: MaintenanceCostModel | None = None):
        self.cfg = cfg or MaintenanceConfig()
        self.costs = costs if costs is not None else MaintenanceCostModel()
        # lifetime telemetry
        self.batches = 0
        self.triples_applied = 0
        self.seconds = 0.0
        self.extent_growths = 0
        self.tt_growths = 0
        self.oracle_batches = 0
        self.delete_scans = 0    # extents visited by deletion passes
        self.drift = None  # type: DriftDetector | None
        self._bind(executor)

    # ------------------------------------------------------------------
    # binding
    # ------------------------------------------------------------------
    def _bind(self, executor) -> None:
        self.executor = executor
        self.plans: DeltaPlanSet = build_delta_plans(executor.state)
        self.engine = self.cfg.insert_engine
        if self.engine == "auto":
            # device wins where the fused batch program amortizes; on
            # CPU its per-bucket dispatch overhead loses to numpy
            self.engine = ("device" if executor.device.type == "cuda"
                           else "host")
        self._delta_exec = None
        if self.plans.dag is not None and self.engine == "device":
            self._delta_exec = WorkloadExecutor(
                self.plans.dag, executor.store.stats,
                self.plans.view_infos(self.cfg.expected_batch),
                device=executor.device, safety=self.cfg.safety,
                use_kernels=executor._use_kernels)
        self._repack_extents()
        # per-view extent length at the last statistics recount (the
        # cost model's RelInfo refresh is throttled to material drift)
        self._info_rows = {vid: len(executor.extents[vid].rows)
                           for vid in executor.state.views}
        # hashed extent rows for O(1) candidate dedup, and the host
        # engine's deferred-upload set (one transfer per touched view)
        self._ext_keys = {vid: set(_row_bytes(executor.extents[vid].rows))
                          for vid in executor.state.views}
        # per-predicate inverted index over view extents: the deletion
        # pass only visits extents whose view mentions a deleted
        # predicate (plus views with a variable predicate, which can
        # lose a row on any delete) — sub-linear in the view count
        # instead of scanning every candidate extent per batch
        self._pred_vids: dict[int, set[int]] = {}
        self._wild_vids: set[int] = set()
        for vid, view in executor.state.views.items():
            const_preds = [a.p.id for a in view.cq.atoms
                           if isinstance(a.p, Const)]
            if len(const_preds) < len(view.cq.atoms):
                self._wild_vids.add(vid)
            for p in const_preds:
                self._pred_vids.setdefault(p, set()).add(vid)
        self._dirty: dict[int, int] = {}  # vid -> target capacity
        self.tt_cap = capacity_for(len(executor.store),
                                   safety=self.cfg.tt_safety)
        executor.tt = E.tt_device_indexes_padded(
            executor.store, self.tt_cap, device=executor.device)
        if self.drift is None:
            self.drift = DriftDetector(
                executor.store.stats, window=self.cfg.drift_window,
                rate_factor=self.cfg.drift_rate_factor,
                dist_threshold=self.cfg.drift_dist_threshold,
                min_triples=self.cfg.drift_min_triples)
        else:
            self.drift.reset(executor.store.stats)
        executor.note_maintenance(executor.store)

    def rebind(self, executor=None) -> None:
        """Re-derive delta plans after a retune/hot swap changed the view
        set.  Measured costs survive (keyed by canonical CQ key)."""
        self._bind(executor if executor is not None else self.executor)

    def _repack_extents(self) -> None:
        """Give every extent buffer append headroom: the materializer
        packs at the exact capacity class; growth_safety > 1 repacks so
        the steady state appends in place instead of growing on the
        first batch."""
        ex = self.executor
        for vid, prel in list(ex.device_views.items()):
            rows = ex.extents[vid].rows
            cap = capacity_for(len(rows), safety=self.cfg.growth_safety)
            if cap != prel.cap:
                ex.device_views[vid] = E.make_prel(rows, cap,
                                                   device=ex.device)

    # ------------------------------------------------------------------
    # the per-batch maintenance pass
    # ------------------------------------------------------------------
    def apply(self, delta: Delta) -> MaintenanceReport:
        """One maintenance pass, TRANSACTIONAL: the executor bindings
        (store, TT, extents, device buffers) and this maintainer's
        bookkeeping are snapshotted first; any failure rolls them all
        back and re-raises, so the pre-delta state keeps serving and
        the caller can requeue the delta (`UpdateStream.push_front`).
        Only the measured-cost EWMAs are not rolled back — they are
        telemetry, not serving state."""
        ex = self.executor
        hook = getattr(ex, "fault_hook", None)
        if hook is not None:
            hook.fire("maintenance_apply")
        ex_snap = ex.snapshot()
        keys_snap, rows_snap = dict(self._ext_keys), dict(self._info_rows)
        cap_snap = self.tt_cap
        try:
            return self._apply(delta)
        except Exception:
            ex.restore(ex_snap)
            self._ext_keys, self._info_rows = keys_snap, rows_snap
            self.tt_cap = cap_snap
            self._dirty = {}
            raise

    def _apply(self, delta: Delta) -> MaintenanceReport:
        ex = self.executor
        t0 = time.perf_counter()
        store = ex.store
        eff_ins, eff_del = effective_delta(store, delta.inserts, delta.deletes)
        report = MaintenanceReport(
            n_inserts=len(delta.inserts), n_deletes=len(delta.deletes),
            eff_inserts=len(eff_ins), eff_deletes=len(eff_del),
            oracle_views=len(self.plans.oracle_vids))
        new_store = store.apply_delta(delta.inserts, delta.deletes)

        oracle_vids = self.plans.oracle_vids
        if len(eff_del):
            self._delete_pass(eff_del, oracle_vids, report)

        self._upload_tt(new_store, report)
        ex.note_maintenance(new_store)

        if len(eff_ins):
            self._insert_pass(eff_ins, oracle_vids, report)
        if oracle_vids and (len(eff_ins) or len(eff_del)):
            self._oracle_pass(store, eff_ins, eff_del, oracle_vids, report)
            self.oracle_batches += 1

        # host engine: one padded upload per dirty view for the whole
        # batch (delete + insert passes coalesce into a single transfer)
        for vid, cap in self._dirty.items():
            ex.device_views[vid] = E.make_prel(ex.extents[vid].rows, cap,
                                               device=ex.device)
        self._dirty.clear()

        self._observe_costs(report)
        report.seconds = time.perf_counter() - t0
        report.drift = self.drift.observe(
            report.eff_inserts + report.eff_deletes,
            np.concatenate([eff_ins[:, 1], eff_del[:, 1]]))
        self.batches += 1
        self.triples_applied += report.eff_inserts + report.eff_deletes
        self.seconds += report.seconds
        self.extent_growths += len(report.extent_growths)
        return report

    # -- deletion ------------------------------------------------------
    def _delete_pass(self, eff_del: np.ndarray, skip: set[int],
                     report: MaintenanceReport) -> None:
        ex = self.executor
        del_preds = set(np.unique(eff_del[:, 1]).tolist())
        # inverted index: only extents whose view can actually lose a
        # row are visited — everything else is never even iterated
        candidates = set(self._wild_vids)
        for p in del_preds:
            candidates |= self._pred_vids.get(p, set())
        for vid in sorted(candidates):
            if vid in skip:
                continue
            view = ex.state.views[vid]
            self.delete_scans += 1
            report.extents_scanned += 1
            rel = ex.extents[vid]
            keep = retract_mask(view.cq, rel.rows, eff_del)
            gone = int(len(keep) - int(keep.sum()))
            if not gone:
                continue
            prel = ex.device_views[vid]
            if self.engine == "host":
                # CPU path: defer to one padded re-upload per touched
                # view at the end of the batch (a memcpy — cheaper than
                # dispatching the compact)
                self._dirty[vid] = prel.cap
            else:
                keep_dev = np.zeros(prel.cap, dtype=bool)
                keep_dev[: len(keep)] = keep
                ex.device_views[vid] = E.compact(
                    prel.data, torch.from_numpy(keep_dev).to(ex.device),
                    prel.overflow)
            # copy-on-write: apply()'s rollback restores a shallow copy
            # of _ext_keys, so entries must be replaced, never mutated
            self._ext_keys[vid] = \
                self._ext_keys[vid] - set(_row_bytes(rel.rows[~keep]))
            ex.extents[vid] = R.Relation(rel.rows[keep], rel.cols)
            report.removed[vid] = gone

    # -- TT upload -----------------------------------------------------
    def _upload_tt(self, new_store: TripleStore,
                   report: MaintenanceReport) -> None:
        if len(new_store) > self.tt_cap:
            self.tt_cap = capacity_for(len(new_store),
                                       safety=self.cfg.tt_safety)
            report.tt_grew = True
            self.tt_growths += 1
        self.executor.tt = E.tt_device_indexes_padded(
            new_store, self.tt_cap, device=self.executor.device)

    # -- insertion -----------------------------------------------------
    def _insert_pass(self, eff_ins: np.ndarray, skip: set[int],
                     report: MaintenanceReport) -> None:
        if self.engine == "host":
            per_vid = self._insert_candidates_host(eff_ins)
        else:
            per_vid = self._insert_candidates_device(eff_ins)
        ex = self.executor
        for vid, parts in per_vid.items():
            cand = parts[0] if len(parts) == 1 else np.concatenate(parts)
            report.delta_candidates += len(cand)
            seen = self._ext_keys[vid]
            fresh_at, fresh_keys = [], set()
            for i, b in enumerate(_row_bytes(cand)):
                if b in seen or b in fresh_keys:
                    continue
                fresh_keys.add(b)
                fresh_at.append(i)
            if not fresh_at:
                continue
            # copy-on-write (see _delete_pass): replace, never mutate
            self._ext_keys[vid] = seen | fresh_keys
            fresh = cand[np.asarray(fresh_at)]
            self._append_rows(vid, fresh, report)
            report.appended[vid] = len(fresh)

    def _insert_candidates_device(self, eff_ins: np.ndarray
                                  ) -> dict[int, list[np.ndarray]]:
        """One fused bucketed program per `delta_cap` chunk — shapes are
        batch-size-independent, so steady state never recompiles."""
        per_vid: dict[int, list[np.ndarray]] = {}
        if self._delta_exec is None:
            return per_vid
        ex = self.executor
        dcap = self.cfg.delta_cap
        for start in range(0, len(eff_ins), dcap):
            chunk = eff_ins[start: start + dcap]
            dviews = {}
            for leaf in self.plans.leaf_list():
                matched = leaf.match(chunk)
                dviews[leaf.vid] = E.make_prel(matched, dcap,
                                               device=ex.device)
            roots = self._delta_exec.run(ex.tt, dviews)
            for name, prel in roots.items():
                vid = self.plans.root_vid[name]
                rows = E.to_numpy(prel)
                if len(rows):
                    per_vid.setdefault(vid, []).append(rows)
        return per_vid

    def _insert_candidates_host(self, eff_ins: np.ndarray
                                ) -> dict[int, list[np.ndarray]]:
        """The same delta plans evaluated with vectorized numpy joins —
        dynamic shapes, no chunking, empty-seed plans short-circuit."""
        per_vid: dict[int, list[np.ndarray]] = {}
        store = self.executor.store  # TT' (note_maintenance already ran)
        leaves = {leaf.vid: leaf.match(eff_ins)
                  for leaf in self.plans.leaf_list()}
        for name, plan in self.plans.plans.items():
            rows = execute_host(plan, store, leaves).rows
            if len(rows):
                per_vid.setdefault(self.plans.root_vid[name], []).append(rows)
        return per_vid

    def _append_rows(self, vid: int, rows: np.ndarray,
                     report: MaintenanceReport) -> None:
        """Device scatter-append + host mirror concat, growing the
        capacity class first when headroom runs out."""
        ex = self.executor
        prel = ex.device_views[vid]
        rel = ex.extents[vid]
        k, w = len(rows), prel.width
        merged = np.concatenate([rel.rows, rows])
        if self.engine == "host":
            # CPU path: the host mirror IS current — defer one padded
            # transfer per touched view to the end of the batch; the
            # kernel only pays off where dispatch amortizes
            cap = self._dirty.get(vid, prel.cap)
            if len(merged) > cap:
                cap = capacity_for(len(merged),
                                   safety=self.cfg.growth_safety)
                report.extent_growths.append(vid)
            self._dirty[vid] = cap
        else:
            # no host read and no synchronising copy: n from the host
            # mirror (check_alignment: it holds prel.n rows), the delta
            # rows through pinned memory (the caching host allocator keeps
            # the block until the copy is done), the new count on the
            # device
            dev = ex.device
            n = len(rel.rows)
            if n + k > prel.cap:
                new_cap = capacity_for(n + k, safety=self.cfg.growth_safety)
                data = torch.full((new_cap, w), -1, dtype=torch.int32,
                                  device=dev)
                data[: prel.cap] = prel.data
                prel = E.PRel(data, prel.n, prel.overflow)
                report.extent_growths.append(vid)
            # delta buffer padded to its own class: few distinct shapes
            rcap = capacity_for(k, safety=1.0)
            rows_p = torch.empty((rcap, w), dtype=torch.int32,
                                 pin_memory=dev.type == "cuda")
            host = rows_p.numpy()
            host[:k] = rows
            host[k:] = -1
            data = kops.scatter_append(
                prel.data, n, rows_p.to(dev, non_blocking=True), k)
            ex.device_views[vid] = E.PRel(data, prel.n + k, prel.overflow)
        ex.extents[vid] = R.Relation(merged, rel.cols)

    # -- oracle fallback (disconnected / non-full-projection views) ----
    def _oracle_pass(self, old_store: TripleStore, eff_ins, eff_del,
                     vids: set[int], report: MaintenanceReport) -> None:
        ex = self.executor
        for vid in sorted(vids):
            cq = ex.state.views[vid].cq
            rel = ex.extents[vid]
            new_rows, _ = oracle_apply_delta(cq, rel.rows, old_store,
                                             eff_ins, eff_del)
            gone = int(len(rel.rows) - _rows_in(rel.rows, new_rows).sum())
            added = int(len(new_rows) - _rows_in(new_rows, rel.rows).sum())
            if added:
                report.appended[vid] = report.appended.get(vid, 0) + added
            if gone:
                report.removed[vid] = report.removed.get(vid, 0) + gone
            if added or gone:
                ex.extents[vid] = R.Relation(new_rows, rel.cols)
                self._ext_keys[vid] = set(_row_bytes(new_rows))
                cap = max(ex.device_views[vid].cap,
                          capacity_for(len(new_rows),
                                       safety=self.cfg.growth_safety))
                ex.device_views[vid] = E.make_prel(new_rows, cap,
                                                   device=ex.device)

    # -- measured cost -------------------------------------------------
    def _observe_costs(self, report: MaintenanceReport) -> None:
        ex = self.executor
        n_upd = max(report.eff_inserts + report.eff_deletes, 1)
        if report.eff_inserts == 0 and report.eff_deletes == 0:
            return
        for vid, view in ex.state.views.items():
            touched = (report.appended.get(vid, 0)
                       + report.removed.get(vid, 0))
            self.costs.observe(view.cq, touched / n_upd)
            if not touched:
                continue
            # recount the extent's distinct statistics only once it has
            # drifted materially — a full recount per batch would put an
            # O(extent) term on the per-batch critical path
            rows = len(ex.extents[vid].rows)
            last = self._info_rows.get(vid, 0)
            if abs(rows - last) > 0.25 * max(last, 1):
                ex.infos[vid] = measured_info(ex.extents[vid])
                self._info_rows[vid] = rows

    # ------------------------------------------------------------------
    def check_alignment(self, vid: int) -> None:
        """Invariant: host mirror rows == device valid prefix, in order."""
        ex = self.executor
        prel = ex.device_views[vid]
        host = ex.extents[vid].rows
        dev = E.to_numpy(prel)
        if len(host) != len(dev) or (len(host) and not (host == dev).all()):
            raise InvariantViolation(
                f"view v{vid}: host extent mirror and device buffer "
                f"diverged ({len(host)} vs {len(dev)} rows)")

    def telemetry(self) -> dict:
        t = {
            "batches": self.batches,
            "triples_applied": self.triples_applied,
            "seconds": self.seconds,
            "extent_growths": self.extent_growths,
            "tt_growths": self.tt_growths,
            "tt_cap": self.tt_cap,
            "oracle_views": len(self.plans.oracle_vids),
            "delete_scans": self.delete_scans,
            "delta_plans": len(self.plans.plans),
            "delta_leaves": len(self.plans.leaves),
            "measured_views": len(self.costs),
            "drift_triggers": self.drift.triggers if self.drift else 0,
            "insert_engine": self.engine,
            "delta_compiles": 0,
            "delta_recompiles": 0,
            "delta_runs": 0,
        }
        if self._delta_exec is not None:
            dt = self._delta_exec.telemetry()
            t["delta_compiles"] = dt.get("compiles", 0)
            t["delta_recompiles"] = dt.get("recompiles", 0)
            t["delta_runs"] = dt.get("runs", 0)
        return t
