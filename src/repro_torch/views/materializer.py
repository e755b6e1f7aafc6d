"""View Materializer: compute + store view extents.

The counterpart of `repro/views/materializer.py`.  Two paths with
identical extents:

  * `materialize_state` — oracle engine (host-side batch job), the
    original path;
  * `materialize_state_device` — the view CQs are planned as TT-scan
    trees, canonicalized into one shared-subplan DAG, and evaluated by
    the same fused workload program the Query Executor uses
    (`query/workload.py`), on the device, with scans/joins shared across
    views and capacity overflow recovered adaptively.

Either way extents are packaged as padded device relations with
measured statistics (rows + per-column distincts) that replace the
estimates once available — mirroring the paper's ANALYZE-after-CREATE.
"""
from __future__ import annotations

import numpy as np

import repro_torch
from repro_torch.core.state import State
from repro_torch.errors import InvariantViolation
from repro_torch.query import engine as E
from repro_torch.query import ref_engine as R
from repro_torch.query.cost import RelInfo, capacity_for
from repro_torch.query.plan import plan_for_cq
from repro_torch.rdf.triples import TripleStore


def materialize_view(cq, store: TripleStore) -> R.Relation:
    """Evaluate the view CQ over the TT (full projection, set semantics)."""
    return R.evaluate_cq(cq, store)


def measured_info(rel: R.Relation) -> RelInfo:
    rows = float(len(rel.rows))
    distinct = {
        c: (float(len(np.unique(rel.rows[:, i]))) if len(rel.rows) else 1.0)
        for i, c in enumerate(rel.cols)
    }
    return RelInfo(max(rows, 1e-3), distinct)


def _device_extent(ext: R.Relation, device) -> E.PRel:
    return E.make_prel(ext.rows, capacity_for(len(ext.rows), safety=1.0),
                       device)


def materialize_state(state: State, store: TripleStore, device=None):
    """Materialize every view of a state.

    Returns (extents_np, device_views, infos):
      extents_np:  {vid: oracle Relation}
      device_views: {vid: PRel} padded buffers on `device`
      infos:       {vid: RelInfo} measured statistics
    """
    dev = repro_torch.device(device)
    extents: dict[int, R.Relation] = {}
    device_views: dict[int, E.PRel] = {}
    infos: dict[int, RelInfo] = {}
    for vid, view in state.views.items():
        ext = materialize_view(view.cq, store)
        extents[vid] = ext
        infos[vid] = measured_info(ext)
        device_views[vid] = _device_extent(ext, dev)
    return extents, device_views, infos


def materialize_state_delta(state: State, store: TripleStore,
                            prev_state: State,
                            prev_extents: dict[int, R.Relation],
                            prev_infos: dict[int, RelInfo] | None = None,
                            prev_device: dict[int, E.PRel] | None = None,
                            device=None):
    """Delta path for an online view swap: materialize ONLY the views of
    `state` whose canonical key is new; views isomorphic to a previous
    view (same key, possibly different id / variable names / column
    order) reuse the old extent through a column permutation.  Under an
    identity permutation (the common case: the view simply survived the
    retune) the previous device buffer is carried over as-is — no host
    copy, no re-upload.

    Returns (extents, device, infos, reused, fresh, dropped):
      reused:  {new_vid: prev_vid} carried over without evaluation
      fresh:   [new_vid] actually materialized
      dropped: [prev_vid] dead extents the swap discards
    """
    from repro_torch.core.queries import isomorphism

    dev = repro_torch.device(device)
    # multiset match: one previous extent satisfies one new view
    by_key: dict = {}
    for pvid in sorted(prev_state.views):
        by_key.setdefault(prev_state.views[pvid].cq.canonical_key(),
                          []).append(pvid)

    extents: dict[int, R.Relation] = {}
    device_views: dict[int, E.PRel] = {}
    infos: dict[int, RelInfo] = {}
    reused: dict[int, int] = {}
    fresh: list[int] = []
    for vid, view in state.views.items():
        candidates = by_key.get(view.cq.canonical_key())
        pvid = candidates.pop(0) if candidates else None
        if pvid is not None:
            prev_view = prev_state.views[pvid]
            iso = isomorphism(prev_view.cq, view.cq)  # prev var -> new var
            if iso is None:
                raise InvariantViolation(
                    "equal canonical keys must be isomorphic")
            old_idx = {h.name: i for i, h in enumerate(prev_view.cq.head)}
            inv = {nv: pv for pv, nv in iso.items()}
            perm = [old_idx[inv[h].name] for h in view.cq.head]
            prev_rel = prev_extents[pvid]
            identity = perm == list(range(len(perm)))
            if identity and tuple(h.name for h in view.cq.head) == prev_rel.cols:
                ext = prev_rel
            else:
                rows = prev_rel.rows[:, perm] if len(prev_rel.rows) else \
                    prev_rel.rows.reshape(0, len(perm))
                ext = R.Relation(np.ascontiguousarray(rows),
                                 tuple(h.name for h in view.cq.head))
            reused[vid] = pvid
            if prev_infos is not None and pvid in prev_infos:
                pinfo = prev_infos[pvid]
                distinct = {h.name: pinfo.distinct[inv[h].name]
                            for h in view.cq.head}
                infos[vid] = RelInfo(pinfo.rows, distinct)
            else:
                infos[vid] = measured_info(ext)
            if identity and prev_device is not None and pvid in prev_device:
                device_views[vid] = prev_device[pvid]  # buffer survives as-is
            else:
                device_views[vid] = _device_extent(ext, dev)
        else:
            ext = materialize_view(view.cq, store)
            fresh.append(vid)
            infos[vid] = measured_info(ext)
            device_views[vid] = _device_extent(ext, dev)
        extents[vid] = ext
    matched = set(reused.values())
    dropped = [pvid for pvid in sorted(prev_state.views) if pvid not in matched]
    return extents, device_views, infos, reused, fresh, dropped


def materialize_state_device(state: State, store: TripleStore,
                             safety: float = 4.0, use_kernels: bool = True,
                             max_retries: int = 12, device=None):
    """Device path: materialize every view extent in one fused program
    run through the shared-subplan workload compiler.

    Same return contract as `materialize_state`.  View CQs of one state
    frequently share triple patterns (fusion produces overlapping
    bodies); the DAG computes each shared scan/join once for all views.
    """
    from repro_torch.query.dag import build_dag
    from repro_torch.query.plan import has_cartesian
    from repro_torch.query.workload import WorkloadExecutor

    dev = repro_torch.device(device)
    plans: dict[str, object] = {}
    oracle_vids: list[int] = []
    for vid, view in state.views.items():
        p = plan_for_cq(view.cq)
        if has_cartesian(p):  # disconnected view body: oracle only
            oracle_vids.append(vid)
        else:
            plans[f"v{vid}"] = p
    extents: dict[int, R.Relation] = {}
    device_views: dict[int, E.PRel] = {}
    infos: dict[int, RelInfo] = {}
    roots: dict[str, E.PRel] = {}
    if plans:
        dag = build_dag(plans)
        wl = WorkloadExecutor(dag, store.stats, {}, device=dev,
                              safety=safety, use_kernels=use_kernels,
                              max_retries=max_retries)
        roots = wl.run(E.tt_device_indexes(store, dev), {})
    for vid, view in state.views.items():
        if vid in oracle_vids:
            ext = materialize_view(view.cq, store)
        else:
            rows = E.to_numpy(roots[f"v{vid}"])
            ext = R.Relation(rows, tuple(h.name for h in view.cq.head))
        extents[vid] = ext
        infos[vid] = measured_info(ext)
        device_views[vid] = _device_extent(ext, dev)
    return extents, device_views, infos
