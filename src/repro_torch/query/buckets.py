"""Shape-bucketed lowering of a `WorkloadDAG`: one batched call per bucket.

The counterpart of `repro/query/buckets.py`.  Nodes are grouped into
*shape buckets* by

    (topological wave, operator kind, structural signature, capacity class)

and each bucket executes as ONE call of a batched operator over its
members' stacked operands: the members sit on a leading axis of every
operand, where the JAX package runs a `lax.scan`.  The per-member
constants (scan prefix/residual bindings, filter values) are data; the
structure (column positions, join pairs, buffer capacities) is static,
so one bucket body serves every workload member that shares its shape.

Bucket bodies are built once per (kind, static spec, operand shapes)
key through a process-global `CompileCache` with the same key, LRU bound
and `stats()` keys as the JAX package's.  PyTorch runs eagerly, so
"compiling" a body means building its closure; the hit/miss accounting
is kept so that compile counts mean the same in both packages: a
promotion to the next capacity class misses for the promoted bucket and
for consumers whose operand shapes changed, and hits everywhere else.

Capacity classes are powers of two (`cost.capacity_for` /
`cost.promote_capacity`).  Consumers pad child buffers up to their
bucket's per-slot maximum capacity (padded rows are `-1`-scrubbed and
sit beyond the valid count, so operators never see them), which keeps a
bucket batchable even after one producer bucket has been promoted past
its siblings.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

import repro_torch
from repro_torch import trace
from repro_torch.query import cost as cost_mod
from repro_torch.query import engine as E
from repro_torch.query.dag import WorkloadDAG

CAP_CEIL = 1 << 22

# Default LRU bound of the process-global body cache.  A long-lived
# TuningSession.retune() loop churns through bucket shapes; the bound
# keeps only the working set resident.
DEFAULT_CACHE_ENTRIES = 512


# ----------------------------------------------------------------------
# persistent body cache
# ----------------------------------------------------------------------
class CompileCache:
    """Process-global LRU cache of built bucket bodies.

    Keyed by (kind, static signature, operand shape/dtype tuple): the
    key pins everything that shapes the body, so an entry is valid for
    any executor in the process — rebuilt programs after a view hot swap
    reuse every body whose shape survived.  Bounded to `max_entries`
    (LRU eviction); evictions surface in `stats()`.
    """

    def __init__(self, max_entries: int = DEFAULT_CACHE_ENTRIES) -> None:
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = max_entries
        self.entries: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.compile_seconds = 0.0

    def get(self, key, build_fn):
        """Return (body, cached, seconds): `body` is the callable
        `build_fn()` built for this key."""
        ent = self.entries.get(key)
        if ent is not None:
            self.hits += 1
            self.entries.move_to_end(key)  # most-recently used
            return ent, True, 0.0
        t0 = time.perf_counter()
        body = build_fn()
        dt = time.perf_counter() - t0
        self.entries[key] = body
        self.misses += 1
        self.compile_seconds += dt
        self._evict()
        return body, False, dt

    def _evict(self) -> None:
        while len(self.entries) > self.max_entries:
            self.entries.popitem(last=False)  # least-recently used
            self.evictions += 1

    def resize(self, max_entries: int) -> None:
        """Change the LRU bound in place (evicting immediately if the
        cache already exceeds the new bound)."""
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = max_entries
        self._evict()

    def clear(self) -> None:
        self.entries.clear()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.compile_seconds = 0.0

    def stats(self) -> dict:
        return {"entries": len(self.entries),
                "max_entries": self.max_entries,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "compile_seconds": self.compile_seconds}


_CACHE = CompileCache()


def compile_cache() -> CompileCache:
    return _CACHE


def clear_compile_cache() -> None:
    """Drop every cached bucket body."""
    _CACHE.clear()


# ----------------------------------------------------------------------
# bucket planning
# ----------------------------------------------------------------------
@dataclass
class Bucket:
    """One shape bucket: members share kind, structural signature and
    capacity class, and sit on the same topological wave (so no member
    depends on another — the batch is embarrassingly parallel)."""

    kind: str
    wave: int
    static: tuple                 # structural signature (positions only)
    cap: int                      # output capacity class (scan/join; 0 else)
    node_ids: list[int] = field(default_factory=list)
    promotions: int = 0
    # per-member constants, stacked + uploaded at build time: scan prefix
    # and residual values (pvals, rvals), filter values (fvals)
    pvals: torch.Tensor | None = None
    rvals: torch.Tensor | None = None
    fvals: torch.Tensor | None = None

    @property
    def label(self) -> str:
        return f"w{self.wave}:{self.kind}:cap{self.cap}:n{len(self.node_ids)}"


def node_waves(dag: WorkloadDAG) -> list[int]:
    """Topological wave per node: leaves at 0, inner nodes one past
    their deepest child.  Children always sit on strictly lower waves,
    so same-wave nodes can never depend on each other."""
    waves: list[int] = []
    for node in dag.nodes:
        if node.child_ids:
            waves.append(1 + max(waves[c] for c in node.child_ids))
        else:
            waves.append(0)
    return waves


def plan_buckets(dag: WorkloadDAG, caps: list[int], scan_specs: dict,
                 join_specs: dict) -> tuple[list[Bucket], dict[int, Bucket]]:
    """Group every non-view node into shape buckets.

    `caps` holds the planned output capacity class per node (scan/join;
    unused entries 0).  `scan_specs[nid]` / `join_specs[nid]` hold the
    static lowering parameters produced by `BucketedProgram`.  Returns
    (buckets in execution order, node id -> bucket).
    """
    waves = node_waves(dag)
    by_key: dict[tuple, Bucket] = {}
    node_bucket: dict[int, Bucket] = {}
    for node in dag.nodes:
        if node.kind == "view":
            continue
        if node.kind == "scan":
            idx_name, prefix, residual, takes, self_eq = scan_specs[node.id]
            static = ("scan", idx_name, tuple(c for c, _ in prefix),
                      tuple(c for c, _ in residual), takes, self_eq)
            cap = caps[node.id]
        elif node.kind == "filter":
            ci, _value = node.spec
            static = ("filter", ci, node.width)
            cap = 0
        elif node.kind == "join":
            lcol, rcol, residual, keep_right = join_specs[node.id]
            lw = dag.nodes[node.child_ids[0]].width
            rw = dag.nodes[node.child_ids[1]].width
            static = ("join", lcol, rcol, residual, keep_right, lw, rw)
            cap = caps[node.id]
        elif node.kind == "project":
            idxs, dedupe = node.spec
            cw = dag.nodes[node.child_ids[0]].width
            static = ("project", idxs, dedupe, cw)
            cap = 0
        else:
            raise TypeError(node.kind)
        key = (waves[node.id], static, cap)
        bucket = by_key.get(key)
        if bucket is None:
            bucket = Bucket(kind=node.kind, wave=waves[node.id],
                            static=static, cap=cap)
            by_key[key] = bucket
        bucket.node_ids.append(node.id)
        node_bucket[node.id] = bucket
    order = sorted(by_key.values(),
                   key=lambda b: (b.wave, min(b.node_ids)))
    return order, node_bucket


# ----------------------------------------------------------------------
# bucket bodies (built from the cache key alone — pure shape functions)
# ----------------------------------------------------------------------
def _scan_body(static, cap):
    _, _idx_name, prefix_cols, residual_cols, takes, self_eq = static

    def fn(index_data, pvals, rvals):
        return E.scan_pattern_batched(index_data, prefix_cols, pvals,
                                      residual_cols, rvals, takes, self_eq,
                                      cap)

    return fn


def _filter_body(static):
    _, ci, _width = static

    def fn(cdata, cn, covf, vals):
        return E.filter_eq(E.PRel(cdata, cn, covf), ci, vals)

    return fn


def _join_body(static, cap, use_kernels):
    _, lcol, rcol, residual, keep_right, _lw, _rw = static

    def fn(ldata, ln, lovf, rdata, rn, rovf):
        return E.join(E.PRel(ldata, ln, lovf), E.PRel(rdata, rn, rovf),
                      lcol, rcol, residual, keep_right, cap,
                      use_kernels=use_kernels)

    return fn


def _project_body(static):
    _, idxs, dedupe, _cw = static

    def fn(cdata, cn, covf):
        return E.project(E.PRel(cdata, cn, covf), idxs, dedupe)

    return fn


def body_builder(bucket: Bucket, use_kernels: bool = True):
    """The batched body function for one bucket, built from its static
    signature alone."""
    if bucket.kind == "scan":
        return _scan_body(bucket.static, bucket.cap)
    if bucket.kind == "filter":
        return _filter_body(bucket.static)
    if bucket.kind == "join":
        return _join_body(bucket.static, bucket.cap, use_kernels)
    if bucket.kind == "project":
        return _project_body(bucket.static)
    raise TypeError(bucket.kind)


def _shape_key(args) -> tuple:
    return tuple((tuple(a.shape), str(a.dtype)) for a in args)


# ----------------------------------------------------------------------
# capacity planning (shared with the static capacity analyzer)
# ----------------------------------------------------------------------
def plan_capacities(dag: WorkloadDAG, stats, view_infos, *,
                    safety: float = 4.0, cap_planner=None, ests=None,
                    carry_caps: dict | None = None, content_keys=None):
    """Plan per-node buffer capacities and static lowering specs.

    Returns (caps, scan_specs, join_specs, demands):
      caps:    planned output capacity class per node (0 where unsized),
      scan_specs[nid] = (idx_name, prefix, residual, takes, self_eq),
      join_specs[nid] = (lcol, rcol, residual, keep_right),
      demands: estimated row demand each sized buffer must absorb — the
               quantity `capacity_for` was fed, kept so the static
               capacity analyzer can re-check headroom without
               re-deriving the sizing inputs.
    """
    if ests is None:
        ests = cost_mod.estimate_dag(dag, stats, view_infos)
    if content_keys is None and carry_caps:
        content_keys = dag.content_keys()

    def _cap(node, rows: float) -> int:
        if cap_planner is not None:
            planned = int(cap_planner(node.plan, rows))
        else:
            planned = cost_mod.capacity_for(rows, safety=safety)
        if carry_caps:
            planned = max(planned,
                          carry_caps.get(content_keys[node.id], 0))
        return planned

    caps = [0] * len(dag.nodes)
    demands = [0.0] * len(dag.nodes)
    scan_specs: dict[int, tuple] = {}
    join_specs: dict[int, tuple] = {}
    for node in dag.nodes:
        if node.kind == "scan":
            idx_name, prefix, residual, takes, self_eq, _sorted = \
                E.atom_scan_spec(node.spec)
            scan_specs[node.id] = (idx_name, prefix, residual, takes,
                                   self_eq)
            demands[node.id] = E.range_cardinality(node.spec, prefix, stats)
            caps[node.id] = _cap(node, demands[node.id])
        elif node.kind == "join":
            lid, rid = node.child_ids
            pairs = node.spec
            doms = [max(ests[lid].info.dcol(l), ests[rid].info.dcol(r))
                    for l, r in pairs]
            lead_k = max(range(len(doms)), key=lambda i: doms[i])
            lcol, rcol = pairs[lead_k]
            residual = tuple(p for k, p in enumerate(pairs)
                             if k != lead_k)
            drop = {r for _, r in pairs}
            keep_right = tuple(i for i in range(dag.nodes[rid].width)
                               if i not in drop)
            join_specs[node.id] = (lcol, rcol, residual, keep_right)
            demands[node.id] = max(
                ests[lid].rows * ests[rid].rows / doms[lead_k], 1e-3)
            caps[node.id] = _cap(node, demands[node.id])
    return caps, scan_specs, join_specs, demands


# ----------------------------------------------------------------------
# the bucketed program
# ----------------------------------------------------------------------
class BucketedProgram:
    """Executable lowering of a `WorkloadDAG` as shape buckets.

    `execute(tt, views)` runs every bucket in wave order — one batched
    call per bucket — and returns ({root name: PRel}, own_overflow np
    (n_nodes,)), the same contract as the unrolled program plus
    host-side overflow attribution.

    `promote(node_ids)` moves the offending nodes' buckets to the next
    capacity class; only those buckets' bodies (and consumers whose
    operand shapes changed) are rebuilt on the next execute — everything
    else hits the persistent cache.

    `device` (default: the card) holds the stacked per-member constants;
    it must be the device of the operands `execute` is given.
    """

    def __init__(self, dag: WorkloadDAG, stats, view_infos, *,
                 device=None, safety: float = 4.0, use_kernels: bool = True,
                 cap_planner=None, ests=None,
                 carry_caps: dict | None = None):
        self.dag = dag
        self.stats = stats
        self.use_kernels = use_kernels
        self.device = repro_torch.device(device)
        if ests is None:
            ests = cost_mod.estimate_dag(dag, stats, view_infos)
        self.ests = ests
        self.content_keys = dag.content_keys()
        caps, scan_specs, join_specs, demands = plan_capacities(
            dag, stats, view_infos, safety=safety, cap_planner=cap_planner,
            ests=ests, carry_caps=carry_caps,
            content_keys=self.content_keys)
        self.caps = caps
        self.demands = demands
        self.buckets, self.node_bucket = plan_buckets(dag, caps, scan_specs,
                                                      join_specs)
        # stack per-member constants once (they never change), device-
        # resident: an upload per run would put a host transfer — and, in
        # PyTorch, a stream synchronization — on every bucket dispatch
        for b in self.buckets:
            if b.kind == "scan":
                pv, rv = [], []
                for nid in b.node_ids:
                    _, prefix, residual, _, _ = scan_specs[nid]
                    pv.append([v for _, v in prefix])
                    rv.append([v for _, v in residual])
                b.pvals = self._upload(np.asarray(pv, np.int32).reshape(
                    len(b.node_ids), -1))
                b.rvals = self._upload(np.asarray(rv, np.int32).reshape(
                    len(b.node_ids), -1))
            elif b.kind == "filter":
                b.fvals = self._upload(np.asarray(
                    [dag.nodes[nid].spec[1] for nid in b.node_ids], np.int32))
        # member-gather indices of `_gather_slot`, uploaded on first use
        self._takes: dict[tuple[int, ...], torch.Tensor] = {}
        # telemetry (per program; the cache itself is process-global)
        self.cache_hits = 0
        self.cache_misses = 0
        self.compile_seconds = 0.0
        self.compile_log: list[dict] = []  # one entry per body build

    # ------------------------------------------------------------------
    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    def signatures(self) -> set[tuple]:
        return {(b.static, b.cap) for b in self.buckets}

    # ------------------------------------------------------------------
    def promote(self, node_ids) -> list[tuple[int, int, int]]:
        """Promote the buckets containing `node_ids` to the next
        capacity class.  Returns [(nid, old_cap, new_cap)] for every
        member of every promoted bucket (the whole bucket moves, so the
        batch stays shape-uniform); empty when every offending bucket is
        already at the capacity ceiling."""
        grown: list[tuple[int, int, int]] = []
        seen: set[int] = set()
        for nid in node_ids:
            bucket = self.node_bucket.get(nid)
            if bucket is None or bucket.cap == 0 or id(bucket) in seen:
                continue
            seen.add(id(bucket))
            new = cost_mod.promote_capacity(bucket.cap, CAP_CEIL)
            if new <= bucket.cap:
                continue
            old = bucket.cap
            bucket.cap = new
            bucket.promotions += 1
            for m in bucket.node_ids:
                self.caps[m] = new
                grown.append((m, old, new))
        return grown

    # ------------------------------------------------------------------
    # operand assembly
    # ------------------------------------------------------------------
    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    @staticmethod
    def _pad_rows(data: torch.Tensor, cap: int) -> torch.Tensor:
        """Pad the row axis (second-to-last) up to `cap` with -1 rows;
        padded rows sit beyond the valid count, matching the scrubbed
        tail every operator already ignores."""
        have = data.shape[-2]
        if have == cap:
            return data
        return F.pad(data, (0, 0, 0, cap - have), value=-1)

    def _gather_slot(self, res, child_ids, cap: int):
        """Stack one operand slot for a bucket: the children's PRels,
        padded to `cap` rows each.  Consecutive children living in the
        same producer bucket collapse into one gather, so the dispatch
        count scales with producer-bucket runs, not members."""
        parts_d, parts_n, parts_o = [], [], []
        i = 0
        while i < len(child_ids):
            entry = res[child_ids[i]]
            if entry[0] is None:  # single PRel (view node)
                rel = entry[1]
                parts_d.append(self._pad_rows(rel.data[None], cap))
                parts_n.append(rel.n.reshape(1))
                parts_o.append(rel.overflow.reshape(1))
                i += 1
                continue
            producer = entry[0]
            idxs = [entry[1]]
            j = i + 1
            while j < len(child_ids) and res[child_ids[j]][0] is producer:
                idxs.append(res[child_ids[j]][1])
                j += 1
            key = tuple(idxs)
            take = self._takes.get(key)
            if take is None:
                take = self._takes[key] = self._upload(
                    np.asarray(idxs, np.int64))
            parts_d.append(self._pad_rows(producer.data[take], cap))
            parts_n.append(producer.n[take])
            parts_o.append(producer.overflow[take])
            i = j
        if len(parts_d) == 1:
            return parts_d[0], parts_n[0], parts_o[0]
        return (torch.cat(parts_d), torch.cat(parts_n), torch.cat(parts_o))

    # ------------------------------------------------------------------
    def _operands(self, bucket: Bucket, tt, res, eff_cap):
        """A bucket's stacked operands and its output's capacity."""
        dag = self.dag
        if bucket.kind == "scan":
            idx_name = bucket.static[1]
            args = (tt[idx_name], bucket.pvals, bucket.rvals)
            out_cap = bucket.cap
        elif bucket.kind == "filter":
            kids = [dag.nodes[nid].child_ids[0] for nid in bucket.node_ids]
            cap = max(eff_cap[c] for c in kids)
            cd, cn, co = self._gather_slot(res, kids, cap)
            args = (cd, cn, co, bucket.fvals)
            out_cap = cap
        elif bucket.kind == "join":
            lkids = [dag.nodes[nid].child_ids[0] for nid in bucket.node_ids]
            rkids = [dag.nodes[nid].child_ids[1] for nid in bucket.node_ids]
            lcap = max(eff_cap[c] for c in lkids)
            rcap = max(eff_cap[c] for c in rkids)
            ld, ln, lo = self._gather_slot(res, lkids, lcap)
            rd, rn, ro = self._gather_slot(res, rkids, rcap)
            args = (ld, ln, lo, rd, rn, ro)
            out_cap = bucket.cap
        elif bucket.kind == "project":
            kids = [dag.nodes[nid].child_ids[0] for nid in bucket.node_ids]
            cap = max(eff_cap[c] for c in kids)
            cd, cn, co = self._gather_slot(res, kids, cap)
            args = (cd, cn, co)
            out_cap = cap
        else:
            raise TypeError(bucket.kind)
        return args, out_cap

    def _run_bucket(self, bucket: Bucket, tt, res, eff_cap):
        with trace.span("bucket." + bucket.kind) as s:
            args, out_cap = self._operands(bucket, tt, res, eff_cap)
            key = self.cache_key(bucket, args)
            body, cached, dt = _CACHE.get(
                key, lambda: body_builder(bucket, self.use_kernels))
            if cached:
                self.cache_hits += 1
            else:
                self.cache_misses += 1
                self.compile_seconds += dt
                self.compile_log.append({
                    "bucket": bucket.label, "kind": bucket.kind,
                    "wave": bucket.wave, "cap": bucket.cap,
                    "batch": len(bucket.node_ids), "seconds": dt,
                })
            s.set(wave=bucket.wave, cap=bucket.cap,
                  batch=len(bucket.node_ids), built=not cached)
            out = body(*args)
        for i, nid in enumerate(bucket.node_ids):
            res[nid] = (out, i)
            eff_cap[nid] = out_cap
        return out

    # ------------------------------------------------------------------
    def execute(self, tt, views):
        """Run every bucket; returns ({root: PRel}, own_overflow np)."""
        dag = self.dag
        n = len(dag.nodes)
        res: list = [None] * n
        eff_cap: list[int] = [0] * n
        view_nids: list[int] = []
        for node in dag.nodes:
            if node.kind == "view":
                rel = views[node.spec]
                res[node.id] = (None, rel)
                eff_cap[node.id] = rel.cap
                view_nids.append(node.id)
        outs = [self._run_bucket(b, tt, res, eff_cap) for b in self.buckets]

        # host-side overflow attribution: one transfer for all flags
        flags = [o.overflow for o in outs] \
            + [res[nid][1].overflow.reshape(1) for nid in view_nids]
        flat = np.zeros(0, dtype=bool)
        if flags:
            cat = torch.cat(flags)
            with trace.span("sync.flags") as s:
                flat = cat.cpu().numpy()
                s.set(bytes=flat.nbytes)
        raw = np.zeros(n, dtype=bool)
        at = 0
        for b in self.buckets:
            raw[np.asarray(b.node_ids)] = flat[at: at + len(b.node_ids)]
            at += len(b.node_ids)
        for nid in view_nids:
            raw[nid] = bool(flat[at])
            at += 1
        own = raw.copy()
        for node in dag.nodes:
            if node.kind == "view":
                own[node.id] = False
            elif node.child_ids and raw[list(node.child_ids)].any():
                own[node.id] = False  # inherited, not this node's buffer

        roots: dict[str, E.PRel] = {}
        for name, nid in dag.roots.items():
            entry = res[nid]
            if entry[0] is None:
                roots[name] = entry[1]
            else:
                out, i = entry
                roots[name] = E.PRel(out.data[i], out.n[i], out.overflow[i])
        return roots, own

    # ------------------------------------------------------------------
    # static views of the program (no execution) — body lint hooks
    # ------------------------------------------------------------------
    def static_eff_caps(self, view_caps: dict[int, int] | None = None
                        ) -> list[int]:
        """Effective buffer capacity per node, computed exactly like
        `execute` propagates it but without touching the device: views
        take `view_caps[vid]` (falling back to a capacity class planned
        from the estimated extent rows), scans/joins their bucket's
        capacity class, filters/projects the max of their child caps."""
        view_caps = view_caps or {}
        eff: list[int] = [0] * len(self.dag.nodes)
        for node in self.dag.nodes:
            if node.kind == "view":
                eff[node.id] = view_caps.get(
                    node.spec,
                    cost_mod.capacity_for(self.ests[node.id].rows,
                                          safety=1.0))
        for bucket in self.buckets:
            for nid in bucket.node_ids:
                node = self.dag.nodes[nid]
                if bucket.kind in ("scan", "join"):
                    eff[nid] = bucket.cap
                else:  # filter/project pass through their child's cap
                    eff[nid] = max(eff[c] for c in node.child_ids)
        return eff

    def abstract_args(self, bucket: Bucket, n_tt: int,
                      eff_cap: list[int]) -> tuple:
        """Tensors on the `meta` device (shape and dtype, no data) shaped
        like the operands `_run_bucket` would stack for this bucket —
        enough to run the body abstractly.  `n_tt` is the triple count
        (scan buckets read one sorted (n_tt, 3) index)."""
        dag = self.dag
        B = len(bucket.node_ids)

        def spec(shape, dtype=torch.int32) -> torch.Tensor:
            return torch.empty(shape, dtype=dtype, device="meta")

        def slot(cap: int, width: int) -> tuple:
            return (spec((B, cap, width)), spec((B,)),
                    spec((B,), torch.bool))

        if bucket.kind == "scan":
            return (spec((n_tt, 3)), spec((B, bucket.pvals.shape[1])),
                    spec((B, bucket.rvals.shape[1])))
        if bucket.kind == "filter":
            kids = [dag.nodes[nid].child_ids[0] for nid in bucket.node_ids]
            cap = max(eff_cap[c] for c in kids)
            return slot(cap, bucket.static[2]) + (spec((B,)),)
        if bucket.kind == "join":
            lkids = [dag.nodes[nid].child_ids[0] for nid in bucket.node_ids]
            rkids = [dag.nodes[nid].child_ids[1] for nid in bucket.node_ids]
            lcap = max(eff_cap[c] for c in lkids)
            rcap = max(eff_cap[c] for c in rkids)
            lw, rw = bucket.static[5], bucket.static[6]
            return slot(lcap, lw) + slot(rcap, rw)
        if bucket.kind == "project":
            kids = [dag.nodes[nid].child_ids[0] for nid in bucket.node_ids]
            cap = max(eff_cap[c] for c in kids)
            return slot(cap, bucket.static[3])
        raise TypeError(bucket.kind)

    def cache_key(self, bucket: Bucket, args) -> tuple:
        """The persistent-cache key `_run_bucket` uses for this bucket
        with these operands (or with `abstract_args` of their shapes:
        the key reads only shapes and dtypes, so both give one key)."""
        return (bucket.static, bucket.cap, self.use_kernels,
                _shape_key(args))

    # ------------------------------------------------------------------
    def telemetry(self) -> dict:
        return {
            "buckets": self.n_buckets,
            "bucket_signatures": len(self.signatures()),
            "bucket_compiles": self.cache_misses,
            "bucket_cache_hits": self.cache_hits,
            "bucket_cache_misses": self.cache_misses,
            "bucket_compile_seconds": self.compile_seconds,
            "bucket_compile_log": list(self.compile_log),
            "bucket_promotions": sum(b.promotions for b in self.buckets),
        }
