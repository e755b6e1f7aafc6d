"""Fused workload execution: shape-bucketed (default) or unrolled.

The counterpart of `repro/query/workload.py`.  `compile_workload` lowers
a `WorkloadDAG` (query/dag.py) into one function over the whole
workload: nodes run in topological order, each shared node computed once
and its `PRel` buffer read by every consumer.  Static buffer capacities
are planned DAG-wide from the cost model (`cost.estimate_dag` +
`cost.capacity_for`).  This unrolled path runs one operator call per
node — it remains as the A/B reference (`mode="unrolled"`).

The default lowering is *shape-bucketed* (`query/buckets.py`,
`mode="bucketed"`): DAG nodes are grouped by (wave, operator kind,
structural signature, capacity class) and each bucket executes as one
batched operator call over stacked operands.

`WorkloadExecutor` wraps either program in an adaptive driver: alongside
the root results it observes each node's *own* overflow flag (latched
overflow minus anything inherited from children), so when a capacity
proves too small the driver knows exactly which buffer to grow.  In
bucketed mode an overflow promotes only the offending node's *bucket*
to the next capacity class.  Capacities learned this way can be carried
into a successor executor (`learned_caps()` / `carry_caps=`), so a
hot-swapped program does not re-learn overflows the previous one
already healed.
"""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

import repro_torch
from repro_torch import trace
from repro_torch.query import cost as cost_mod
from repro_torch.query import engine as E
from repro_torch.query.buckets import BucketedProgram, compile_cache
from repro_torch.query.dag import WorkloadDAG

CAP_CEIL = 1 << 22


def compile_workload(dag: WorkloadDAG, stats, view_infos,
                     safety: float = 4.0, use_kernels: bool = True,
                     caps: list[int] | None = None,
                     cap_planner: Callable[[object, float], int] | None = None,
                     ests=None):
    """Lower the DAG into `fn(tt, views) -> (roots, own_overflow)`.

    roots: {member name: PRel}; own_overflow: (n_nodes,) bool tensor of
    node-local overflows.  `caps` pins every node's buffer capacity
    (adaptive regrowth); when None, capacities are planned from the
    DAG-wide estimates (`cap_planner(node, est_rows)` overrides the
    default `capacity_for`, mirroring `build_executor`'s cap_override).
    The planned capacities are returned on `fn.caps`.  `ests` accepts
    precomputed `cost.estimate_dag` output.
    """
    if ests is None:
        ests = cost_mod.estimate_dag(dag, stats, view_infos)
    plan_caps = caps is None
    if plan_caps:
        caps = [0] * len(dag.nodes)

    def _cap(node, rows: float) -> int:
        if cap_planner is not None:
            return int(cap_planner(node.plan, rows))
        return cost_mod.capacity_for(rows, safety=safety)

    steps: list[tuple[Callable, tuple[int, ...], str]] = []
    for node in dag.nodes:
        if node.kind == "scan":
            idx_name, prefix, residual, takes, self_eq, _sorted = \
                E.atom_scan_spec(node.spec)
            if plan_caps:
                caps[node.id] = _cap(
                    node, E.range_cardinality(node.spec, prefix, stats))

            def step(tt, views, res, _f=functools.partial(
                    E.scan_pattern, prefix=prefix, residual=residual,
                    takes=takes, self_eq=self_eq, cap=caps[node.id]),
                    _idx=idx_name):
                return _f(tt[_idx])

        elif node.kind == "view":
            def step(tt, views, res, _vid=node.spec):
                return views[_vid]

        elif node.kind == "filter":
            ci, value = node.spec

            def step(tt, views, res, _c=node.child_ids[0], _ci=ci, _v=value):
                return E.filter_eq(res[_c], _ci, _v)

        elif node.kind == "join":
            lid, rid = node.child_ids
            pairs = node.spec
            doms = [max(ests[lid].info.dcol(l), ests[rid].info.dcol(r))
                    for l, r in pairs]
            lead_k = max(range(len(doms)), key=lambda i: doms[i])
            lcol, rcol = pairs[lead_k]
            residual = tuple(p for k, p in enumerate(pairs) if k != lead_k)
            drop = {r for _, r in pairs}
            keep_right = tuple(i for i in range(dag.nodes[rid].width)
                               if i not in drop)
            if plan_caps:
                lead_rows = max(
                    ests[lid].rows * ests[rid].rows / doms[lead_k], 1e-3)
                caps[node.id] = _cap(node, lead_rows)

            def step(tt, views, res, _l=lid, _r=rid, _lc=lcol, _rc=rcol,
                     _res=residual, _keep=keep_right, _cap=caps[node.id]):
                return E.join(res[_l], res[_r], _lc, _rc, _res, _keep, _cap,
                              use_kernels=use_kernels)

        elif node.kind == "project":
            idxs, dedupe = node.spec

            def step(tt, views, res, _c=node.child_ids[0], _idx=idxs,
                     _d=dedupe):
                return E.project(res[_c], _idx, _d)

        else:
            raise TypeError(node.kind)
        steps.append((step, node.child_ids, node.kind))

    roots = dict(dag.roots)

    def fn(tt, views):
        res: list[E.PRel] = []
        own: list[torch.Tensor] = []
        for run, child_ids, kind in steps:
            rel = run(tt, views, res)
            if kind == "view":
                # view buffers are packed at exact capacity by the
                # materializer; nothing here for the driver to grow
                own.append(torch.zeros((), dtype=torch.bool,
                                       device=rel.data.device))
            else:
                inherited = torch.zeros_like(rel.overflow)
                for c in child_ids:
                    inherited = inherited | res[c].overflow
                own.append(rel.overflow & ~inherited)
            res.append(rel)
        ovf = torch.stack(own) if own else torch.zeros((0,), dtype=torch.bool)
        return {name: res[nid] for name, nid in roots.items()}, ovf

    fn.caps = caps  # type: ignore[attr-defined]
    return fn


class WorkloadExecutor:
    """Adaptive driver around the fused workload program.

    `run` executes the whole workload; on capacity overflow it grows the
    offending buffers (bucketed mode: promotes the offending *buckets*
    to the next capacity class; unrolled mode: doubles the node's
    buffer), rebuilds what changed, and retries — up to `max_retries`
    recompiles, after which (or once a buffer hits the capacity ceiling)
    it raises.

    `carry_caps` seeds planning with capacities a previous executor
    learned (`learned_caps()`), keyed by DAG content key, so a rebuilt
    program — e.g. after a `swap_state` hot swap — starts from the
    healed capacities instead of re-learning every overflow.

    `device` (default: the card) is where the program's own constants
    live: the device of the TT indexes and views `run` is given.
    """

    def __init__(self, dag: WorkloadDAG, stats, view_infos, *,
                 device=None, safety: float = 4.0, use_kernels: bool = True,
                 max_retries: int = 12,
                 cap_planner: Callable[[object, float], int] | None = None,
                 mode: str = "bucketed",
                 carry_caps: dict | None = None,
                 fault_hook=None):
        if mode not in ("bucketed", "unrolled"):
            raise ValueError(f"unknown workload mode {mode!r}")
        # fault_hook: duck-typed chaos injector (`.fire(site)` raising an
        # injected fault when armed); None in production.  Sites fired
        # here: "compile" on program (re)construction, "device_call" and
        # "capacity_overflow" on each run.
        self.fault_hook = fault_hook
        self.dag = dag
        self.stats = stats
        self.view_infos = view_infos
        self.device = repro_torch.device(device)
        self.safety = safety
        self.use_kernels = use_kernels
        self.max_retries = max_retries
        self.cap_planner = cap_planner
        self.mode = mode
        self.carry_caps = dict(carry_caps or {})
        self.caps: list[int] | None = None
        # telemetry
        self.compiles = 0
        self.runs = 0
        self.recompiles = 0
        self.cap_history: dict[int, list[int]] = {}
        self._fn = None
        self._prog: BucketedProgram | None = None
        self._ests = None

    # ------------------------------------------------------------------
    # program construction
    # ------------------------------------------------------------------
    def _ensure_ests(self):
        if self._ests is None:
            self._ests = cost_mod.estimate_dag(self.dag, self.stats,
                                               self.view_infos)
        return self._ests

    def _fire(self, site: str) -> None:
        if self.fault_hook is not None:
            self.fault_hook.fire(site)

    def _compile(self) -> None:
        """Unrolled mode: (re)build the whole program."""
        self._fire("compile")
        fn = compile_workload(self.dag, self.stats, self.view_infos,
                              safety=self.safety, use_kernels=self.use_kernels,
                              caps=self.caps, cap_planner=self.cap_planner,
                              ests=self._ensure_ests())
        self.caps = fn.caps
        self._fn = fn
        self.compiles += 1

    def _program(self) -> BucketedProgram:
        if self._prog is None:
            self._fire("compile")
            self._prog = BucketedProgram(
                self.dag, self.stats, self.view_infos, device=self.device,
                safety=self.safety, use_kernels=self.use_kernels,
                cap_planner=self.cap_planner, ests=self._ensure_ests(),
                carry_caps=self.carry_caps)
            self.caps = self._prog.caps
            self.compiles += 1
        return self._prog

    # ------------------------------------------------------------------
    def run(self, tt, views) -> dict[str, E.PRel]:
        """Answer every workload member; returns {name: PRel}."""
        with trace.span("workload.run") as s:
            runs = self.runs
            self._fire("device_call")
            self._fire("capacity_overflow")
            if self.mode == "bucketed":
                roots = self._run_bucketed(tt, views)
            else:
                roots = self._run_unrolled(tt, views)
            s.set(attempts=self.runs - runs)
            return roots

    def _run_bucketed(self, tt, views) -> dict[str, E.PRel]:
        prog = self._program()
        attempt = 0
        while True:
            roots, own = prog.execute(tt, views)
            self.runs += 1
            if not own.any():
                return roots
            offending = np.nonzero(own)[0].tolist()
            if attempt >= self.max_retries:
                raise RuntimeError(
                    f"capacity overflow persists after {attempt} adaptive "
                    f"recompiles (nodes {offending}); estimates are "
                    f"pathologically low — raise max_retries or safety"
                )
            grown = prog.promote(offending)
            if not grown:
                raise RuntimeError(
                    f"capacity ceiling ({CAP_CEIL}) reached on nodes "
                    f"{offending}; result exceeds the engine's maximum "
                    f"buffer size"
                )
            for nid, old, new in grown:
                self.cap_history.setdefault(nid, [old]).append(new)
            self.compiles += 1
            self.recompiles += 1
            attempt += 1

    def _run_unrolled(self, tt, views) -> dict[str, E.PRel]:
        if self._fn is None:
            self._compile()
        attempt = 0
        while True:
            roots, own = self._fn(tt, views)
            self.runs += 1
            with trace.span("sync.flags") as s:
                own_np = own.cpu().numpy()
                s.set(bytes=own_np.nbytes)
            if not own_np.any():
                return roots
            offending = np.nonzero(own_np)[0].tolist()
            if attempt >= self.max_retries:
                raise RuntimeError(
                    f"capacity overflow persists after {attempt} adaptive "
                    f"recompiles (nodes {offending}); estimates are "
                    f"pathologically low — raise max_retries or safety"
                )
            grew = False
            for nid in offending:
                cur = self.caps[nid]
                new = min(max(cur * 2, 2), CAP_CEIL)
                if new > cur:
                    self.caps[nid] = new
                    self.cap_history.setdefault(nid, [cur]).append(new)
                    grew = True
            if not grew:
                raise RuntimeError(
                    f"capacity ceiling ({CAP_CEIL}) reached on nodes "
                    f"{offending}; result exceeds the engine's maximum "
                    f"buffer size"
                )
            self._compile()
            self.recompiles += 1
            attempt += 1

    # ------------------------------------------------------------------
    # static verification
    # ------------------------------------------------------------------
    def analyze(self, n_tt: int | None = None, view_caps=None):
        """Run the static analyzers (IR verifier, capacity analysis,
        body lint) over this executor's DAG and — in bucketed mode — its
        program, without executing anything.  Returns a
        `repro_torch.analysis.AnalysisReport`."""
        from repro_torch import analysis

        program = self._program() if self.mode == "bucketed" else None
        return analysis.analyze_workload(
            self.dag, self.stats, self.view_infos, program=program,
            n_tt=n_tt, view_caps=view_caps)

    # ------------------------------------------------------------------
    # capacity carry across program rebuilds
    # ------------------------------------------------------------------
    def learned_caps(self) -> dict:
        """Capacities grown by the adaptive driver, keyed by DAG content
        key (stable across DAG instances), merged over whatever this
        executor itself was seeded with — pass to a successor's
        `carry_caps=` so a hot-swapped program keeps the healed sizes."""
        out = dict(self.carry_caps)
        if self.cap_history and self.caps is not None:
            keys = self.dag.content_keys()
            for nid in self.cap_history:
                out[keys[nid]] = max(out.get(keys[nid], 0), self.caps[nid])
        return out

    # ------------------------------------------------------------------
    def warmup(self, tt, views) -> dict[str, E.PRel]:
        """Pre-warm the serving path: build every bucket body and heal any
        planning overflows by running the workload once.  Returns the
        roots so callers can seed their result caches."""
        return self.run(tt, views)

    # ------------------------------------------------------------------
    def telemetry(self) -> dict:
        t = dict(self.dag.stats())
        t.update(compiles=self.compiles, runs=self.runs,
                 recompiles=self.recompiles,
                 grown_nodes=sorted(self.cap_history),
                 mode=self.mode)
        # bucket/compile-cache telemetry (zeros on the unrolled path so
        # consumers can rely on the keys being present)
        t.update(buckets=0, bucket_signatures=0, bucket_compiles=0,
                 bucket_cache_hits=0, bucket_cache_misses=0,
                 bucket_compile_seconds=0.0,
                 bucket_compile_log=[], bucket_promotions=0)
        if self._prog is not None:
            t.update(self._prog.telemetry())
        t["compile_cache"] = compile_cache().stats()
        return t
