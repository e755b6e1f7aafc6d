"""The system under test: `repro_torch`, set up and driven as users do.

Set-up makes the data set from the seed and loads it as the
configuration's `load` says (`rdfs_closure`: the triples and what the
schema entails from them, made by forward chaining; `explicit`: the
triples alone), hands the port those triples, a dictionary of the
schema's names, the schema and the configuration's queries, and times
each step: the port builds its `TripleStore`,
tunes (`retune()`), materializes and warms its views (`apply()`).  The
two request paths are the port's own entries:

- the fused workload program, `QueryExecutor.workload.run(tt, views)`
  (what `answer_workload` caches, without the cache), every member's
  rows brought to the host with `engine.to_numpy`;
- the per-query path, `QueryExecutor.answer_per_query(member)` for each
  member of a group.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from rdfbench import trace
from rdfbench import data as datasets


@dataclass
class Program:
    session: object
    groups: dict[str, list[str]]
    triples: np.ndarray     # the data set as made, for the reference
    consts: dict
    steps: dict[str, float] = field(default_factory=dict)
    tuning: dict = field(default_factory=dict)
    traced: bool = False
    # host seconds of each fused run's two parts: the workload driver,
    # then the copies to the host
    split: list = field(default_factory=list)

    @property
    def executor(self):
        return self.session.executor

    def _span(self, name: str):
        if not self.traced:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def tracing(self):
        """Spans around the calls into the port while traced."""
        self.traced = True
        try:
            yield
        finally:
            self.traced = False

    def run_workload(self) -> dict[str, np.ndarray]:
        """One request of the fused program: every member's rows."""
        from repro_torch.query import engine
        ex = self.executor
        t0 = time.perf_counter()
        with self._span(trace.WORKLOAD_RUN):
            roots = ex.workload.run(ex.tt, ex.device_views)
        t1 = time.perf_counter()
        with self._span(trace.WORKLOAD_COPY):
            rows = {m: engine.to_numpy(rel) for m, rel in roots.items()}
        self.split.append((t1 - t0, time.perf_counter() - t1))
        return rows

    def run_group(self, group: str) -> dict[str, np.ndarray]:
        """One request of the per-query path: the group's members' rows."""
        ex = self.executor
        out = {}
        for m in self.groups[group]:
            with self._span(trace.QUERY_MEMBER):
                out[m] = ex.answer_per_query(m)
        return out

    def telemetry(self) -> dict:
        t = self.executor.telemetry()
        return {k: t[k] for k in ("runs", "compiles", "recompiles",
                                  "bucket_compiles", "oracle_fallbacks")}


def _term(t: str, names: dict, consts: dict):
    from repro_torch.core.queries import Const, Var
    if t.startswith("?"):
        return Var(t[1:])
    if t.startswith("<"):
        return Const(consts[t[1:-1]])
    return Const(names[t])


def port_inputs(config: dict, data, consts: dict):
    """The dictionary of the schema's names, the schema and the
    configuration's queries, in the port's own types."""
    from repro_torch.core.queries import CQ, Atom
    from repro_torch.rdf.dictionary import Dictionary
    from repro_torch.rdf.schema import RDFSchema

    d = Dictionary()
    for name in data.NAMES:
        d.encode(name)
    if {n: d.lookup(n) for n in data.NAMES} != data.NAMES:
        raise RuntimeError("the port's dictionary differs from the data "
                           "maker's ids")
    schema = RDFSchema()
    for child, parent in data.SUBCLASS:
        schema.add_subclass(d.lookup(child), d.lookup(parent))
    for child, parent in data.SUBPROP:
        schema.add_subprop(d.lookup(child), d.lookup(parent))
    for prop, (dom, rng) in data.PROPS.items():
        if dom:
            schema.set_domain(d.lookup(prop), d.lookup(dom))
        if rng:
            schema.set_range(d.lookup(prop), d.lookup(rng))
    workload = []
    for name, (head, atoms) in config["queries"].items():
        workload.append(CQ(
            tuple(_term(v, data.NAMES, consts) for v in head),
            tuple(Atom(*(_term(t, data.NAMES, consts) for t in a))
                  for a in atoms),
            name=name, weight=float(config["weights"][name])))
    return d, schema, workload


def views_digest(state, consts: dict) -> str:
    """A hash of the chosen views, with the ids of the entities the
    queries name written as those names (their ids differ by seed)."""
    named = {v: k for k, v in consts.items()}

    def name(x):
        if isinstance(x, tuple):
            return tuple(name(y) for y in x)
        return named.get(x, x) if isinstance(x, int) else x

    keys = sorted(repr(name(v.cq.canonical_key()))
                  for v in state.views.values())
    return hashlib.sha256("\n".join(keys).encode()).hexdigest()[:16]


def _sync(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize()


def set_up(config: dict, seed: int, device: str, log) -> Program:
    """Make the data from the seed and bring the port to serving."""
    import repro_torch
    from repro_torch.api import TuningSession
    from repro_torch.core.search import SearchConfig
    from repro_torch.core.wizard import WizardConfig
    from repro_torch.rdf.triples import TripleStore

    steps: dict[str, float] = {}
    t0 = time.perf_counter()
    data = datasets.module(config)
    triples, consts = data.make(int(config["universities"]), seed)
    if config["load"] == "rdfs_closure":
        loaded = data.saturate(triples)
    elif config["load"] == "explicit":
        loaded = triples
    else:
        raise ValueError(f"no load {config['load']!r}")
    d, schema, workload = port_inputs(config, data, consts)
    steps["data_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    store = TripleStore(loaded, d)
    del loaded
    steps["store.build_s"] = time.perf_counter() - t0

    search = SearchConfig(**config["search"])
    cfg = WizardConfig(search=search, **config.get("wizard", {}))
    session = TuningSession(store, workload, schema=schema,
                            type_id=data.NAMES[data.RDF_TYPE], cfg=cfg,
                            device=device)
    t0 = time.perf_counter()
    rep = session.retune()
    steps["retune_s"] = time.perf_counter() - t0
    res = rep.result
    if res.explored >= search.max_states or res.elapsed_s >= search.max_seconds:
        raise RuntimeError(
            f"the search stopped on its budget, not on its own: explored "
            f"{res.explored} of max_states {search.max_states} in "
            f"{res.elapsed_s:.1f} s of max_seconds {search.max_seconds}")
    tuning = {"states": res.explored, "views": len(res.best.views),
              "views_sha256": views_digest(res.best, consts)}
    log(f"tuning: {tuning['states']} states explored, {tuning['views']} "
        f"views, views sha256 {tuning['views_sha256']}; {res.summary()}")

    t0 = time.perf_counter()
    session.apply()
    _sync(repro_torch.device(device))
    steps["session.apply_s"] = time.perf_counter() - t0
    groups = {q.name: list(session.groups[q.name]) for q in workload}
    tuning["members"] = sum(len(m) for m in groups.values())
    # the buffer sizes the program planned from this store's statistics:
    # seeds that give other sizes give the program other work
    caps = list(session.executor.workload.caps or [])
    views = sorted(int(r.data.shape[0])
                   for r in session.executor.device_views.values())
    tuning["buffers"] = {"caps_sum": sum(caps), "view_rows_sum": sum(views),
                         "sha256": hashlib.sha256(
                             repr((caps, views)).encode()).hexdigest()[:16]}
    log(f"buffers: {json.dumps(tuning['buffers'])}")
    return Program(session=session, groups=groups, triples=triples,
                   consts=consts, steps=steps, tuning=tuning)


def warm_up(prog: Program, mix: dict, device: str) -> None:
    """Run every shape the mix will use: the fused program, or each
    member's operator tree, twice."""
    import repro_torch

    t0 = time.perf_counter()
    for _ in range(2):
        if mix["request"] == "workload":
            prog.run_workload()
            continue
        for g in prog.groups:
            try:
                prog.run_group(g)
            except RuntimeError as e:   # the window counts it as failed
                print(f"[rdfbench] warm-up of {g} failed: {e}",
                      file=sys.stderr, flush=True)
    _sync(repro_torch.device(device))
    prog.steps["warmup_s"] = time.perf_counter() - t0
