"""JSON (de)serialization of the symbolic tuning state.

A copy of the encoders of `repro/api/serde.py`: the two packages read
and write the same JSON, so a state tuned by either can be carried into
the other (`api/convert.py`), and a session saved by either loads in the
other (`TuningSession.save` / `load`).  Encodings are tagged
dicts/lists; the invariant is `X_from_json(X_to_json(x)) == x` for every
CQ/Plan/State.

The wizard config keeps the JAX package's key `use_pallas` for the
port's `WizardConfig.use_kernels`: both switch the join probes between
the hand-written kernel and the plain operators, so a `session.json`
round-trips between the packages with its config unchanged.
"""
from __future__ import annotations

from repro_torch.core.quality import QualityWeights
from repro_torch.core.queries import CQ, Atom, Const, Term, Var
from repro_torch.core.search import SearchConfig
from repro_torch.core.state import State, View
from repro_torch.core.wizard import WizardConfig
from repro_torch.query.plan import (EquiJoin, Filter, Plan, Project, TTScan,
                                    ViewRef)
from repro_torch.rdf.schema import RDFSchema


# ----------------------------------------------------------------------
# terms / atoms / CQs
# ----------------------------------------------------------------------
def term_to_json(t: Term):
    return {"v": t.name} if isinstance(t, Var) else {"c": t.id}


def term_from_json(d) -> Term:
    return Var(d["v"]) if "v" in d else Const(int(d["c"]))


def cq_to_json(q: CQ) -> dict:
    return {
        "head": [h.name for h in q.head],
        "atoms": [[term_to_json(t) for t in a.terms()] for a in q.atoms],
        "name": q.name,
        "weight": q.weight,
    }


def cq_from_json(d: dict) -> CQ:
    return CQ(
        head=tuple(Var(n) for n in d["head"]),
        atoms=tuple(Atom(*(term_from_json(t) for t in a)) for a in d["atoms"]),
        name=d["name"],
        weight=float(d["weight"]),
    )


# ----------------------------------------------------------------------
# rewriting plans
# ----------------------------------------------------------------------
def plan_to_json(p: Plan) -> dict:
    if isinstance(p, ViewRef):
        return {"op": "view", "vid": p.view_id, "schema": list(p.schema)}
    if isinstance(p, TTScan):
        return {"op": "tt", "atom": [term_to_json(t) for t in p.atom.terms()]}
    if isinstance(p, Filter):
        return {"op": "filter", "child": plan_to_json(p.child),
                "col": p.col, "value": p.value}
    if isinstance(p, EquiJoin):
        return {"op": "join", "left": plan_to_json(p.left),
                "right": plan_to_json(p.right),
                "pairs": [list(pr) for pr in p.pairs]}
    if isinstance(p, Project):
        return {"op": "project", "child": plan_to_json(p.child),
                "cols": list(p.cols), "dedupe": p.dedupe}
    raise TypeError(type(p))


def plan_from_json(d: dict) -> Plan:
    op = d["op"]
    if op == "view":
        return ViewRef(int(d["vid"]), tuple(d["schema"]))
    if op == "tt":
        return TTScan(Atom(*(term_from_json(t) for t in d["atom"])))
    if op == "filter":
        return Filter(plan_from_json(d["child"]), d["col"], int(d["value"]))
    if op == "join":
        return EquiJoin(plan_from_json(d["left"]), plan_from_json(d["right"]),
                        tuple((l, r) for l, r in d["pairs"]))
    if op == "project":
        return Project(plan_from_json(d["child"]), tuple(d["cols"]),
                       bool(d["dedupe"]))
    raise ValueError(f"unknown plan op {op!r}")


# ----------------------------------------------------------------------
# search states
# ----------------------------------------------------------------------
def state_to_json(s: State) -> dict:
    return {
        "views": {str(vid): cq_to_json(v.cq) for vid, v in s.views.items()},
        "rewritings": {n: plan_to_json(p) for n, p in s.rewritings.items()},
        "queries": [cq_to_json(q) for q in s.queries],
        "next_view_id": s.next_view_id,
        "next_fresh": s.next_fresh,
        "path": list(s.path),
    }


def state_from_json(d: dict) -> State:
    views = {int(k): View(id=int(k), cq=cq_from_json(v))
             for k, v in d["views"].items()}
    return State(
        views=views,
        rewritings={n: plan_from_json(p) for n, p in d["rewritings"].items()},
        queries=tuple(cq_from_json(q) for q in d["queries"]),
        next_view_id=int(d["next_view_id"]),
        next_fresh=int(d["next_fresh"]),
        path=tuple(d["path"]),
    )


# ----------------------------------------------------------------------
# wizard / search configuration
# ----------------------------------------------------------------------
def cfg_to_json(cfg: WizardConfig) -> dict:
    s, w = cfg.search, cfg.search.weights
    return {
        "use_schema": cfg.use_schema,
        "max_reformulations": cfg.max_reformulations,
        "use_pallas": cfg.use_kernels,
        # SearchConfig.initial (a State) is session-transient by design:
        # the session re-seeds every retune from its restored best
        "search": {
            "strategy": s.strategy, "max_states": s.max_states,
            "max_seconds": s.max_seconds, "beam_width": s.beam_width,
            "anneal_steps": s.anneal_steps, "anneal_t0": s.anneal_t0,
            "anneal_decay": s.anneal_decay, "seed": s.seed,
            "allow_predicate_cut": s.allow_predicate_cut,
            "stop_fully_relaxed": s.stop_fully_relaxed,
        },
        "weights": {"w_exec": w.w_exec, "w_maint": w.w_maint,
                    "w_space": w.w_space, "update_rate": w.update_rate},
    }


def cfg_from_json(d: dict) -> WizardConfig:
    weights = QualityWeights(**d["weights"])
    return WizardConfig(
        search=SearchConfig(weights=weights, **d["search"]),
        use_schema=d["use_schema"],
        max_reformulations=d["max_reformulations"],
        use_kernels=d["use_pallas"],
    )


# ----------------------------------------------------------------------
# RDFS schema
# ----------------------------------------------------------------------
def schema_to_json(s: RDFSchema) -> dict:
    return {
        "subclass": {str(c): sorted(ps) for c, ps in s.subclass.items()},
        "subprop": {str(c): sorted(ps) for c, ps in s.subprop.items()},
        "domain": {str(p): c for p, c in s.domain.items()},
        "range": {str(p): c for p, c in s.range_.items()},
    }


def schema_from_json(d: dict) -> RDFSchema:
    return RDFSchema(
        subclass={int(c): set(ps) for c, ps in d["subclass"].items()},
        subprop={int(c): set(ps) for c, ps in d["subprop"].items()},
        domain={int(p): int(c) for p, c in d["domain"].items()},
        range_={int(p): int(c) for p, c in d["range"].items()},
    )
