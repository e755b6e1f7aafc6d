"""Open-loop traffic generation for the serving frontend.

Open-loop means arrivals do NOT wait for completions: the schedule is a
seeded Poisson process per the offered rate, so when the server falls
behind, the queue grows and admission control has to act — exactly the
regime a closed-loop (request-after-response) generator can never
produce.  Everything is virtual-clock: the schedule is a sorted list of
(time, event) pairs generated up front from one `numpy` PRNG, and
`run_open_loop` replays it through `ServingFrontend.offer /
submit_update`.  Same seed, same config -> bit-identical traffic and
bit-identical frontend decisions.

The update-stream component interleaves triple-delta batches with query
arrivals, so maintenance backpressure (the server draining its update
backlog inside a dispatch) shows up in the measured serving latency.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.errors import require
from repro_torch.serve.frontend import ServingFrontend


@dataclass(frozen=True)
class ClassSpec:
    """One traffic class: its share of arrivals, its priority/SLO, and
    the query-name population it draws from (uniformly)."""

    name: str
    weight: float
    queries: tuple[str, ...]
    priority: int = 0
    slo: float | None = None

    def __post_init__(self):
        require(self.weight > 0, f"class {self.name!r}: weight must be > 0")
        require(len(self.queries) > 0,
                f"class {self.name!r}: needs at least one query")


@dataclass(frozen=True)
class TrafficConfig:
    rate: float                   # offered queries/second (virtual)
    duration: float               # virtual seconds of arrivals
    classes: tuple[ClassSpec, ...]
    seed: int = 0
    update_rate: float = 0.0      # update batches/second (virtual)
    update_size: int = 0          # triples per update batch

    def __post_init__(self):
        require(self.rate > 0, "rate must be > 0")
        require(self.duration > 0, "duration must be > 0")
        require(len(self.classes) > 0, "need at least one traffic class")


@dataclass(frozen=True)
class Arrival:
    t: float
    kind: str                     # "query" | "update"
    cls: str = ""
    name: str = ""


def generate_schedule(cfg: TrafficConfig) -> list[Arrival]:
    """Materialize the full arrival schedule: Poisson query arrivals
    (exponential inter-arrival gaps at `rate`), weighted class choice,
    uniform query choice within the class, plus an independent Poisson
    update stream; merged and time-sorted.  Pure function of `cfg`."""
    rng = np.random.default_rng(cfg.seed)
    out: list[Arrival] = []

    names = [c.name for c in cfg.classes]
    w = np.asarray([c.weight for c in cfg.classes], dtype=np.float64)
    w = w / w.sum()
    by_name = {c.name: c for c in cfg.classes}

    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / cfg.rate))
        if t >= cfg.duration:
            break
        cls = names[int(rng.choice(len(names), p=w))]
        spec = by_name[cls]
        q = spec.queries[int(rng.integers(len(spec.queries)))]
        out.append(Arrival(t=t, kind="query", cls=cls, name=q))

    if cfg.update_rate > 0 and cfg.update_size > 0:
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / cfg.update_rate))
            if t >= cfg.duration:
                break
            out.append(Arrival(t=t, kind="update"))

    out.sort(key=lambda a: (a.t, a.kind))
    return out


@dataclass
class ClassReport:
    offered: int = 0
    admitted: int = 0
    shed: int = 0
    downgraded: int = 0
    p50: float = 0.0
    p99: float = 0.0
    mean: float = 0.0
    throughput: float = 0.0       # completions / virtual second
    slo: float | None = None
    slo_met: bool | None = None   # None when the class has no SLO

    def as_dict(self) -> dict:
        return dict(self.__dict__)


@dataclass
class TrafficReport:
    duration: float               # virtual seconds incl. drain
    offered_rate: float
    completed: int = 0
    shed_rate: float = 0.0
    throughput: float = 0.0
    batches: int = 0
    batch_occupancy: float = 0.0
    max_queue_depth: int = 0
    per_class: dict = field(default_factory=dict)  # name -> ClassReport

    def as_dict(self) -> dict:
        d = dict(self.__dict__)
        d["per_class"] = {k: v.as_dict() for k, v in self.per_class.items()}
        return d


def run_open_loop(frontend: ServingFrontend, cfg: TrafficConfig,
                  update_fn=None) -> TrafficReport:
    """Replay `cfg`'s schedule through the frontend, flush, and report.

    `update_fn(rng) -> (inserts, deletes)` supplies each update batch's
    triples (seeded off `cfg.seed + 1` so query arrivals are unchanged
    whether or not updates flow).  Without it, update events are
    skipped."""
    schedule = generate_schedule(cfg)
    upd_rng = np.random.default_rng(cfg.seed + 1)
    for a in schedule:
        if a.kind == "query":
            frontend.offer(a.name, a.cls, t=a.t)
        elif update_fn is not None:
            ins, dels = update_fn(upd_rng)
            frontend.submit_update(inserts=ins, deletes=dels, t=a.t)
    end = frontend.flush()
    return summarize(frontend, cfg, end)


def summarize(frontend: ServingFrontend, cfg: TrafficConfig,
              end_time: float) -> TrafficReport:
    st = frontend.stats
    dur = max(end_time, cfg.duration)
    rep = TrafficReport(
        duration=dur, offered_rate=cfg.rate,
        completed=st.completed,
        shed_rate=st.shed / st.offered if st.offered else 0.0,
        throughput=st.completed / dur if dur > 0 else 0.0,
        batches=st.batches, batch_occupancy=st.batch_occupancy,
        max_queue_depth=st.max_queue_depth)
    for spec in cfg.classes:
        rec = st.latency.get(spec.name)
        cr = ClassReport(
            offered=st.offered_by_class.get(spec.name, 0),
            shed=st.shed_by_class.get(spec.name, 0),
            downgraded=st.downgraded_by_class.get(spec.name, 0),
            slo=spec.slo)
        cr.admitted = cr.offered - cr.shed
        if rec is not None and rec.count:
            cr.p50 = rec.percentile(50)
            cr.p99 = rec.percentile(99)
            cr.mean = rec.mean
            cr.throughput = rec.count / dur if dur > 0 else 0.0
            if spec.slo is not None:
                cr.slo_met = cr.p99 <= spec.slo
        elif spec.slo is not None:
            # nothing completed in this class; SLO trivially unmet
            # only if requests were offered and all shed/downgraded
            cr.slo_met = cr.offered == 0
        rep.per_class[spec.name] = cr
    return rep
