"""Async serving frontend: bounded queue, micro-batches, admission control.

`ServingFrontend` sits in front of a batched query server (a
`repro_torch.serve.query_server.QueryServer`, a
`repro_torch.serve.sharded.ShardedBackend`, or anything exposing
`answer_batch(names)`) and turns
per-request traffic into the micro-batches the fused device program is
built for:

  * requests enter a BOUNDED queue (`queue_cap`); the queue never grows
    without limit — when full, admission control decides who is shed;
  * a micro-batch dispatches when the queue reaches `max_batch` or the
    oldest admitted request has waited `batching_window`, whichever
    first, and the server is free (one batch in flight at a time — the
    backing executor answers a whole batch in one device call);
  * dispatch order is priority-major (higher `QueryClass.priority`
    first, FIFO within a class), so the top class rides the front of
    every batch;
  * admission control (`admission="shed"|"downgrade"`) protects
    per-class latency SLOs: a request whose estimated completion would
    breach its class budget is shed at the door — or downgraded to the
    best-effort class — instead of poisoning the queue for everyone
    behind it.  With `admission="none"` the frontend only enforces the
    hard queue bound.

Everything runs on a VIRTUAL CLOCK: arrivals carry virtual timestamps,
batch service costs virtual seconds from a pluggable service model, and
no code path reads wall time unless you opt into `MeasuredServiceModel`
(benchmarks only).  Tests and the load generator replay bit-identically
under a fixed seed.

Telemetry — queue depth, batch occupancy, shed/downgrade counters and
per-class latency recorders — lives in `FrontendStats`, is mirrored
into the backing server's `ServeStats.frontend`, and is surfaced by
`readiness()` alongside the server's own health probe.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from repro_torch.errors import InvariantViolation, require

BEST_EFFORT = "best_effort"
_EPS = 1e-12

# log2-spaced latency histogram bucket edges (virtual seconds): 0.1 ms
# up to ~7 min, plus an overflow bucket.  Fixed size — telemetry never
# grows with traffic.
HIST_EDGES: tuple[float, ...] = tuple(1e-4 * (2.0 ** i) for i in range(22))


class VirtualClock:
    """Deterministic monotone clock in virtual seconds."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance_to(self, t: float) -> float:
        if t < self._now - _EPS:
            raise InvariantViolation(
                f"virtual clock cannot run backwards: {t} < {self._now}")
        self._now = max(self._now, float(t))
        return self._now

    def advance(self, dt: float) -> float:
        return self.advance_to(self._now + float(dt))


@dataclass(frozen=True)
class QueryClass:
    """One traffic class: a priority tier and an optional latency SLO
    (virtual seconds, arrival to completion)."""

    name: str
    priority: int = 0           # higher dispatches first
    slo: float | None = None    # None: best effort, never shed on SLO

    def __post_init__(self):
        require(bool(self.name), "query class needs a name")
        require(self.slo is None or self.slo > 0, "slo must be positive")


@dataclass(frozen=True)
class FrontendConfig:
    queue_cap: int = 64           # hard bound on admitted-but-undispatched
    batching_window: float = 0.005  # max wait before a partial batch goes
    max_batch: int = 16           # requests per dispatch
    admission: str = "shed"       # "shed" | "downgrade" | "none"
    slo_margin: float = 1.0       # admit while est. latency <= margin*slo
    priority_dispatch: bool = True  # False: plain FIFO (baseline mode)
    latency_reservoir: int = 65536  # exact-quantile samples kept per class

    def __post_init__(self):
        require(self.queue_cap >= 1, "queue_cap must be >= 1")
        require(self.max_batch >= 1, "max_batch must be >= 1")
        require(self.batching_window >= 0.0, "batching_window must be >= 0")
        require(self.admission in ("shed", "downgrade", "none"),
                f"admission must be shed|downgrade|none, "
                f"got {self.admission!r}")


@dataclass
class Request:
    rid: int
    name: str                   # workload query name
    cls: str                    # serving class (after any downgrade)
    orig_cls: str               # class at the door
    priority: int
    slo: float | None
    arrival: float
    downgraded: bool = False
    dispatch: float | None = None
    finish: float | None = None


class LatencyRecorder:
    """Per-class latency telemetry: a bounded sample reservoir (exact
    quantiles while under `cap`; overflow counted, never grown) plus a
    fixed log-bucketed histogram."""

    def __init__(self, cap: int = 65536):
        self.cap = cap
        self.samples: list[float] = []
        self.overflowed = 0         # samples beyond the reservoir cap
        self.hist = [0] * (len(HIST_EDGES) + 1)
        self.count = 0
        self.total = 0.0
        self.worst = 0.0

    def record(self, latency: float) -> None:
        self.count += 1
        self.total += latency
        self.worst = max(self.worst, latency)
        self.hist[bisect.bisect_right(HIST_EDGES, latency)] += 1
        if len(self.samples) < self.cap:
            self.samples.append(latency)
        else:
            self.overflowed += 1

    def percentile(self, q: float) -> float:
        """Exact sample quantile (nearest-rank) over the reservoir."""
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        rank = min(len(s) - 1, max(0, int(round(q / 100.0 * len(s))) - 1))
        return s[rank]

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> dict:
        return {"count": self.count, "mean": self.mean,
                "p50": self.percentile(50), "p99": self.percentile(99),
                "max": self.worst, "hist": list(self.hist),
                "overflowed": self.overflowed}


# ----------------------------------------------------------------------
# service-time models
# ----------------------------------------------------------------------
class FixedServiceModel:
    """Deterministic virtual batch service time: affine in batch size
    plus a per-maintained-triple surcharge (so an update backlog drained
    inside a dispatch stretches that batch's service — maintenance
    backpressure shows up in serving latency)."""

    def __init__(self, batch_base: float = 0.002,
                 per_request: float = 0.0005,
                 per_maint_triple: float = 0.0):
        self.batch_base = batch_base
        self.per_request = per_request
        self.per_maint_triple = per_maint_triple

    def __call__(self, names, wall_seconds: float,
                 maint_triples: int) -> float:
        return (self.batch_base + self.per_request * len(names)
                + self.per_maint_triple * maint_triples)

    def estimate(self, n: int) -> float:
        """Prior service estimate for an n-request batch."""
        return self.batch_base + self.per_request * n


class MeasuredServiceModel:
    """Charge the measured wall time of the real dispatch to the virtual
    clock (benchmark realism).  NOT for tests: wall time is
    nondeterministic by nature."""

    def __init__(self, scale: float = 1.0):
        self.scale = scale

    def __call__(self, names, wall_seconds: float,
                 maint_triples: int) -> float:
        return wall_seconds * self.scale

    def estimate(self, n: int) -> float | None:
        return None             # no prior; the EWMA learns from batches


@dataclass
class FrontendStats:
    offered: int = 0
    admitted: int = 0
    shed: int = 0               # at the door + evicted from a full queue
    evicted: int = 0            # subset of shed: displaced by priority
    downgraded: int = 0
    completed: int = 0
    batches: int = 0
    batch_occupancy_sum: int = 0
    queue_depth: int = 0        # right now
    max_queue_depth: int = 0
    updates_submitted: int = 0
    offered_by_class: dict = field(default_factory=dict)
    shed_by_class: dict = field(default_factory=dict)
    downgraded_by_class: dict = field(default_factory=dict)
    latency: dict = field(default_factory=dict)  # cls -> LatencyRecorder

    @property
    def batch_occupancy(self) -> float:
        return self.batch_occupancy_sum / self.batches if self.batches else 0.0

    def summary(self) -> dict:
        return {
            "offered": self.offered, "admitted": self.admitted,
            "shed": self.shed, "evicted": self.evicted,
            "downgraded": self.downgraded, "completed": self.completed,
            "batches": self.batches, "batch_occupancy": self.batch_occupancy,
            "queue_depth": self.queue_depth,
            "max_queue_depth": self.max_queue_depth,
            "shed_by_class": dict(self.shed_by_class),
            "downgraded_by_class": dict(self.downgraded_by_class),
            "latency": {c: r.summary() for c, r in self.latency.items()},
        }


class ServingFrontend:
    """Virtual-clock micro-batching frontend over a batched server.

    MAX_BATCH_LOG pins how many (dispatch_time, size) entries the batch
    log keeps — telemetry stays bounded no matter how long the frontend
    runs.
    """

    MAX_BATCH_LOG = 1024

    def __init__(self, server, classes, cfg: FrontendConfig | None = None,
                 clock: VirtualClock | None = None, service_model=None):
        self.server = server
        self.cfg = cfg or FrontendConfig()
        self.clock = clock or VirtualClock()
        self.service_model = service_model or FixedServiceModel()
        self.classes: dict[str, QueryClass] = {}
        for c in classes:
            require(c.name not in self.classes,
                    f"duplicate query class {c.name!r}")
            self.classes[c.name] = c
        require(bool(self.classes), "frontend needs at least one class")
        if self.cfg.admission == "downgrade" and BEST_EFFORT not in self.classes:
            floor = min(c.priority for c in self.classes.values())
            self.classes[BEST_EFFORT] = QueryClass(
                BEST_EFFORT, priority=floor - 1, slo=None)
        self.stats = FrontendStats()
        for name in self.classes:
            self.stats.latency[name] = LatencyRecorder(
                self.cfg.latency_reservoir)
        self._queue: list[Request] = []     # bounded: len() < cfg.queue_cap
        self._inflight: list[Request] | None = None
        self._busy_until = self.clock.now()
        self._service_ewma: float | None = None
        self._rid = 0
        self.batch_log: list[tuple[float, int]] = []

    # ------------------------------------------------------------------
    # request admission
    # ------------------------------------------------------------------
    def offer(self, name: str, cls: str | None = None,
              t: float | None = None) -> bool:
        """Offer one request at virtual time `t` (default: now).
        Returns True when admitted (possibly downgraded), False when
        shed by admission control or the queue bound."""
        if t is not None:
            self.advance_to(t)
        else:
            self._pump()
        if cls is None:
            if len(self.classes) != 1:
                raise ValueError("cls is required with multiple classes")
            cls = next(iter(self.classes))
        qc = self.classes.get(cls)
        if qc is None:
            raise KeyError(f"unknown query class {cls!r}")
        self.stats.offered += 1
        self.stats.offered_by_class[cls] = \
            self.stats.offered_by_class.get(cls, 0) + 1
        r = Request(rid=self._rid, name=name, cls=cls, orig_cls=cls,
                    priority=qc.priority, slo=qc.slo,
                    arrival=self.clock.now())
        self._rid += 1

        # SLO admission: would this request blow its own budget?
        if (self.cfg.admission != "none" and r.slo is not None
                and self._est_latency(r) > self.cfg.slo_margin * r.slo):
            if self.cfg.admission == "downgrade":
                be = self.classes[BEST_EFFORT]
                r.cls, r.priority, r.slo = be.name, be.priority, be.slo
                r.downgraded = True
                self.stats.downgraded += 1
                self.stats.downgraded_by_class[cls] = \
                    self.stats.downgraded_by_class.get(cls, 0) + 1
            else:
                self._shed(r)
                return False

        # hard queue bound: shed the incoming request, or — under
        # admission control — displace a strictly lower-priority one
        if len(self._queue) >= self.cfg.queue_cap:
            victim = None
            if self.cfg.admission != "none" and self.cfg.priority_dispatch:
                low = min(self._queue, key=lambda q: (q.priority, -q.arrival))
                if low.priority < r.priority:
                    victim = low
            if victim is None:
                self._shed(r)
                return False
            self._queue.remove(victim)
            self.stats.evicted += 1
            self._shed(victim, already_admitted=True)
        self._queue.append(r)
        self.stats.admitted += 1
        self.stats.queue_depth = len(self._queue)
        self.stats.max_queue_depth = max(self.stats.max_queue_depth,
                                         len(self._queue))
        self._pump()
        return True

    def _shed(self, r: Request, already_admitted: bool = False) -> None:
        self.stats.shed += 1
        self.stats.shed_by_class[r.orig_cls] = \
            self.stats.shed_by_class.get(r.orig_cls, 0) + 1
        if already_admitted:
            self.stats.admitted -= 1
        self.stats.queue_depth = len(self._queue)

    # ------------------------------------------------------------------
    # latency estimation (admission control's crystal ball)
    # ------------------------------------------------------------------
    def _service_est(self) -> float:
        if self._service_ewma is not None:
            return self._service_ewma
        prior = None
        est = getattr(self.service_model, "estimate", None)
        if est is not None:
            prior = est(self.cfg.max_batch)
        return prior if prior is not None else self.cfg.batching_window

    def _est_latency(self, r: Request) -> float:
        """Estimated arrival-to-completion latency for an incoming
        request: remaining in-flight service, plus one batch service per
        `max_batch` queued requests that would dispatch before or with
        it (only same-or-higher priority when priority dispatch is on),
        plus the batching window it may spend waiting to fill."""
        s = self._service_est()
        if self.cfg.priority_dispatch:
            ahead = sum(1 for q in self._queue if q.priority >= r.priority)
        else:
            ahead = len(self._queue)
        batches = ahead // self.cfg.max_batch + 1  # incl. its own batch
        busy = max(self._busy_until - self.clock.now(), 0.0)
        return busy + batches * s + self.cfg.batching_window

    # ------------------------------------------------------------------
    # virtual-time machinery
    # ------------------------------------------------------------------
    def _next_event(self) -> float | None:
        if self._inflight is not None:
            return self._busy_until
        if self._queue:
            if len(self._queue) >= min(self.cfg.max_batch,
                                       self.cfg.queue_cap):
                return self.clock.now()
            oldest = min(q.arrival for q in self._queue)
            return oldest + self.cfg.batching_window
        return None

    def _on_event(self) -> None:
        now = self.clock.now()
        if self._inflight is not None and now >= self._busy_until - _EPS:
            self._complete_inflight()
        if self._inflight is None and self._queue:
            # a batch-full OR cap-full queue dispatches immediately (the
            # cap means it cannot grow, so waiting out the window would
            # only add latency) — must mirror _next_event's readiness
            # condition exactly or the event pump spins
            full = len(self._queue) >= min(self.cfg.max_batch,
                                           self.cfg.queue_cap)
            oldest = min(q.arrival for q in self._queue)
            if full or now - oldest >= self.cfg.batching_window - _EPS:
                self._dispatch()

    def _pump(self) -> None:
        """Process every event due at or before the current time."""
        while True:
            ev = self._next_event()
            if ev is None or ev > self.clock.now() + _EPS:
                return
            before = (len(self._queue), self.stats.batches,
                      self.stats.completed)
            self._on_event()
            if before == (len(self._queue), self.stats.batches,
                          self.stats.completed):
                raise InvariantViolation(
                    "frontend event pump made no progress — "
                    "_next_event/_on_event readiness conditions diverged")

    def advance_to(self, t: float) -> None:
        """Advance virtual time to `t`, firing dispatches/completions in
        order along the way."""
        while True:
            ev = self._next_event()
            if ev is None or ev > t + _EPS:
                break
            self.clock.advance_to(max(ev, self.clock.now()))
            self._on_event()
        self.clock.advance_to(t)

    def flush(self) -> float:
        """Drain: run virtual time forward until the queue is empty and
        nothing is in flight.  Returns the final virtual time."""
        while self._queue or self._inflight is not None:
            ev = self._next_event()
            if ev is None:
                break
            self.clock.advance_to(max(ev, self.clock.now()))
            self._on_event()
        return self.clock.now()

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------
    def _take_batch(self) -> list[Request]:
        if self.cfg.priority_dispatch:
            order = sorted(self._queue,
                           key=lambda q: (-q.priority, q.arrival, q.rid))
        else:
            order = sorted(self._queue, key=lambda q: (q.arrival, q.rid))
        batch = order[: self.cfg.max_batch]
        taken = {q.rid for q in batch}
        self._queue = [q for q in self._queue if q.rid not in taken]
        return batch

    def _dispatch(self) -> None:
        import time as _time

        now = self.clock.now()
        batch = self._take_batch()
        names = [r.name for r in batch]
        server_stats = getattr(self.server, "stats", None)
        maint_before = getattr(server_stats, "updates_applied", 0)
        t0 = _time.perf_counter()
        self.server.answer_batch(names)
        wall = _time.perf_counter() - t0
        maint = getattr(server_stats, "updates_applied", 0) - maint_before
        service = float(self.service_model(names, wall, maint))
        require(service >= 0.0, "service model returned negative time")
        self._service_ewma = (service if self._service_ewma is None
                              else 0.7 * self._service_ewma + 0.3 * service)
        for r in batch:
            r.dispatch = now
            r.finish = now + service
        self._inflight = batch
        self._busy_until = now + service
        self.stats.batches += 1
        self.stats.batch_occupancy_sum += len(batch)
        self.stats.queue_depth = len(self._queue)
        self.batch_log.append((now, len(batch)))
        if len(self.batch_log) > self.MAX_BATCH_LOG:
            del self.batch_log[:-self.MAX_BATCH_LOG]

    def _complete_inflight(self) -> None:
        for r in self._inflight:
            self.stats.completed += 1
            self.stats.latency[r.cls].record(r.finish - r.arrival)
        self._inflight = None
        self._sync()

    # ------------------------------------------------------------------
    # update stream passthrough (streaming maintenance backpressure)
    # ------------------------------------------------------------------
    def submit_update(self, inserts=None, deletes=None,
                      t: float | None = None) -> None:
        """Enqueue one triple-delta batch on the backing server at
        virtual time `t`; the backlog drains inside later dispatches
        under the server's staleness budget, stretching their service
        time (see `FixedServiceModel.per_maint_triple`)."""
        if t is not None:
            self.advance_to(t)
        self.server.submit(inserts=inserts, deletes=deletes)
        self.stats.updates_submitted += 1

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    def _sync(self) -> None:
        server_stats = getattr(self.server, "stats", None)
        if server_stats is not None and hasattr(server_stats, "frontend"):
            server_stats.frontend = self.stats.summary()

    def readiness(self) -> dict:
        """Frontend readiness: the server's own probe plus queue state."""
        base = {}
        probe = getattr(self.server, "readiness", None)
        if probe is not None:
            base = dict(probe())
        base.update({
            "queue_depth": len(self._queue),
            "inflight": 0 if self._inflight is None else len(self._inflight),
            "shed": self.stats.shed,
            "downgraded": self.stats.downgraded,
            "virtual_time": self.clock.now(),
        })
        return base
