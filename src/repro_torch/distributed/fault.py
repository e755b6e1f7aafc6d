"""Fault tolerance: training supervision AND the serving supervisor.

The twin of `repro/distributed/fault.py`: the health constants,
`RetryPolicy`, `CircuitBreaker`, `HealthTransition` and
`ServingSupervisor` (with its per-shard health map) used by
`repro_torch.serve.query_server`, and the training half over the port's
checkpointer:

  * TrainSupervisor — checkpoint cadence, preemption-safe resume
    (restart continues bit-exactly from the last committed step; the
    checkpoints are the JAX package's, so either resumes the other's),
  * StragglerMonitor — per-step timing watermarks; hosts slower than
    `threshold x median` over a window are flagged for replacement,
  * CircuitBreaker / ServingSupervisor — a deterministic (batch-counted,
    no wall clock) breaker over the fused device path and an explicit
    health state machine (HEALTHY / DEGRADED / STALE_ONLY / DOWN) with a
    transition log.  Deliberately free of any serving imports so the
    training and serving layers share one fault vocabulary.

Health states:

  HEALTHY     the fused device path serves, answers fresh
  DEGRADED    a fallback tier serves (per-query / host reference
              engine), or answers exceed the staleness budget — every
              answer is still exact for the snapshot it was computed on
  STALE_ONLY  only last-known-good cached answers are servable
  DOWN        nothing servable; requests fail loudly
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Callable

from repro_torch.checkpoint import checkpoint as C

HEALTHY = "HEALTHY"
DEGRADED = "DEGRADED"
STALE_ONLY = "STALE_ONLY"
DOWN = "DOWN"

# severity order for rollups over shard health maps
_SEVERITY = {HEALTHY: 0, DEGRADED: 1, STALE_ONLY: 2, DOWN: 3}


def _tier_health(tier: int | None, stale: bool, degraded: bool = False) -> str:
    """Map one served ladder tier onto a health state (shared by the
    whole-server `observe` and the per-shard `observe_shard`)."""
    if tier is None:
        return DOWN
    if tier >= 3:
        return STALE_ONLY
    if tier > 0 or stale or degraded:
        return DEGRADED
    return HEALTHY


@dataclass(frozen=True)
class RetryPolicy:
    """Retry/backoff policy for the serving ladder.

    All quantities are deterministic batch counts, never wall-clock
    sleeps: a serving batch is the supervisor's clock tick, so tests
    and the chaos harness replay identically.
    """

    max_attempts: int = 2        # in-batch retries of the fused path
    failure_threshold: int = 1   # consecutive failed batches to open
    cooldown_batches: int = 1    # open-state batches before a probe
    backoff_factor: float = 2.0  # cooldown growth per re-open
    max_cooldown: int = 8        # backoff ceiling (batches)
    call_timeout_seconds: float | None = None  # fused-call soft budget

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if self.cooldown_batches < 1:
            raise ValueError("cooldown_batches must be >= 1")


class CircuitBreaker:
    """closed -> open -> half_open breaker, clocked in batches.

    `allow()` is called once per batch before the protected path runs;
    while open it burns one cooldown tick and refuses.  The half-open
    state admits exactly one probe: success closes the breaker and
    resets the cooldown, failure re-opens it with the cooldown grown by
    `backoff_factor` (capped), so a persistent fault is probed ever
    more rarely instead of hammered.
    """

    def __init__(self, policy: RetryPolicy | None = None):
        self.policy = policy or RetryPolicy()
        self.state = "closed"
        self.failures = 0            # consecutive failures while closed
        self.opens = 0               # lifetime open transitions
        self._cooldown = self.policy.cooldown_batches
        self._wait = 0

    def allow(self) -> bool:
        if self.state == "closed":
            return True
        if self.state == "open":
            self._wait -= 1
            if self._wait > 0:
                return False
            self.state = "half_open"
        return True  # half_open: one probe

    def record_success(self) -> None:
        self.state = "closed"
        self.failures = 0
        self._cooldown = self.policy.cooldown_batches

    def record_failure(self) -> None:
        if self.state == "half_open":
            # failed probe: back off harder
            self._cooldown = min(
                max(int(self._cooldown * self.policy.backoff_factor),
                    self._cooldown + 1),
                self.policy.max_cooldown)
            self._open()
            return
        self.failures += 1
        if self.failures >= self.policy.failure_threshold:
            self._open()

    def _open(self) -> None:
        self.state = "open"
        self.failures = 0
        self._wait = self._cooldown
        self.opens += 1


@dataclass(frozen=True)
class HealthTransition:
    batch: int
    previous: str
    health: str
    reason: str


class ServingSupervisor:
    """Health state machine for a degradation-ladder server.

    The server reports which tier answered each batch (0 fused,
    1 per-query, 2 reference engine, 3 last-known-good cache) and
    whether the batch was stale; the supervisor owns the breaker over
    the fused path and the HEALTHY/DEGRADED/STALE_ONLY/DOWN state with
    a bounded transition log.
    """

    MAX_TRANSITIONS = 64

    def __init__(self, policy: RetryPolicy | None = None):
        self.policy = policy or RetryPolicy()
        self.fused = CircuitBreaker(self.policy)
        self.health = HEALTHY
        self.batches = 0
        self.transitions: list[HealthTransition] = []
        # shard-indexed health map (sharded serving backends): shard id
        # -> HEALTHY/DEGRADED/STALE_ONLY/DOWN, folded into the overall
        # health via `rollup()` so one bad shard degrades the server
        # instead of taking it DOWN.
        self.shard_health: dict[int, str] = {}

    def begin_batch(self) -> int:
        self.batches += 1
        return self.batches

    def observe(self, tier: int | None, stale: bool,
                reason: str = "", degraded: bool = False) -> str:
        """Fold one served batch into the health state.  `tier=None`
        means the batch could not be served at all; `degraded=True`
        forces at least DEGRADED even for a tier-0 batch (e.g. one that
        only served after an integrity repair)."""
        to = _tier_health(tier, stale, degraded)
        self._set(to, reason or f"served by tier {tier}"
                  + (" (stale)" if stale else ""))
        return self.health

    # ------------------------------------------------------------------
    # per-shard health (sharded serving)
    # ------------------------------------------------------------------
    def observe_shard(self, shard: int, tier: int | None,
                      stale: bool = False) -> str:
        """Record which ladder tier served shard `shard`'s partition
        this batch — the same tier vocabulary as `observe` (0 device
        program, 1-2 exact fallback, 3 stale cache, None unservable) —
        without touching the overall health; call `rollup()` once per
        batch to fold the map in."""
        h = _tier_health(tier, stale)
        self.shard_health[shard] = h
        return h

    def worst(self) -> str:
        """Worst health across the shard map (HEALTHY when untracked)."""
        if not self.shard_health:
            return HEALTHY
        return max(self.shard_health.values(), key=_SEVERITY.__getitem__)

    def quorum(self, minimum: int | None = None) -> bool:
        """True while at least `minimum` shards (default: a strict
        majority) can serve EXACT answers for their partition (HEALTHY
        or DEGRADED — a degraded shard serves via host fallback but its
        answers are still exact)."""
        if not self.shard_health:
            return True
        need = (len(self.shard_health) // 2 + 1
                if minimum is None else minimum)
        exact = sum(1 for h in self.shard_health.values()
                    if _SEVERITY[h] <= _SEVERITY[DEGRADED])
        return exact >= need

    def rollup(self, stale: bool = False, reason: str = "") -> str:
        """Fold the shard health map into the overall state: all shards
        HEALTHY -> HEALTHY; any shard below HEALTHY while a quorum still
        serves exact answers -> DEGRADED (the server keeps answering
        from the remaining shards plus host fallback for the missing
        partitions — one bad shard must not read as whole-server DOWN);
        quorum lost but some shard still servable -> STALE_ONLY; every
        shard unservable -> DOWN."""
        w = self.worst()
        if w == HEALTHY and not stale:
            to = HEALTHY
        elif self.quorum():
            to = DEGRADED
        elif any(_SEVERITY[h] < _SEVERITY[DOWN]
                 for h in self.shard_health.values()):
            to = STALE_ONLY
        else:
            to = DOWN
        self._set(to, reason or f"shard rollup (worst={w})")
        return self.health

    def _set(self, to: str, reason: str) -> None:
        if to == self.health:
            return
        self.transitions.append(HealthTransition(
            self.batches, self.health, to, reason))
        del self.transitions[:-self.MAX_TRANSITIONS]
        self.health = to

    def ready(self) -> bool:
        """Readiness: the server can answer something (possibly stale)."""
        return self.health != DOWN


@dataclass
class StragglerMonitor:
    window: int = 20
    threshold: float = 2.0
    _times: dict[int, list[float]] = field(default_factory=dict)
    flagged: set[int] = field(default_factory=set)

    def record(self, host: int, step_seconds: float) -> None:
        self._times.setdefault(host, []).append(step_seconds)
        self._times[host] = self._times[host][-self.window:]

    def check(self) -> set[int]:
        medians = {
            h: statistics.median(ts) for h, ts in self._times.items() if ts
        }
        if len(medians) < 2:
            return set()
        global_median = statistics.median(medians.values())
        self.flagged = {
            h for h, m in medians.items() if m > self.threshold * global_median
        }
        return self.flagged


@dataclass
class TrainSupervisor:
    ckpt_dir: str
    save_every: int = 50
    keep: int = 3

    def resume_or_init(self, init_fn: Callable[[], dict], target_shapes=None,
                       shardings=None) -> tuple[dict, int]:
        """Returns (state, start_step).  After a preemption, training
        resumes from the last committed checkpoint, its leaves restored
        onto the devices of `target_shapes` (default: `init_fn()`'s
        state), or, given `shardings` (e.g. `train_state_shardings` of
        another mesh), onto their mesh's device."""
        last = C.latest_step(self.ckpt_dir)
        if last is None:
            return init_fn(), 0
        target = target_shapes if target_shapes is not None else init_fn()
        state = C.restore(self.ckpt_dir, last, target, shardings)
        return state, last

    def maybe_save(self, step: int, state) -> str | None:
        if step % self.save_every == 0 and step > 0:
            return C.save(self.ckpt_dir, step, state, keep=self.keep)
        return None
