"""Deterministic fault injection for the serving core.

Every failure boundary of the serving path carries a hook point that
calls `FaultInjector.fire(site)`; an armed site raises an
`InjectedFault` (or `InjectedTimeout`) at an exact, reproducible call
index — no randomness, no wall clock — so the chaos suite and
`benchmarks/bench_fault.py` replay identically everywhere.

Sites and where they fire:

  device_call        WorkloadExecutor.run — the fused device program
  capacity_overflow  WorkloadExecutor.run — an overflow storm that
                     exhausts the adaptive-recompile budget
  compile            WorkloadExecutor program (re)construction — the
                     first compile of a fresh/hot-swapped program
  maintenance_apply  ViewMaintainer.apply — a streaming delta pass
  retune             TuningSession.retune — the States Navigator
  apply              TuningSession.apply — the delta view swap
  per_query_call     QueryServer's per-query fallback tier
  ref_engine_call    QueryServer's host reference-engine tier

Armed specs fire `count` times starting after `after` clean calls at
that site, then clear themselves — "the fault clears" is part of the
schedule, which is what lets tests assert recovery to HEALTHY.

`corrupt_extent` is the one fault that mutates state instead of
raising: it breaks the host-mirror / device-buffer row alignment of a
materialized view extent (the invariant streaming maintenance
preserves), which the server's integrity probe must catch before the
fused path can serve a silently wrong answer.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

SITES = ("device_call", "capacity_overflow", "compile", "maintenance_apply",
         "retune", "apply", "per_query_call", "ref_engine_call")


class InjectedFault(RuntimeError):
    """A fault raised by the chaos harness (never by real code)."""

    def __init__(self, site: str, message: str = ""):
        self.site = site
        super().__init__(message or f"injected fault at {site!r}")


class InjectedTimeout(InjectedFault):
    """An injected call-timeout (the call never returned in budget)."""

    def __init__(self, site: str):
        super().__init__(site, f"injected timeout at {site!r}")


@dataclass
class FaultSpec:
    """One armed fault: raise at calls (after, after+count] of `site`."""

    site: str
    after: int = 0            # clean calls to let through first
    count: int | None = 1     # raises before auto-clearing (None: sticky)
    kind: str = "error"       # "error" | "timeout"
    calls: int = 0            # calls seen since arming
    fired: int = 0            # raises so far

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"one of {SITES}")
        if self.kind not in ("error", "timeout"):
            raise ValueError(f"kind must be error|timeout, got {self.kind!r}")
        if self.after < 0 or (self.count is not None and self.count < 1):
            raise ValueError("after must be >= 0 and count >= 1")


@dataclass
class FaultInjector:
    """The registry the hook points consult.  Duck-typed: everything
    below `serve/` only needs `.fire(site)`, so the query and
    maintenance layers never import this module."""

    MAX_LOG = 4096  # injection log cap: chaos soaks run for many batches

    specs: dict[str, FaultSpec] = field(default_factory=dict)
    calls: dict[str, int] = field(default_factory=dict)   # per-site, lifetime
    injected: int = 0
    log: list[tuple[str, int]] = field(default_factory=list)

    # ------------------------------------------------------------------
    def arm(self, site: str, after: int = 0, count: int | None = 1,
            kind: str = "error") -> FaultSpec:
        """Arm `site`; replaces any previous spec for it."""
        spec = FaultSpec(site=site, after=after, count=count, kind=kind)
        self.specs[site] = spec
        return spec

    def clear(self, site: str | None = None) -> None:
        if site is None:
            self.specs.clear()
        else:
            self.specs.pop(site, None)

    def armed(self, site: str) -> bool:
        return site in self.specs

    # ------------------------------------------------------------------
    def fire(self, site: str) -> None:
        """Hook point: raise iff `site` is armed and scheduled."""
        self.calls[site] = self.calls.get(site, 0) + 1
        spec = self.specs.get(site)
        if spec is None:
            return
        spec.calls += 1
        if spec.calls <= spec.after:
            return
        if spec.count is not None and spec.fired >= spec.count:
            # exhausted (kept armed only when sticky)
            self.specs.pop(site, None)
            return
        spec.fired += 1
        self.injected += 1
        self.log.append((site, self.calls[site]))
        del self.log[:-self.MAX_LOG]
        if spec.count is not None and spec.fired >= spec.count:
            self.specs.pop(site, None)
        if spec.kind == "timeout":
            raise InjectedTimeout(site)
        raise InjectedFault(site)

    # ------------------------------------------------------------------
    def corrupt_extent(self, executor, vid: int | None = None) -> int:
        """Break host/device row alignment of one materialized extent.

        Truncates the host mirror by one row (or plants a phantom row in
        an empty extent), so `len(extents[vid].rows) != device n` — the
        exact invariant `ViewMaintainer.check_alignment` guards and the
        serving integrity probe checks before trusting the fused path.
        Returns the corrupted view id.
        """
        from repro_torch.query import ref_engine as R

        vids = sorted(executor.extents)
        if not vids:
            raise ValueError("executor has no materialized extents")
        if vid is None:
            vid = vids[0]
        rel = executor.extents[vid]
        if len(rel.rows):
            rows = rel.rows[:-1]
        else:
            rows = np.zeros((1, max(len(rel.cols), 1)), np.int32)
        executor.extents[vid] = R.Relation(rows, rel.cols)
        self.injected += 1
        self.log.append(("extent_corrupt", vid))
        del self.log[:-self.MAX_LOG]
        return vid
