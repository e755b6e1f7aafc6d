"""States Navigator: strategies over the view-configuration search space.

Two exhaustive strategies (DFS, best-first) navigate the whole space with
memoization; heuristic strategies (greedy, beam, simulated annealing)
prune it, as the paper's demo offers ("quick search" vs "optimal
solution").  Stop conditions: state budget, wall-clock budget, and the
fully-relaxed detector.
"""
from __future__ import annotations

import heapq
import math
import random
import time
from dataclasses import dataclass, field

from repro_torch.core.quality import (MaintenanceCostModel, QualityBreakdown,
                                QualityWeights, quality)
from repro_torch.core.state import State
from repro_torch.core.transitions import is_fully_relaxed, successors
from repro_torch.rdf.triples import Statistics


@dataclass
class SearchConfig:
    strategy: str = "greedy"  # exhaustive_dfs|best_first|greedy|beam|anneal
    max_states: int = 5000
    max_seconds: float = 60.0
    beam_width: int = 8
    anneal_steps: int = 400
    anneal_t0: float = 1.0
    anneal_decay: float = 0.99
    seed: int = 0
    allow_predicate_cut: bool = False
    stop_fully_relaxed: bool = True
    weights: QualityWeights = field(default_factory=QualityWeights)
    # warm-start seed: when set, the navigator resumes from this state
    # instead of the initial_state it is handed (TuningSession.retune)
    initial: State | None = None
    # measured per-view maintenance costs (repro.maintenance); None keeps
    # the static a-priori estimate for every view
    maint_model: MaintenanceCostModel | None = None


@dataclass
class SearchResult:
    best: State
    best_quality: QualityBreakdown
    explored: int
    elapsed_s: float
    log: list[dict] = field(default_factory=list)

    def summary(self) -> str:
        q = self.best_quality
        return (f"explored={self.explored} states in {self.elapsed_s:.2f}s; "
                f"best total={q.total:.1f} (exec={q.exec_cost:.1f}, "
                f"maint={q.maint_cost:.1f}, space={q.space_bytes:.0f}B, "
                f"{len(self.best.views)} views)")


def _expand(state: State, cfg: SearchConfig) -> list[State]:
    if cfg.stop_fully_relaxed and is_fully_relaxed(state):
        return []
    return list(successors(state, allow_predicate_cut=cfg.allow_predicate_cut))


def search(initial: State, stats: Statistics, cfg: SearchConfig) -> SearchResult:
    fn = {
        "exhaustive_dfs": _exhaustive_dfs,
        "best_first": _best_first,
        "greedy": _greedy,
        "beam": _beam,
        "anneal": _anneal,
    }[cfg.strategy]
    if cfg.initial is not None:
        initial = cfg.initial
    t0 = time.monotonic()
    result = fn(initial, stats, cfg, t0)
    result.elapsed_s = time.monotonic() - t0
    return result


def _exhaustive_dfs(initial: State, stats, cfg: SearchConfig, t0: float) -> SearchResult:
    best, best_q = initial, quality(initial, stats, cfg.weights, cfg.maint_model)
    seen = {initial.key()}
    stack = [initial]
    explored = 1
    log = [{"step": 0, "total": best_q.total, "views": len(initial.views)}]
    while stack:
        if explored >= cfg.max_states or time.monotonic() - t0 > cfg.max_seconds:
            break
        cur = stack.pop()
        for nxt in _expand(cur, cfg):
            k = nxt.key()
            if k in seen:
                continue
            seen.add(k)
            explored += 1
            q = quality(nxt, stats, cfg.weights, cfg.maint_model)
            if q.total < best_q.total:
                best, best_q = nxt, q
                log.append({"step": explored, "total": q.total, "views": len(nxt.views)})
            stack.append(nxt)
            if explored >= cfg.max_states:
                break
    return SearchResult(best, best_q, explored, 0.0, log)


def _best_first(initial: State, stats, cfg: SearchConfig, t0: float) -> SearchResult:
    best, best_q = initial, quality(initial, stats, cfg.weights, cfg.maint_model)
    seen = {initial.key()}
    counter = 0
    heap = [(best_q.total, counter, initial)]
    explored = 1
    log = [{"step": 0, "total": best_q.total, "views": len(initial.views)}]
    while heap:
        if explored >= cfg.max_states or time.monotonic() - t0 > cfg.max_seconds:
            break
        _, _, cur = heapq.heappop(heap)
        for nxt in _expand(cur, cfg):
            k = nxt.key()
            if k in seen:
                continue
            seen.add(k)
            explored += 1
            q = quality(nxt, stats, cfg.weights, cfg.maint_model)
            if q.total < best_q.total:
                best, best_q = nxt, q
                log.append({"step": explored, "total": q.total, "views": len(nxt.views)})
            counter += 1
            heapq.heappush(heap, (q.total, counter, nxt))
            if explored >= cfg.max_states:
                break
    return SearchResult(best, best_q, explored, 0.0, log)


def _greedy(initial: State, stats, cfg: SearchConfig, t0: float) -> SearchResult:
    cur, cur_q = initial, quality(initial, stats, cfg.weights, cfg.maint_model)
    explored = 1
    log = [{"step": 0, "total": cur_q.total, "views": len(initial.views)}]
    while time.monotonic() - t0 <= cfg.max_seconds and explored < cfg.max_states:
        best_next, best_next_q = None, None
        for nxt in _expand(cur, cfg):
            explored += 1
            q = quality(nxt, stats, cfg.weights, cfg.maint_model)
            if best_next_q is None or q.total < best_next_q.total:
                best_next, best_next_q = nxt, q
            if explored >= cfg.max_states:
                break
        if best_next is None or best_next_q.total >= cur_q.total:
            break  # local optimum
        cur, cur_q = best_next, best_next_q
        log.append({"step": explored, "total": cur_q.total, "views": len(cur.views)})
    return SearchResult(cur, cur_q, explored, 0.0, log)


def _beam(initial: State, stats, cfg: SearchConfig, t0: float) -> SearchResult:
    best, best_q = initial, quality(initial, stats, cfg.weights, cfg.maint_model)
    frontier = [(best_q, initial)]
    seen = {initial.key()}
    explored = 1
    log = [{"step": 0, "total": best_q.total, "views": len(initial.views)}]
    while frontier:
        if explored >= cfg.max_states or time.monotonic() - t0 > cfg.max_seconds:
            break
        candidates: list[tuple[QualityBreakdown, State]] = []
        for _, cur in frontier:
            for nxt in _expand(cur, cfg):
                k = nxt.key()
                if k in seen:
                    continue
                seen.add(k)
                explored += 1
                q = quality(nxt, stats, cfg.weights, cfg.maint_model)
                candidates.append((q, nxt))
                if q.total < best_q.total:
                    best, best_q = nxt, q
                    log.append({"step": explored, "total": q.total,
                                "views": len(nxt.views)})
                if explored >= cfg.max_states:
                    break
            if explored >= cfg.max_states:
                break
        candidates.sort(key=lambda t: t[0].total)
        frontier = candidates[: cfg.beam_width]
    return SearchResult(best, best_q, explored, 0.0, log)


def _anneal(initial: State, stats, cfg: SearchConfig, t0: float) -> SearchResult:
    rng = random.Random(cfg.seed)
    cur, cur_q = initial, quality(initial, stats, cfg.weights, cfg.maint_model)
    best, best_q = cur, cur_q
    temp = cfg.anneal_t0 * max(cur_q.total, 1.0)
    explored = 1
    log = [{"step": 0, "total": cur_q.total, "views": len(initial.views)}]
    for step in range(cfg.anneal_steps):
        if explored >= cfg.max_states or time.monotonic() - t0 > cfg.max_seconds:
            break
        succ = _expand(cur, cfg)
        if not succ:
            break
        nxt = rng.choice(succ)
        explored += 1
        q = quality(nxt, stats, cfg.weights, cfg.maint_model)
        delta = q.total - cur_q.total
        if delta <= 0 or rng.random() < math.exp(-delta / max(temp, 1e-9)):
            cur, cur_q = nxt, q
            if cur_q.total < best_q.total:
                best, best_q = cur, cur_q
                log.append({"step": explored, "total": cur_q.total,
                            "views": len(cur.views)})
        temp *= cfg.anneal_decay
    return SearchResult(best, best_q, explored, 0.0, log)
