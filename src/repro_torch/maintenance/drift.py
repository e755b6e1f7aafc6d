"""Workload-drift detection over the update stream.

The tuned configuration was chosen for the statistics the store had at
retune time.  Two kinds of drift invalidate it:

  * update-rate drift — the stream runs much hotter than when the
    quality function traded maintenance cost against execution cost
    (weights.update_rate), so view maintenance dominates;
  * selectivity drift — the predicate mix of the arriving deltas no
    longer matches the store's predicate distribution, so cardinality
    estimates (and with them view choice) are stale.

Both are measured over a sliding window of observed batches, host-side
and O(batch) per observation — no stats recomputation, no device work.
A triggered report is a *recommendation*; the server acts on it
(`TuningSession.retune()`) and then calls `reset()` with the fresh
statistics.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class DriftReport:
    triggered: bool
    reason: str            # "" | "update-rate" | "selectivity" | both
    rate_ratio: float      # recent mean batch size / baseline mean
    pred_distance: float   # total-variation distance, window vs store
    window_triples: int

    def summary(self) -> str:
        state = "DRIFT" if self.triggered else "ok"
        return (f"{state}: rate x{self.rate_ratio:.1f}, "
                f"pred-shift {self.pred_distance:.2f} "
                f"over {self.window_triples} triples"
                + (f" ({self.reason})" if self.reason else ""))


class DriftDetector:
    """Sliding-window drift detector.

    The first `window` observed batches freeze the rate baseline; after
    that, a report triggers when the recent-window mean batch size
    exceeds `rate_factor` times the baseline, or when the predicate
    histogram of the windowed deltas sits further than `dist_threshold`
    (total variation, in [0, 1]) from the store's predicate
    distribution — each guarded by `min_triples` so a trickle of odd
    triples cannot force a retune."""

    def __init__(self, stats, window: int = 8, rate_factor: float = 4.0,
                 dist_threshold: float = 0.6, min_triples: int = 64):
        self.window = int(window)
        self.rate_factor = float(rate_factor)
        self.dist_threshold = float(dist_threshold)
        self.min_triples = int(min_triples)
        self._sizes: deque[int] = deque(maxlen=self.window)
        self._preds: deque[dict[int, int]] = deque(maxlen=self.window)
        self._baseline_rate: float | None = None
        self._warmup_sizes: list[int] = []
        self.triggers = 0
        self.observed = 0
        self.reset(stats)

    # ------------------------------------------------------------------
    def reset(self, stats) -> None:
        """Re-baseline against fresh store statistics (post-retune)."""
        total = max(sum(stats.pred_count.values()), 1)
        self._base_pred = {p: c / total for p, c in stats.pred_count.items()}
        self._sizes.clear()
        self._preds.clear()
        self._baseline_rate = None
        self._warmup_sizes = []

    # ------------------------------------------------------------------
    def observe(self, n_triples: int, pred_ids: np.ndarray) -> DriftReport:
        """One maintained batch: its effective size and the predicate ids
        of every inserted/deleted triple."""
        self.observed += 1
        pred_ids = np.asarray(pred_ids).reshape(-1)
        hist: dict[int, int] = {}
        if len(pred_ids):
            vals, counts = np.unique(pred_ids, return_counts=True)
            hist = {int(p): int(c) for p, c in zip(vals, counts)}
        self._sizes.append(int(n_triples))
        self._preds.append(hist)
        if self._baseline_rate is None:
            self._warmup_sizes.append(int(n_triples))
            if len(self._warmup_sizes) >= self.window:
                self._baseline_rate = max(
                    float(np.mean(self._warmup_sizes)), 1.0)
            return DriftReport(False, "", 1.0, 0.0, sum(self._sizes))

        rate_ratio = float(np.mean(self._sizes)) / self._baseline_rate
        merged: dict[int, int] = {}
        for h in self._preds:
            for p, c in h.items():
                merged[p] = merged.get(p, 0) + c
        window_triples = sum(merged.values())
        pred_distance = 0.0
        if window_triples:
            keys = set(merged) | set(self._base_pred)
            pred_distance = 0.5 * sum(
                abs(merged.get(p, 0) / window_triples
                    - self._base_pred.get(p, 0.0))
                for p in keys)

        reasons = []
        if (rate_ratio > self.rate_factor
                and sum(self._sizes) >= self.min_triples):
            reasons.append("update-rate")
        if (pred_distance > self.dist_threshold
                and window_triples >= self.min_triples):
            reasons.append("selectivity")
        triggered = bool(reasons)
        if triggered:
            self.triggers += 1
        return DriftReport(triggered, "+".join(reasons), rate_ratio,
                           pred_distance, sum(self._sizes))
