"""Update stream: batched triple deltas queued for the maintainer.

A `Delta` is one batch of triple inserts and deletes (either side may be
empty).  The `UpdateStream` is the ingestion buffer between writers and
the staleness-bounded serving loop: `QueryServer.submit()` enqueues,
`_maybe_refresh()` drains while the pending backlog exceeds the budget.
Plain host-side bookkeeping — the device work happens in the maintainer.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np


def _as_triples(arr) -> np.ndarray:
    return (np.zeros((0, 3), np.int32) if arr is None
            else np.asarray(arr, np.int32).reshape(-1, 3))


@dataclass(frozen=True)
class Delta:
    """One update batch.  `size` counts requested changes, before the
    maintainer nets them against the store (duplicate inserts / absent
    deletes may make the effective batch smaller)."""

    inserts: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.int32))
    deletes: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.int32))

    @staticmethod
    def of(inserts=None, deletes=None) -> "Delta":
        return Delta(_as_triples(inserts), _as_triples(deletes))

    @property
    def size(self) -> int:
        return len(self.inserts) + len(self.deletes)


class UpdateStream:
    """FIFO of pending update batches with backlog accounting."""

    def __init__(self) -> None:
        self._queue: deque[Delta] = deque()
        self.total_pushed = 0      # triples ever submitted
        self.total_batches = 0
        self.total_applied = 0     # triples handed to the maintainer

    def push(self, delta: Delta) -> None:
        if delta.size == 0:
            return
        self._queue.append(delta)
        self.total_pushed += delta.size
        self.total_batches += 1

    def pop(self) -> Delta | None:
        if not self._queue:
            return None
        delta = self._queue.popleft()
        self.total_applied += delta.size
        return delta

    def push_front(self, delta: Delta) -> None:
        """Requeue a delta whose maintenance apply failed: it goes back
        to the head of the queue (sequential semantics preserved) and is
        un-counted from `total_applied` so backlog accounting stays
        truthful while the serving layer reports staleness."""
        if delta.size == 0:
            return
        self._queue.appendleft(delta)
        self.total_applied -= delta.size

    def coalesce(self) -> Delta | None:
        """Pop and merge the whole backlog into ONE net batch (one device
        maintenance pass instead of one per submit), preserving
        sequential semantics: for a triple touched by several batches
        the LAST operation wins (within one batch, insert wins the tie,
        matching `effective_delta`), so applying the coalesced delta
        equals applying the batches in order."""
        from repro_torch.rdf.triples import triple_keys

        if not self._queue:
            return None
        batches = list(self._queue)
        self._queue.clear()
        parts, ops = [], []
        for b in batches:  # within a batch the insert outranks the delete
            parts.extend((b.deletes, b.inserts))
            ops.extend((np.zeros(len(b.deletes), bool),
                        np.ones(len(b.inserts), bool)))
        rows = np.concatenate(parts)
        is_ins = np.concatenate(ops)
        # stable sort by triple key keeps submission order inside each
        # group; the last row of a group is that triple's final op
        order = np.argsort(triple_keys(rows), kind="stable")
        keys = triple_keys(rows)[order]
        last = np.r_[keys[1:] != keys[:-1], np.ones(1, bool)] \
            if len(keys) else np.zeros(0, bool)
        winners = order[last]
        merged = Delta(rows[winners[is_ins[winners]]],
                       rows[winners[~is_ins[winners]]])
        self.total_applied += merged.size
        return merged

    @property
    def pending_batches(self) -> int:
        return len(self._queue)

    @property
    def pending_triples(self) -> int:
        return sum(b.size for b in self._queue)

    def __len__(self) -> int:
        return len(self._queue)
