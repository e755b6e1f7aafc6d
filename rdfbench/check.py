"""What decides `correct`: the answers the window produced, against the
plain reference.

During the window the harness keeps, for each kind of request (the whole
workload, or one query group), `KEEP` requests' rows chosen uniformly
from those answered (a reservoir drawn from the seed), and the number of
rows each member returned in every request.  Once the window has closed
it compares one number, `wrong_rows`, with the limit 0 (the answers are
exact):

- for each kept request and each query group it answers, the rows in the
  symmetric difference between the union of its member rows and the
  reference's answer to that query (all of the reference's rows for a
  group no request answered), plus
- for every request, the rows by which each member's row count differs
  from the first kept request of its kind: every request reads the same
  store, so a request whose counts differ is wrong by at least that
  many rows.

The parts are printed beside it (`<q>.missing`, `<q>.extra`,
`count_drift`).
"""
from __future__ import annotations

import numpy as np

from rdfbench.loadgen import seed_stream
from rdfbench.reference import rdfs_cq


KEEP = 4       # requests of each kind compared row by row


class Keeper:
    """The reservoir of `KEEP` requests per kind, and the row-count
    tally."""

    def __init__(self, seed: int):
        self.rng = seed_stream(seed, 2)
        self.kept: dict = {}        # kind -> [rows of each kept request]
        self.seen: dict = {}        # kind -> requests answered
        self.counts: dict = {}      # kind -> [row counts of each request]

    def add(self, kind, rows: dict[str, np.ndarray]) -> None:
        n = self.seen.get(kind, 0) + 1
        self.seen[kind] = n
        self.counts.setdefault(kind, []).append(
            tuple(len(rows[m]) for m in sorted(rows)))
        kept = self.kept.setdefault(kind, [])
        if len(kept) < KEEP:
            kept.append(rows)
        else:
            j = int(self.rng.integers(0, n))
            if j < KEEP:
                kept[j] = rows


def _rows2d(a) -> np.ndarray:
    a = np.asarray(a)
    return a.reshape(len(a), -1) if a.ndim != 2 else a


def group_rows(rows: dict, groups: dict[str, list[str]]) -> dict:
    """group -> the union of its members' rows, for each group that one
    request's `rows` answer."""
    out = {}
    for g, members in groups.items():
        have = [_rows2d(rows[m]) for m in members if m in rows]
        if have:
            out[g] = np.concatenate(have)
    return out


def compare(keeper: Keeper, groups: dict, triples: np.ndarray, data,
            consts: dict, queries: dict) -> tuple[int, dict]:
    """(`wrong_rows`, its parts by name)."""
    want = rdfs_cq.answers(triples, data, consts, queries,
                           names=sorted(groups))
    parts = {f"{g}.{k}": 0 for g in sorted(groups)
             for k in ("missing", "extra")}
    answered = set()
    for kept in keeper.kept.values():
        for rows in kept:
            for g, got in group_rows(rows, groups).items():
                missing, extra = rdfs_cq.diff_counts(got, want[g])
                parts[f"{g}.missing"] += missing
                parts[f"{g}.extra"] += extra
                answered.add(g)
    for g in sorted(set(groups) - answered):
        parts[f"{g}.missing"] += len(want[g])
    drift = 0
    for kind, counts in keeper.counts.items():
        first = keeper.kept[kind][0]
        base = tuple(len(first[m]) for m in sorted(first))
        drift += sum(sum(abs(a - b) for a, b in zip(c, base))
                     for c in counts)
    parts["count_drift"] = drift
    return sum(parts.values()), parts
