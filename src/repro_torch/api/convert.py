"""Carry a tuned configuration across from the JAX package.

The JAX package holds no weights; what a running deployment holds is the
triple table, the tuned `State` ⟨V, R⟩ and the view extents computed from
them.  `from_reference` rebuilds all three here from what the JAX side
can hand over without either package importing the other: the `(N, 3)`
int32 triple array, the dictionary's strings in id order, the
`repro.api.serde.state_to_json` encoding of the state (the same JSON
`api/serde.py` reads) and the reformulation groups.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

import repro_torch
from repro_torch.api import serde
from repro_torch.core.executor import QueryExecutor
from repro_torch.core.state import State
from repro_torch.rdf.dictionary import Dictionary
from repro_torch.rdf.triples import TripleStore


class Carried(NamedTuple):
    store: TripleStore
    state: State
    executor: QueryExecutor   # views materialized on the device, ready


def from_reference(triples: np.ndarray, dictionary: list[str] | None,
                   state_json: dict, groups: dict[str, list[str]],
                   device=None) -> Carried:
    """The port's store and state from the JAX package's, plus an
    executor on `device` that answers through the carried views.

    `groups` maps each original query to its reformulation members; every
    member must be a query of the state.
    """
    dev = repro_torch.device(device)
    d = None
    if dictionary is not None:
        d = Dictionary()
        d.encode_many(dictionary)
    store = TripleStore(np.asarray(triples, np.int32), d)
    state = serde.state_from_json(state_json)
    names = {q.name for q in state.queries}
    unknown = sorted({m for ms in groups.values() for m in ms} - names)
    if unknown:
        raise ValueError(f"groups name members the state lacks: {unknown}")
    groups = {k: list(v) for k, v in groups.items()}
    return Carried(store, state, QueryExecutor(store, state, groups,
                                               device=dev))
