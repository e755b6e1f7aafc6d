"""Carry a tuned configuration, or a model's weights, across from the
JAX package.

The JAX package holds no weights; what a running deployment holds is the
triple table, the tuned `State` ⟨V, R⟩, the view extents computed from
them and, once it has maintained views under writes, the measured
per-view maintenance costs.  `from_reference` rebuilds all four here
from what the JAX side can hand over without either package importing
the other: the `(N, 3)` int32 triple array, the dictionary's strings in
id order, the `repro.api.serde.state_to_json` encoding of the state (the
same JSON `api/serde.py` reads), the reformulation groups, and the
measured costs as `(cq_to_json(view CQ), units per triple)` pairs.

`model_params_from_reference` carries an LM's parameter tree (the JAX
package's `Model.init` layout, as numpy arrays) into the port's `Model`.
"""
from __future__ import annotations

from typing import Iterable, NamedTuple

import numpy as np
import torch

import repro_torch
from repro_torch.api import serde
from repro_torch.core.executor import QueryExecutor
from repro_torch.core.quality import MaintenanceCostModel
from repro_torch.core.state import State
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, build_model
from repro_torch.models.params import tree_map
from repro_torch.rdf.dictionary import Dictionary
from repro_torch.rdf.triples import TripleStore


class Carried(NamedTuple):
    store: TripleStore
    state: State
    executor: QueryExecutor   # views materialized on the device, ready
    costs: MaintenanceCostModel  # measured costs; a session's
    #                              `maintenance_costs` takes it as it is


def from_reference(triples: np.ndarray, dictionary: list[str] | None,
                   state_json: dict, groups: dict[str, list[str]],
                   device=None,
                   measured_costs: Iterable[tuple[dict, float]] | None = None
                   ) -> Carried:
    """The port's store and state from the JAX package's, plus an
    executor on `device` that answers through the carried views.

    `groups` maps each original query to its reformulation members; every
    member must be a query of the state.  `measured_costs` are the JAX
    session's `maintenance_costs`, one `(view CQ JSON, units)` pair per
    measured view; set `TuningSession.maintenance_costs` to the returned
    `costs` and the port's `retune()` optimizes the same measured
    objective.
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
    costs = MaintenanceCostModel()
    for cq_json, units in measured_costs or ():
        costs.measured[serde.cq_from_json(cq_json).canonical_key()] = \
            float(units)
    return Carried(store, state,
                   QueryExecutor(store, state, groups, device=dev), costs)


def model_params_from_reference(params_np: dict, cfg: ModelConfig,
                                device=None, dtype=None) -> Model:
    """A `Model` for `cfg` on `device` holding the JAX package's parameter
    tree `params_np` (nested dicts of numpy arrays, the layout of
    `repro.models.model.Model.init`), each leaf cast to `dtype` if given.

    torch cannot take `ml_dtypes.bfloat16` arrays: hand bf16 weights over
    as float32 (`np.asarray(x, np.float32)`) and pass
    `dtype=torch.bfloat16`."""
    model = build_model(cfg, device)
    tree = tree_map(lambda x: torch.tensor(np.asarray(x), dtype=dtype,
                                           device=model.device), params_np)
    return model.load_params(tree)
