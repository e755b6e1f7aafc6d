"""Requests of a traffic mix, drawn from the seed.

A mix is a data file (`traffic/<mix>.json`).  Its `request` says what
one request asks:

- `"workload"`: the whole workload at once, through the fused program;
- `"group"`: one query group, through its members' own operator trees,
  drawn by the configuration's integer weights.  Requests come in blocks
  that hold each group as often as its weight says, shuffled by the seed,
  so every seed sends the same mix in another order.

`loop` is `"closed"`: one client sends the next request when the last
one has been answered.
"""
from __future__ import annotations

import numpy as np

KINDS = ("workload", "group")


def seed_stream(seed: int, purpose: int) -> np.random.Generator:
    """An independent numpy stream for one use of the seed (any integer)."""
    return np.random.default_rng([seed % (1 << 64), purpose])


def check_mix(mix: dict) -> None:
    if mix.get("request") not in KINDS:
        raise ValueError(f"traffic request {mix.get('request')!r} is not "
                         f"one of {KINDS}")
    if mix.get("loop") != "closed" or int(mix.get("clients", 1)) != 1:
        raise ValueError("only a closed loop of one client is implemented")


def requests(mix: dict, weights: dict[str, float], seed: int):
    """Endless iterator of requests: None for the whole workload, else a
    group name."""
    check_mix(mix)
    if mix["request"] == "workload":
        while True:
            yield None
    block = []
    for name, w in sorted(weights.items()):
        if w != int(w) or w < 0:
            raise ValueError(f"weight of {name} must be a whole number")
        block += [name] * int(w)
    rng = seed_stream(seed, 1)
    while True:
        for i in rng.permutation(len(block)):
            yield block[i]
