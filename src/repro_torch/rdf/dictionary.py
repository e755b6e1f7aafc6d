"""Dictionary encoding: URIs / literals <-> dense int32 ids.

Matches the paper's storage model: the triple table stores triples of
integers; all engine layers (numpy oracle, JAX engine, Pallas kernels)
operate on the encoded form only.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field


@dataclass
class Dictionary:
    _to_id: dict[str, int] = field(default_factory=dict)
    _to_str: list[str] = field(default_factory=list)

    def encode(self, s: str) -> int:
        i = self._to_id.get(s)
        if i is None:
            i = len(self._to_str)
            self._to_id[s] = i
            self._to_str.append(s)
        return i

    def encode_many(self, items) -> list[int]:
        return [self.encode(s) for s in items]

    def lookup(self, s: str) -> int | None:
        return self._to_id.get(s)

    def decode(self, i: int) -> str:
        return self._to_str[i]

    def __len__(self) -> int:
        return len(self._to_str)

    def __contains__(self, s: str) -> bool:
        return s in self._to_id

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self._to_str, f)

    @classmethod
    def load(cls, path: str) -> "Dictionary":
        with open(path) as f:
            strs = json.load(f)
        d = cls()
        for s in strs:
            d.encode(s)
        return d


RDF_TYPE = "rdf:type"
RDFS_SUBCLASS = "rdfs:subClassOf"
RDFS_SUBPROP = "rdfs:subPropertyOf"
RDFS_DOMAIN = "rdfs:domain"
RDFS_RANGE = "rdfs:range"
