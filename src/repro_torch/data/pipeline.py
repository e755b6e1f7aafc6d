"""Data pipeline: RDF-backed token streams (+ synthetic fallback).

A copy of `repro/data/pipeline.py` (numpy only): `RDFTokenPipeline`
reads the port's `QueryExecutor` (`groups`, `answer_group`) and yields
numpy batches; the caller moves them to its device.

The integration point between the paper and the LM substrate: training
corpora stored as RDF are served THROUGH the wizard's materialized views
— the pipeline's SPARQL workload is exactly the workload the wizard
tuned for, so data loading hits rewritings instead of raw triple scans.

Verbalization: each answer row of a workload query becomes a pseudo-text
token sequence (entity/relation ids folded into the model vocab), packed
into fixed-length documents.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

BOS, EOS, SEP = 1, 2, 3
_RESERVED = 8


@dataclass
class PipelineConfig:
    seq_len: int = 128
    batch_size: int = 8
    vocab: int = 1024
    seed: int = 0


def _fold(ids: np.ndarray, vocab: int) -> np.ndarray:
    """Fold dictionary ids into the model vocab (stable hash)."""
    return (_RESERVED + (ids.astype(np.int64) * 2654435761) % (vocab - _RESERVED)
            ).astype(np.int32)


def verbalize_rows(rows: np.ndarray, vocab: int) -> np.ndarray:
    """(N,W) answer rows -> flat token stream [BOS r0c0 r0c1 .. SEP r1c0 ..]."""
    if len(rows) == 0:
        return np.zeros((0,), np.int32)
    n, w = rows.shape
    folded = _fold(rows.reshape(-1), vocab).reshape(n, w)
    seps = np.full((n, 1), SEP, np.int32)
    return np.concatenate([folded, seps], axis=1).reshape(-1)


class RDFTokenPipeline:
    """Streams training batches from a tuned QueryExecutor."""

    def __init__(self, executor, cfg: PipelineConfig):
        self.cfg = cfg
        # answer arity differs across queries: verbalize per query group
        toks = [np.array([BOS], np.int32)]
        for name in executor.groups:
            ans = sorted(executor.answer_group(name))
            if not ans:
                continue
            toks.append(verbalize_rows(np.asarray(list(ans), np.int32), cfg.vocab))
            toks.append(np.array([EOS, BOS], np.int32))
        self.stream = np.concatenate(toks)
        self.rng = np.random.default_rng(cfg.seed)

    def __iter__(self) -> Iterator[dict]:
        cfg = self.cfg
        need = cfg.batch_size * (cfg.seq_len + 1)
        stream = self.stream
        while len(stream) < need * 2:
            stream = np.concatenate([stream, self.stream])
        pos = 0
        while True:
            if pos + need > len(stream):
                pos = 0
            chunk = stream[pos: pos + need].reshape(cfg.batch_size, cfg.seq_len + 1)
            pos += need
            yield {"tokens": chunk[:, :-1].copy(), "labels": chunk[:, 1:].copy()}


class SyntheticPipeline:
    """Seeded random tokens (shape-compatible stand-in for any arch)."""

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)

    def __iter__(self) -> Iterator[dict]:
        cfg = self.cfg
        while True:
            toks = self.rng.integers(
                _RESERVED, cfg.vocab,
                size=(cfg.batch_size, cfg.seq_len + 1)).astype(np.int32)
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
