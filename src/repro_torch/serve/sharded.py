"""Sharded serving backend: the workload answered over a mesh of shards.

The counterpart of `repro/serve/sharded.py`.  `ShardedBackend` serves a
tuned `QueryExecutor` from a subject-sharded copy of its store: the
triple table is hash(subject)-partitioned and every view extent
hash-partitioned on its first head column via
`repro_torch.query.distributed` (`shard_store_by_subject`,
`shard_prel_rows`), and each workload rewriting is compiled once,
lazily, into one program over all shards (`build_distributed_executor`)
with co-partition elision where the plan's join keys line up with the
partitioning.  The shards sit stacked on the mesh's one device
(`repro_torch.launch.mesh`); each join probe of the program is one
`join_count` launch for all of them.

It speaks the same protocol as `QueryServer` — `answer_batch(names)`,
`stats: ServeStats`, `readiness()` — so `ServingFrontend` fronts either
interchangeably, and it reuses the `ServingSupervisor` fault vocabulary
with PER-SHARD granularity:

  * every batch starts with an integrity probe comparing each device
    shard's live row count against its host mirror (`TripleStore` per
    shard, kept from `shard_store_by_subject(with_shards=True)`); the
    counts are taken on the device and read back as one `(ndev,)`
    vector;
  * a corrupt/lost shard maps to a per-shard ladder tier
    (`observe_shard`) — the batch is answered EXACTLY by the host
    reference engine over the full mirror, and the supervisor `rollup`
    reports DEGRADED while a quorum of shards still serves, NOT
    whole-server DOWN;
  * restored shards flip the rollup back to HEALTHY on the next batch.

A fault of the card (`repro_torch.kernels._build.is_device_fault`: a
kernel that cannot be built, loaded or launched, or a CUDA fault that
surfaces at a later read-back) is not absorbed by the host fallback, as
in `QueryServer`: the batch takes every shard and the server DOWN and
re-raises it.  A capacity overflow and every other error of the device
program fall back to the host reference engine, as in the JAX package.

`corrupt_shard` / `restore_shard` are deterministic test hooks that
damage exactly one shard's device slabs in place.
"""
from __future__ import annotations

from typing import NoReturn

import numpy as np
import torch

from repro_torch.distributed.fault import RetryPolicy, ServingSupervisor
from repro_torch.errors import ServiceUnavailable
from repro_torch.kernels._build import is_device_fault
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.query import distributed as D
from repro_torch.query.engine import SENTINEL_HI
from repro_torch.serve.query_server import ServeStats


class ShardedBackend:
    def __init__(self, executor, mesh=None, axis: str = "data",
                 policy: RetryPolicy | None = None):
        self.executor = executor
        if mesh is None:
            mesh = make_host_mesh(axis=axis, device=executor.device)
        self.mesh = mesh
        self.axis = axis
        self.ndev = int(mesh.shape[axis])
        self.supervisor = ServingSupervisor(policy or RetryPolicy())
        self.stats = ServeStats()
        self._fns: dict[str, object] = {}     # member -> sharded program

        # device TT shards + host per-shard mirrors (probe targets and
        # the exact fallback when a shard degrades)
        self._tt_host = None
        self._shards = None
        self._load()

    # ------------------------------------------------------------------
    # device state
    # ------------------------------------------------------------------
    def _load(self) -> None:
        tt, shards = D.shard_store_by_subject(
            self.executor.store, self.mesh, self.axis, with_shards=True)
        self._shards = shards
        # keep the stacked host arrays so shard-level corruption hooks
        # and re-uploads can surgically touch one shard's slab
        self._cap = tt["spo"].shape[1]
        self._tt_host = {k: v.cpu().numpy().copy() for k, v in tt.items()}
        self._tt = tt
        self._views = {}
        self._partition_cols: dict[int, str] = {}
        for vid, rel in self.executor.extents.items():
            width = max(len(rel.cols), 1)
            self._views[vid] = D.shard_prel_rows(
                rel.rows, 0, self.mesh, self.axis, width=width)
            if len(rel.cols):
                self._partition_cols[vid] = rel.cols[0]
        self._fns.clear()

    def _upload_tt(self) -> None:
        self._tt = {k: torch.from_numpy(v).to(self.mesh.device, copy=True)
                    for k, v in self._tt_host.items()}

    def _fn(self, member: str):
        fn = self._fns.get(member)
        if fn is None:
            plan = self.executor.state.rewritings[member]
            fn = D.build_distributed_executor(
                plan, self.executor.store.stats, self.executor.infos,
                self.mesh, self.axis, partition_cols=self._partition_cols,
                use_kernels=self.executor._use_kernels)
            self._fns[member] = fn
        return fn

    # ------------------------------------------------------------------
    # per-shard integrity probe + fault hooks
    # ------------------------------------------------------------------
    def _probe(self) -> set[int]:
        """Shards whose device slab disagrees with the host mirror.
        Live rows are non-sentinel in the spo index; each shard must
        hold exactly its mirror's triple count.  One read of the
        `(ndev,)` counts."""
        live = (self._tt["spo"][..., 0] != SENTINEL_HI).sum(dim=1)
        return {d for d, n in enumerate(live.cpu().tolist())
                if n != len(self._shards[d])}

    def corrupt_shard(self, d: int) -> None:
        """Deterministically damage shard `d`'s device slabs (every
        index order) — the probe sees a row-count mismatch next batch."""
        for name in self._tt_host:
            self._tt_host[name][d] = 0
        self._upload_tt()

    def restore_shard(self, d: int) -> None:
        """Undo `corrupt_shard`: rebuild shard `d`'s slabs from the host
        mirror and re-upload."""
        for name in self._tt_host:
            slab = np.full((self._cap, 3), SENTINEL_HI, dtype=np.int32)
            idx = self._shards[d].index(name)
            slab[: len(idx)] = idx
            self._tt_host[name][d] = slab
        self._upload_tt()

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def _answer_device(self, names: list[str]) -> dict[str, set]:
        answers: dict[str, set] = {}
        for name in names:
            out: set = set()
            for member in self.executor.groups[name]:
                if member in self.executor._oracle_names:
                    # cartesian rewritings never lower to the sharded
                    # engine; the host reference engine is exact
                    out |= self.executor.answer_direct(member)
                    continue
                rel = self._fn(member)(self._tt, self._views)
                if bool(rel.overflow.any()):
                    raise RuntimeError(f"{member}: sharded capacity overflow")
                rows = D.gather_result(rel)
                out |= {tuple(r) for r in rows.tolist()}
            answers[name] = out
        return answers

    def answer_batch(self, names: list[str]) -> list[set | None]:
        """Answer a batch over the shards.  All shards healthy: one
        sharded device program per rewriting.  Any shard degraded (or a
        device program failure that is not a fault of the card): exact
        host fallback over the full mirror, per-shard tiers recorded,
        health rolls up to DEGRADED while a quorum holds — never DOWN
        for one lost shard.  A fault of the card takes it DOWN and is
        re-raised."""
        self.supervisor.begin_batch()
        try:
            bad = self._probe()
        except Exception as exc:
            if is_device_fault(exc):
                self._device_down(names, exc)
            raise
        known = [n for n in names if n in self.executor.groups]
        tier_by_shard = {d: (2 if d in bad else 0) for d in range(self.ndev)}
        device_ok = not bad
        answers: dict[str, set] = {}
        if device_ok:
            try:
                answers = self._answer_device(known)
            except Exception as exc:
                if is_device_fault(exc):
                    self._device_down(names, exc)
                device_ok = False
                self.stats.fused_failures += 1
                self._note_fault("sharded_device", exc)
                tier_by_shard = {d: 1 for d in range(self.ndev)}
        if not device_ok:
            try:
                answers = {n: self.executor.answer_group_direct(n)
                           for n in known}
            except Exception as exc:
                for d in range(self.ndev):
                    self.supervisor.observe_shard(d, None)
                self.supervisor.rollup(reason=f"host fallback failed: {exc}")
                self._finish(names, known, tier=None)
                raise ServiceUnavailable(
                    f"sharded device path and host fallback failed: {exc}"
                ) from exc
        for d, t in tier_by_shard.items():
            self.supervisor.observe_shard(d, t)
        self.supervisor.rollup()
        out: list[set | None] = []
        for n in names:
            if n in self.executor.groups:
                out.append(answers[n])
            else:
                self.stats.unknown += 1
                out.append(None)
        if not device_ok:
            self.stats.degraded_answers += len(known)
        self._finish(names, known, tier=0 if device_ok else 2)
        return out

    def _device_down(self, names, exc: Exception) -> NoReturn:
        """The card failed (`is_device_fault`): every shard lives on it,
        so every shard and the server go DOWN and the error surfaces
        instead of the host fallback answering."""
        self._note_fault("device", exc)
        for d in range(self.ndev):
            self.supervisor.observe_shard(d, None)
        self.supervisor.rollup(reason="device fault")
        self._finish(names, [], tier=None)
        raise exc

    def _note_fault(self, kind: str, exc: Exception) -> None:
        self.stats.faults.append(f"{kind}: {exc}")
        del self.stats.faults[:-64]

    def _finish(self, names, known, tier) -> None:
        self.stats.requests += len(names)
        self.stats.batches += 1
        self.stats.served_tier = tier if tier is not None else -1
        self.stats.health = self.supervisor.health
        self.stats.last_batch = {"tier": tier,
                                 "degraded": tier not in (0, None),
                                 "stale": False}

    def answer(self, name: str) -> set | None:
        return self.answer_batch([name])[0]

    # ------------------------------------------------------------------
    def readiness(self) -> dict:
        return {
            "ready": self.supervisor.ready(),
            "health": self.supervisor.health,
            "shards": dict(self.supervisor.shard_health),
            "quorum": self.supervisor.quorum(),
            "ndev": self.ndev,
            "batches": self.supervisor.batches,
        }

    # no update stream: sharded serving is static-store for now; the
    # frontend surfaces this as a loud error instead of silent drops
    def submit(self, inserts=None, deletes=None) -> None:
        raise RuntimeError(
            "ShardedBackend has no update stream; serve maintenance "
            "through QueryServer (maintenance=) instead")
