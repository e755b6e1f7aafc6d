#!/usr/bin/env python3
"""Drive the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on any failed check:

1. device  — require CUDA; print the card's name and power limit;
2. build   — compile the three kernels of `src/repro_torch/kernels/csrc/`
             with nvcc into `build/`, one nvcc per source, all at once;
3. kernel  — each CUDA kernel against its plain PyTorch version, exactly:
             `join_count` at B=2, L=S=2^19 and on edge cases,
             `scatter_append` at cap=2^19, W=3, k=256 (and k=0),
             `filter_mask` at N=2^20, W=3 with 0, 1 and 2 conditions;
             wrapper times (CUDA events), device times (CUDA-graph
             replay of the bare launcher) and bounds;
4. main    — the wizard's query path at 1,400 LUBM-style universities
             (1,013,987 triples): TuningSession.retune() -> apply() ->
             answer(q) for q1..q6, each equal to direct evaluation; the
             join probes must have gone through the kernel; a delta swap
             (remove q1, retune, apply) keeps the other answers exact; the
             views materialized on the device equal the host extents;
             then `join_count` at the shapes this path gave it;
5. maint   — streaming view maintenance on the same session at full
             scale: TuningSession.ingest() of ten seeded batches (a 1 %
             delete, its re-insertion in quarters, mixed batches) through
             the device insert engine, each batch first rehearsed with
             per-pass timers and a host-sync count and rolled back by the
             maintainer's transactional apply, then applied and timed
             unobserved; every extent equals re-evaluation,
             every device buffer its host mirror, q2..q6 direct
             evaluation; the appends must have gone through
             `scatter_append`; then retune() with the measured costs,
             apply(), one more batch and the same checks; then
             `scatter_append` at the shapes the stream gave it;
6. report  — a `{"kernels": [...]}` line, and as the last line
             `{"ok": true, "device": {...}}`.

Imports nothing of JAX or of the JAX package `repro`.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_UNIVERSITIES = 1400
EXPECTED_TRIPLES = 1_013_987
EXPECTED_ROWS = {"q1": 84_106, "q2": 16_906, "q3": 168_000, "q4": 25_200,
                 "q5": 50_400, "q6": 62_112}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
SENTINEL_HI = 2**31 - 1
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/join_count.cu"
REPLACES = "src/repro/kernels/join_count.py:82"
APPEND_SOURCE = "src/repro_torch/kernels/csrc/scatter_append.cu"
APPEND_REPLACES = "src/repro/kernels/scatter_append.py:69"
FILTER_SOURCE = "src/repro_torch/kernels/csrc/filter_mask.cu"
FILTER_REPLACES = "src/repro/kernels/filter_compact.py:51"
TT_CLASS_ROWS = 1 << 21     # capacity_for(1,013,987, safety=1.5)
BATCH = 512                 # steady-state batch of the maintenance stream


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def join_inputs(rng, B: int, L: int, S: int, key_space: int,
                invalid_frac: float = 0.1):
    """B probe rows (10% invalid = -1) and B ascending build rows with a
    SENTINEL_HI tail, as numpy int32."""
    import numpy as np

    probe = rng.integers(0, key_space, size=(B, L)).astype(np.int32)
    probe[rng.random((B, L)) < invalid_frac] = -1
    build = np.sort(rng.integers(0, key_space, size=(B, S)).astype(np.int32),
                    axis=1)
    for b in range(B):
        n_pad = int(rng.integers(0, max(S // 4, 1)))
        build[b, S - n_pad:] = SENTINEL_HI
    return probe, build


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls (CUDA
    events around the whole run, after `warm` untimed calls)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Device time per call of `fn`: `reps` calls captured in one CUDA
    graph and replayed between CUDA events, so no host enqueue is timed.
    `fn` is a kernel's bare launcher (or a plain version that reads no
    device value on the host)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = cuda_ms(graph.replay, reps=5, warm=1) / reps
    del graph
    return ms


def bound_ms(B: int, L: int, S: int) -> float:
    """Least time for the probe: read B*L probes and B*S build keys, write
    B*L lo and B*L counts (4 bytes each) at the card's memory rate."""
    return B * (12 * L + 4 * S) / HBM_BYTES_PER_S * 1e3


def append_bound_ms(cap: int, w: int) -> float:
    """Least time for the append: each of the cap*W output words is
    written once from one input word (of the buffer outside the appended
    window, of the delta rows inside it), 4 bytes each."""
    return 2 * cap * w * 4 / HBM_BYTES_PER_S * 1e3


def filter_bound_ms(n: int, w: int) -> float:
    """Least time for the mask: read N*W row words, write N mask words
    and one count per 512-row block."""
    return (n * w + n + -(-n // 512)) * 4 / HBM_BYTES_PER_S * 1e3


def count_syncs(fn):
    """Run `fn` with CUDA sync debugging on; returns (result, [file:line
    of each synchronizing call]) — this script's own synchronize calls
    excluded."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = []
    for w in caught:
        if "called a synchronizing CUDA operation" not in str(w.message):
            warnings.warn_explicit(w.message, w.category, w.filename,
                                   w.lineno, source=w.source)
        elif Path(w.filename).name != Path(__file__).name:
            where.append(f"{Path(w.filename).name}:{w.lineno}")
    return out, where


def compare_kernel(ops, ref, probe, build) -> int:
    """Run the kernel and the plain version on the same card tensors;
    return the largest absolute difference (must be 0)."""
    import torch

    lo, cnt = ops.join_count(probe, build)
    torch.cuda.synchronize()
    want_lo, want_cnt = ref.join_count_ref(probe, build)
    torch.cuda.synchronize()
    return max(int((lo.long() - want_lo.long()).abs().max()),
               int((cnt.long() - want_cnt.long()).abs().max()))


def append_inputs(rng, cap: int, n: int, dcap: int, w: int, dev):
    """A (cap, W) buffer with n valid rows and a -1 tail, and a (dcap, W)
    delta buffer, as int32 card tensors."""
    import numpy as np
    import torch

    buf = np.full((cap, w), -1, np.int32)
    buf[:n] = rng.integers(0, 1 << 20, (n, w))
    rows = rng.integers(0, 1 << 20, (dcap, w)).astype(np.int32)
    return torch.from_numpy(buf).to(dev), torch.from_numpy(rows).to(dev)


def compare_append(ops, ref, buf, n: int, rows, k: int) -> int:
    """The kernel against the plain version on the same card tensors; the
    input buffer must come back untouched.  Returns the max abs error."""
    import torch

    keep = buf.clone()
    got = ops.scatter_append(buf, n, rows, k)
    torch.cuda.synchronize()
    nk = torch.tensor([[n, k]], dtype=torch.int32, device=buf.device)
    want = ref.scatter_append_ref(buf, rows, nk)
    torch.cuda.synchronize()
    check(torch.equal(buf, keep), "scatter_append wrote into its input")
    return int((got.long() - want.long()).abs().max())


def time_append(ops, ref, sa, buf, n: int, rows, k: int, reps: int = 20
                ) -> dict:
    """Wrapper, device, plain and one-call library times of one append
    shape, and its bound."""
    import torch

    nk = torch.tensor([[n, k]], dtype=torch.int32, device=buf.device)
    idx = torch.arange(n, n + k, device=buf.device)
    delta = rows[:k]
    return {
        "ms": cuda_ms(lambda: ops.scatter_append(buf, n, rows, k), reps),
        "device_ms": graph_ms(lambda: sa.scatter_append_cuda(buf, rows, nk),
                              reps),
        "plain_ms": cuda_ms(lambda: ref.scatter_append_ref(buf, rows, nk),
                            reps),
        "library_ms": cuda_ms(lambda: buf.index_copy(0, idx, delta), reps),
        "bound_ms": append_bound_ms(buf.shape[0], buf.shape[1]),
    }


def kernel_phase_append(ops, ref, sa, dev) -> tuple[int, dict]:
    """scatter_append against its plain version at cap=2^19, W=3, k=256
    for n in {0, cap/2, cap-256}, and k=0.  Returns (max abs err, the
    times of the n=cap/2 case)."""
    import numpy as np

    rng = np.random.default_rng(2)
    cap, w, k = 1 << 19, 3, 256
    max_err, mid = 0, None
    for n in (0, cap // 2, cap - k):
        buf, rows = append_inputs(rng, cap, n, k, w, dev)
        err = compare_append(ops, ref, buf, n, rows, k)
        check(err == 0, f"scatter_append differs from its plain version at "
                        f"cap=2^19 n={n} k={k}: max abs err {err}")
        max_err = max(max_err, err)
        t = time_append(ops, ref, sa, buf, n, rows, k)
        if n == cap // 2:
            mid = t
        log(f"[kernel] scatter_append cap=2^19 W={w} k={k} n={n}: exact; "
            f"kernel {t['ms']:.4f} ms (device {t['device_ms']:.5f} ms), "
            f"plain {t['plain_ms']:.4f} ms, library (index_copy) "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms")
    buf, rows = append_inputs(rng, 4096, 1000, 256, w, dev)
    err = compare_append(ops, ref, buf, 1000, rows, 0)
    check(err == 0, "scatter_append with k=0 changed the buffer")
    buf, rows = append_inputs(rng, 700, 300, 256, 4, dev)
    err = max(err, compare_append(ops, ref, buf, 300, rows, 200))
    check(err == 0, "scatter_append differs at cap=700, W=4")
    log("[kernel] scatter_append k=0, cap=700 W=4: exact")
    return max(max_err, err), mid


def kernel_phase_filter(ops, ref, fm, dev) -> tuple[int, dict]:
    """filter_mask against its plain version at N=2^20, W=3 with 0, 1
    and 2 conditions.  Returns (max abs err, the times of the
    one-condition case)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(3)
    n, w = 1 << 20, 3
    rows_np = rng.integers(0, 4, (n, w)).astype(np.int32)
    rows_np[rng.random(n) < 0.2, 0] = -1
    rows = torch.from_numpy(rows_np).to(dev)
    max_err, one = 0, None
    for conds in ((), ((1, 2),), ((1, 2), (2, 0))):
        mask, counts = ops.filter_mask(rows, conds)
        torch.cuda.synchronize()
        want_mask, want_counts = ref.filter_mask_ref(rows, conds)
        err = max(int((mask.long() - want_mask.long()).abs().max()),
                  int((counts.long() - want_counts.long()).abs().max()))
        check(err == 0 and int(counts.sum()) == int(mask.sum()),
              f"filter_mask differs from its plain version with conds "
              f"{conds}: max abs err {err}")
        max_err = max(max_err, err)
        t = {"ms": cuda_ms(lambda: ops.filter_mask(rows, conds)),
             "device_ms": graph_ms(lambda: fm.filter_mask_cuda(rows, conds)),
             "plain_ms": cuda_ms(lambda: ref.filter_mask_ref(rows, conds)),
             "bound_ms": filter_bound_ms(n, w)}
        if len(conds) == 1:
            one = t
        log(f"[kernel] filter_mask N=2^20 W={w} {len(conds)} condition(s): "
            f"exact ({int(mask.sum())} rows pass); kernel {t['ms']:.4f} ms "
            f"(device {t['device_ms']:.5f} ms), plain {t['plain_ms']:.4f} "
            f"ms, library — (no one PyTorch call gives the mask and the "
            f"per-block counts), bound {t['bound_ms']:.6f} ms")
    return max_err, one


def mixed_batch(rng, store, size: int, frac_deletes: float = 0.3):
    """`size` triples as `benchmarks/bench_maintenance.py` builds them:
    fresh inserts in the store's id universe, deletes drawn from the live
    table."""
    import numpy as np

    n_del = min(int(size * frac_deletes), len(store.triples))
    n_ins = size - n_del
    tt = store.triples
    subjects = np.unique(tt[:, 0])
    preds = np.unique(tt[:, 1])
    objects = np.unique(tt[:, 2])
    ins = np.stack([rng.choice(subjects, n_ins), rng.choice(preds, n_ins),
                    rng.choice(objects, n_ins)], axis=1).astype(np.int32)
    dels = tt[rng.choice(len(tt), n_del, replace=False)]
    return ins, dels


def check_maintained(session, workload, label: str) -> None:
    """Every view's extent equals its re-evaluation over the current
    store, every device buffer its host mirror, and q2..q6 direct
    evaluation."""
    import numpy as np

    from repro_torch.query import ref_engine as R

    t0 = time.perf_counter()
    ex = session.executor
    m = session.maintainer()
    for vid, view in ex.state.views.items():
        m.check_alignment(vid)
        width = len(view.cq.head)
        want = np.unique(R.evaluate_cq(view.cq, ex.store).rows
                         .reshape(-1, width), axis=0)
        got = np.unique(ex.extents[vid].rows.reshape(-1, width), axis=0)
        check(got.shape == want.shape and bool((got == want).all()),
              f"{label}: view v{vid} differs from its re-evaluation "
              f"({len(got)} vs {len(want)} rows)")
    t_views = time.perf_counter() - t0
    for q in workload[1:]:
        got = session.answer(q.name)
        check(got == ex.answer_group_direct(q.name),
              f"{label}: {q.name} differs from direct evaluation")
    log(f"[maint] {label}: {len(ex.state.views)} extents == re-evaluation "
        f"and device buffers == host mirrors ({t_views:.3f} s); q2..q6 == "
        f"direct ({time.perf_counter() - t0 - t_views:.3f} s)")


SPLITS = ("delta", "delete", "tt_upload", "insert_candidates", "append",
          "costs")


class Rehearsal(Exception):
    """Raised at the end of a rehearsed batch, so the maintainer's
    transactional `apply` rolls the batch back."""


def rehearse(session, ins, dels, shapes: dict) -> dict:
    """Run one batch with every observation on, then roll it back.

    Each pass of `ViewMaintainer._apply` is timed on the host clock, with
    a device synchronize at its end so its device work counts to it; the
    host syncs are counted (CUDA sync debug mode) and the append shapes
    recorded into `shapes`.  The measured-cost pass runs on a copy of the
    cost model and then raises `Rehearsal`: `apply` restores the executor
    and the maintainer's bookkeeping, which is checked here.  Returns the
    seconds, the split, the sync sites and the launches."""
    import copy

    import torch

    from repro_torch.kernels import join_count as jc
    from repro_torch.kernels import ops
    from repro_torch.kernels import scatter_append as sa
    from repro_torch.maintenance import maintainer as maint_mod
    from repro_torch.rdf.triples import TripleStore

    m = session.maintainer()
    ex = m.executor
    split = dict.fromkeys(SPLITS, 0.0)

    def timed(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                split[name] += time.perf_counter() - t0
        return run

    real_costs = timed("costs", m._observe_costs)

    def costs_then_roll_back(report):
        saved = m.costs
        m.costs = copy.deepcopy(saved)
        try:
            real_costs(report)
        finally:
            m.costs = saved
        raise Rehearsal

    real_append = ops.scatter_append

    def recording(buf, n, rows, k):
        key = (buf.shape[0], rows.shape[0], buf.shape[1], int(k))
        shapes.setdefault(key, [0, int(n)])[0] += 1
        return real_append(buf, n, rows, k)

    def attempt() -> bool:
        try:
            session.ingest(ins, dels)
        except Rehearsal:
            return True
        return False

    state = (ex.store, ex.tt, dict(ex.extents), dict(ex.device_views),
             dict(m._ext_keys), m.tt_cap)
    real_eff, real_apply = maint_mod.effective_delta, TripleStore.apply_delta
    methods = {"_delete_pass": "delete", "_upload_tt": "tt_upload",
               "_insert_candidates_device": "insert_candidates",
               "_append_rows": "append"}
    la, lj = sa.launches, jc.launches
    maint_mod.effective_delta = timed("delta", real_eff)
    TripleStore.apply_delta = timed("delta", real_apply)
    for attr, name in methods.items():
        setattr(m, attr, timed(name, getattr(m, attr)))
    m._observe_costs = costs_then_roll_back
    ops.scatter_append = recording
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rolled_back, syncs = count_syncs(attempt)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        ops.scatter_append = real_append
        maint_mod.effective_delta = real_eff
        TripleStore.apply_delta = real_apply
        for attr in (*methods, "_observe_costs"):
            delattr(m, attr)
    check(rolled_back, "the rehearsed batch was not rolled back")
    store, tt, extents, views, keys, tt_cap = state
    check(ex.store is store and session.store is store and ex.tt is tt
          and m.tt_cap == tt_cap
          and all(a.keys() == b.keys() and all(a[k] is b[k] for k in a)
                  for a, b in ((ex.extents, extents),
                               (ex.device_views, views),
                               (m._ext_keys, keys))),
          "rolling the rehearsed batch back left the state changed")
    return {"seconds": seconds, "split": split, "syncs": syncs,
            "scatter_append": sa.launches - la,
            "join_count": jc.launches - lj}


def commit(session, ins, dels, counted: dict):
    """One `ingest`, unobserved: host seconds between two device
    synchronizes, and the launches of each kernel in `counted` (its
    count set to 0 just before the batch and read just after)."""
    import torch

    for mod in counted.values():
        mod.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = session.ingest(ins, dels)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return rep, seconds, {name: mod.launches for name, mod in counted.items()}


def run_batch(session, label: str, ins, dels, counted: dict,
              shapes: dict) -> dict:
    """One batch: rehearsed with the timers and the sync counter on and
    rolled back, then applied unobserved."""
    r = rehearse(session, ins, dels, shapes)
    rep, seconds, launches = commit(session, ins, dels, counted)
    split = r["split"]
    row = {"batch": label, "inserts": len(ins), "deletes": len(dels),
           "eff_inserts": rep.eff_inserts, "eff_deletes": rep.eff_deletes,
           "appended": sum(rep.appended.values()),
           "removed": sum(rep.removed.values()),
           "candidates": rep.delta_candidates,
           "growths": len(rep.extent_growths), "seconds": seconds,
           "rehearsal_seconds": r["seconds"], **split,
           "other": r["seconds"] - sum(split.values()),
           **launches, "syncs": len(r["syncs"]),
           "rehearsal_launches": {k: r[k] for k in ("scatter_append",
                                                    "join_count")}}
    sites: dict[str, int] = {}
    for w in r["syncs"]:
        sites[w] = sites.get(w, 0) + 1
    log(f"[maint] {label}: +{rep.eff_inserts}/-{rep.eff_deletes} effective, "
        f"appended {row['appended']}, removed {row['removed']}, "
        f"{row['candidates']} candidates, {row['growths']} growth(s); "
        f"{seconds:.4f} s unobserved; rehearsed and rolled back "
        f"{r['seconds']:.4f} s = " + ", ".join(f"{k} {split[k]:.4f}"
                                               for k in SPLITS)
        + f", other {row['other']:.4f}; launches " + json.dumps(launches)
        + f" (rehearsal {json.dumps(row['rehearsal_launches'])}); "
        f"{len(r['syncs'])} host syncs "
        + json.dumps(dict(sorted(sites.items(), key=lambda kv: -kv[1])[:6])))
    return row


def maint_phase(session, workload, jc, sa, fm) -> dict:
    """Streaming maintenance on the main path's session at full scale.
    Each batch is rehearsed with every observation on and rolled back,
    then applied unobserved.  Returns the launch counts of the stream
    (the applied batches) and the append shapes it gave the kernel."""
    import numpy as np
    import torch

    from repro_torch.api import MaintenanceConfig

    t0 = time.perf_counter()
    m = session.maintainer(MaintenanceConfig())
    torch.cuda.synchronize()
    ex = session.executor
    tt_bytes = sum(t.numel() * t.element_size() for t in ex.tt.values())
    log(f"[maint] bound the maintainer in {time.perf_counter() - t0:.3f} s: "
        f"engine {m.engine}, TT class {m.tt_cap:,} rows ({tt_bytes / 1e6:.1f}"
        f" MB in six indexes), {len(m.plans.plans)} delta plans over "
        f"{len(m.plans.leaves)} delta leaves, {len(m.plans.oracle_vids)} "
        f"oracle views")
    check(m.engine == "device", f"default config chose the {m.engine} "
                                f"insert engine on the card")
    check(m.tt_cap == TT_CLASS_ROWS, f"TT class {m.tt_cap}, expected "
                                     f"{TT_CLASS_ROWS}")
    for q in workload[1:]:
        check(session.answer(q.name) == ex.answer_group_direct(q.name),
              f"{q.name} differs from direct evaluation over the padded TT")
    log("[maint] q2..q6 exact over the padded TT")

    counted = {"scatter_append": sa, "join_count": jc, "filter_mask": fm}
    shapes: dict[tuple, list] = {}
    rows: list[dict] = []
    rng = np.random.default_rng(1)
    live = session.store.triples
    held = live[rng.choice(len(live), round(0.01 * len(live)),
                           replace=False)]
    quarters = np.array_split(held, 4)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    rows.append(run_batch(session, "b1 delete 1% (H)", held[:0], held,
                          counted, shapes))
    for i, part in enumerate(quarters):
        cur = session.store.triples
        dels = cur[rng.choice(len(cur), BATCH, replace=False)]
        rows.append(run_batch(session, f"b{i + 2} re-insert H/4", part,
                              dels, counted, shapes))
        if i == 0:
            rec = m.telemetry()["delta_recompiles"]
            check(rec == 0, f"{rec} delta-program recompiles after batch 2")
    for b in range(6, 11):
        ins, dels = mixed_batch(rng, session.store, BATCH)
        rows.append(run_batch(session, f"b{b} mixed {BATCH}", ins, dels,
                              counted, shapes))
    stream = {name: sum(r[name] for r in rows) for name in counted}
    peak = torch.cuda.max_memory_allocated()
    tele = m.telemetry()
    log(f"[maint] stream of 10 batches: launches {json.dumps(stream)}; "
        f"peak device memory {peak / 2**20:.1f} MiB "
        f"({(peak - base_mem) / 2**20:.1f} MiB above the bound state); "
        f"total {sum(r['seconds'] for r in rows):.3f} s unobserved, "
        f"{sum(r['rehearsal_seconds'] for r in rows):.3f} s rehearsed")
    log("[maint] telemetry (rehearsals included) " + json.dumps(tele))
    log("[maint] batches " + json.dumps(rows))
    check(stream["scatter_append"] > 0,
          "the stream launched no scatter_append kernel")
    check(stream["filter_mask"] == 0,
          f"the stream launched filter_mask {stream['filter_mask']} times; "
          f"no path calls it")
    check(tele["delta_recompiles"] == 0,
          f"{tele['delta_recompiles']} delta-program recompiles")
    check(tele["delta_compiles"] == 1,
          f"{tele['delta_compiles']} delta-program compiles")
    check_maintained(session, workload, "after the stream")

    # retune against the measured costs, apply, one more batch
    check(len(session.maintenance_costs) > 0
          and session._search_cfg().maint_model is session.maintenance_costs,
          "retune does not see the measured maintenance costs")
    t0 = time.perf_counter()
    rep = session.retune()
    app = session.apply()
    torch.cuda.synchronize()
    log(f"[maint] retune + apply with {len(session.maintenance_costs)} "
        f"measured view costs in {time.perf_counter() - t0:.3f} s: "
        f"{rep.summary()}; {app.summary()}")
    check(session.maintainer() is m and m.executor is session.executor,
          "apply() did not rebind the session's maintainer")
    ins, dels = mixed_batch(rng, session.store, BATCH)
    after = run_batch(session, f"b11 mixed {BATCH} after the rebind", ins,
                      dels, counted, {})
    check(after["eff_inserts"] + after["eff_deletes"] > 0,
          "the batch after the rebind changed nothing")
    check_maintained(session, workload, "after the rebind")
    return {"launches": stream, "shapes": shapes, "rows": rows,
            "after": after}


def append_shape_phase(ops, ref, sa, shapes: dict, dev) -> tuple[int, dict]:
    """scatter_append at every (cap, dcap, W, k) the stream gave it, on
    fresh inputs with the stream's n: exact against the plain version;
    times summed over the stream's calls, printed per (cap, dcap, W)
    class."""
    import numpy as np
    import torch

    rng = np.random.default_rng(4)
    max_err = 0
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms")
    totals = dict.fromkeys(keys, 0.0)
    totals["calls"] = 0
    classes: dict[tuple, dict] = {}
    for (cap, dcap, w, k), (count, n) in sorted(shapes.items()):
        buf, rows = append_inputs(rng, cap, n, dcap, w, dev)
        err = compare_append(ops, ref, buf, n, rows, k)
        check(err == 0, f"scatter_append differs at stream shape cap={cap} "
                        f"dcap={dcap} W={w} k={k}")
        max_err = max(max_err, err)
        nk = torch.tensor([[n, k]], dtype=torch.int32, device=dev)
        idx = torch.arange(n, n + k, device=dev)
        delta = rows[:k]
        got = {"ms": cuda_ms(lambda: ops.scatter_append(buf, n, rows, k),
                             10),
               "plain_ms": cuda_ms(
                   lambda: ref.scatter_append_ref(buf, rows, nk), 10),
               "library_ms": cuda_ms(lambda: buf.index_copy(0, idx, delta),
                                     10),
               "bound_ms": append_bound_ms(cap, w),
               "device_ms": graph_ms(
                   lambda: sa.scatter_append_cuda(buf, rows, nk))}
        c = classes.setdefault((cap, dcap, w), {"calls": 0, "k": [],
                                                **dict.fromkeys(keys, 0.0)})
        c["calls"] += count
        c["k"].append(k)
        for key in keys:
            c[key] += count * got[key]
            totals[key] += count * got[key]
        totals["calls"] += count
    for (cap, dcap, w), c in classes.items():
        log(f"[shape] scatter_append cap={cap} dcap={dcap} W={w}: "
            f"{c['calls']} calls, k {min(c['k'])}..{max(c['k'])}, exact; "
            f"summed kernel {c['ms']:.4f} ms (device, CUDA graph "
            f"{c['device_ms']:.4f} ms), plain {c['plain_ms']:.4f} ms, "
            f"library (index_copy) {c['library_ms']:.4f} ms, bound "
            f"{c['bound_ms']:.6f} ms")
    log(f"[shape] scatter_append over the stream's {totals['calls']} calls "
        f"({len(shapes)} shapes): kernel {totals['ms']:.4f} ms (device, "
        f"CUDA graph {totals['device_ms']:.4f} ms), plain "
        f"{totals['plain_ms']:.4f} ms, library {totals['library_ms']:.4f} "
        f"ms, bound {totals['bound_ms']:.6f} ms")
    return max_err, totals


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    import repro_torch
    from repro_torch.api import TuningSession
    from repro_torch.kernels import filter_mask as fm
    from repro_torch.kernels import join_count as jc
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import scatter_append as sa
    from repro_torch.rdf.generator import generate, lubm_workload
    from repro_torch.views.materializer import materialize_state_device

    # ---- 1. device ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip() != "",
          f"nvidia-smi failed: {smi.stderr.strip()}")
    card_line = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} | nvidia-smi: {card_line} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | "
        f"devices {torch.cuda.device_count()}")

    dev = repro_torch.device()

    # ---- 2. build: one nvcc per kernel source, all at once ------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        libs = list(pool.map(lambda mod: mod.build(), (jc, sa, fm)))
    log(f"[build] {', '.join(str(lib.relative_to(ROOT)) for lib in libs)} "
        f"in {time.perf_counter() - t0:.3f} s")

    # ---- 3. kernel against its plain version -------------------------
    rng = np.random.default_rng(0)
    max_err = 0
    cases = [("B2 L=S=2^19 keys 4", 2, 1 << 19, 1 << 19, 4),
             ("B2 L=S=2^19 keys 1e6", 2, 1 << 19, 1 << 19, 10**6),
             ("L=S=1", 1, 1, 1, 4),
             ("L,S not multiples of 256", 3, 1000, 777, 50)]
    for label, B, L, S, ks in cases:
        p, b = join_inputs(rng, B, L, S, ks)
        probe = torch.from_numpy(p).to(dev)
        build = torch.from_numpy(b).to(dev)
        err = compare_kernel(ops, ref, probe, build)
        check(err == 0, f"join_count differs from its plain version on "
                        f"{label}: max abs err {err}")
        max_err = max(max_err, err)
        if L >= 1 << 19:
            k_ms = cuda_ms(lambda: ops.join_count(probe, build))
            p_ms = cuda_ms(lambda: ref.join_count_ref(probe, build))
            k_dev = graph_ms(lambda: jc.join_count_cuda(probe, build))
            log(f"[kernel] {label}: exact; kernel {k_ms:.4f} ms (device "
                f"{k_dev:.5f} ms), plain/library (torch.searchsorted x2) "
                f"{p_ms:.4f} ms, bound {bound_ms(B, L, S):.4f} ms")
        else:
            log(f"[kernel] {label}: exact")
    all_invalid = torch.full((2, 1000), -1, dtype=torch.int32, device=dev)
    ascending = torch.arange(512, dtype=torch.int32, device=dev).repeat(2, 1)
    err = compare_kernel(ops, ref, all_invalid, ascending)
    _lo, cnt = ops.join_count(all_invalid, ascending)
    check(err == 0 and int(cnt.sum()) == 0, "all-invalid probes matched")
    dup_p = torch.full((1, 200), 7, dtype=torch.int32, device=dev)
    dup_b = torch.full((1, 300), 7, dtype=torch.int32, device=dev)
    err = max(err, compare_kernel(ops, ref, dup_p, dup_b))
    lo, cnt = ops.join_count(dup_p, dup_b)
    check(err == 0 and int(lo.max()) == 0 and bool((cnt == 300).all()),
          "duplicate-heavy case")
    log("[kernel] all-invalid, duplicate-heavy: exact")
    append_err, append_2p19 = kernel_phase_append(ops, ref, sa, dev)
    filter_err, filter_2p20 = kernel_phase_filter(ops, ref, fm, dev)

    # ---- 4. main path -------------------------------------------------
    steps: dict[str, float] = {}
    t0 = time.perf_counter()
    uni = generate(n_universities=N_UNIVERSITIES, seed=0)
    steps["generate"] = time.perf_counter() - t0
    store = uni.store
    check(len(store) == EXPECTED_TRIPLES,
          f"store has {len(store)} triples, expected {EXPECTED_TRIPLES}")
    workload = lubm_workload(uni.dictionary)
    t0 = time.perf_counter()
    _ = store.stats
    steps["statistics"] = time.perf_counter() - t0
    log(f"[main] {len(store):,} triples from {N_UNIVERSITIES} universities "
        f"(generate {steps['generate']:.2f} s, statistics "
        f"{steps['statistics']:.2f} s)")

    torch.cuda.reset_peak_memory_stats()
    for mod in (jc, sa, fm):
        mod.launches = 0
    session = TuningSession(store, workload, schema=uni.schema,
                            type_id=uni.type_id, device="cuda")
    t0 = time.perf_counter()
    rep = session.retune()
    steps["retune"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    app = session.apply()
    torch.cuda.synchronize()
    steps["apply"] = time.perf_counter() - t0
    log(f"[main] retune {steps['retune']:.3f} s: {rep.summary()}")
    log(f"[main] apply {steps['apply']:.3f} s: {app.summary()}")
    direct: dict[str, set] = {}
    steps["answer"] = steps["direct"] = 0.0
    for q in workload:
        t0 = time.perf_counter()
        got = session.answer(q.name)
        dt = time.perf_counter() - t0
        steps["answer"] += dt
        t0 = time.perf_counter()
        direct[q.name] = session.executor.answer_group_direct(q.name)
        steps["direct"] += time.perf_counter() - t0
        check(got == direct[q.name],
              f"{q.name}: answer differs from direct evaluation")
        check(len(got) == EXPECTED_ROWS[q.name],
              f"{q.name}: {len(got)} rows, expected {EXPECTED_ROWS[q.name]}")
        log(f"[main] {q.name}: {len(got):,} rows == direct ({dt:.4f} s)")
    main_launches = {"join_count": jc.launches, "scatter_append": sa.launches,
                     "filter_mask": fm.launches}
    check(main_launches["join_count"] > 0,
          "the main path launched no join_count kernel")
    check(main_launches["filter_mask"] == 0,
          f"the main path launched filter_mask {main_launches['filter_mask']}"
          f" times; no path calls it")
    ex = session.executor
    tele = ex.telemetry()
    prog = ex.workload._prog
    log(f"[main] launches on the main path: {json.dumps(main_launches)}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f}"
        f" MiB")
    log("[main] telemetry " + json.dumps(
        {k: v for k, v in tele.items() if k != "bucket_compile_log"}))
    log("[main] buckets " + json.dumps(
        [[b.kind, b.wave, b.cap, len(b.node_ids)] for b in prog.buckets]))

    # delta swap: drop q1, warm retune, apply
    t0 = time.perf_counter()
    session.remove_query("q1")
    rep2 = session.retune()
    steps["retune_delta"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    app2 = session.apply()
    torch.cuda.synchronize()
    steps["apply_delta"] = time.perf_counter() - t0
    log(f"[delta] retune {steps['retune_delta']:.3f} s: {rep2.summary()}")
    log(f"[delta] apply {steps['apply_delta']:.3f} s: {app2.summary()}")
    for q in workload[1:]:
        got = session.answer(q.name)
        check(got == direct[q.name], f"{q.name}: answer after the delta "
                                     f"swap differs from direct evaluation")
    log(f"[delta] q2..q6 exact after the swap; launches so far "
        f"{jc.launches}")

    # views materialized by the device program equal the host extents
    t0 = time.perf_counter()
    before = jc.launches
    dev_ext, _, _ = materialize_state_device(session.best, store,
                                             device="cuda")
    torch.cuda.synchronize()
    steps["materialize_device"] = time.perf_counter() - t0
    for vid, host in session.executor.extents.items():
        a = np.unique(dev_ext[vid].rows, axis=0)
        b = np.unique(host.rows, axis=0)
        check(dev_ext[vid].cols == host.cols and a.shape == b.shape
              and bool((a == b).all()),
              f"view v{vid}: device extent differs from the host extent")
    log(f"[views] {len(dev_ext)} device extents == host extents "
        f"({steps['materialize_device']:.3f} s, "
        f"{jc.launches - before} join_count launches)")

    # ---- 5. the kernel at the main path's shapes ----------------------
    captured = []
    real = ops.join_count

    def recording(probe, build):
        captured.append((probe.clone(), build.clone()))
        return real(probe, build)

    ops.join_count = recording
    try:
        ex.workload.run(ex.tt, ex.device_views)
    finally:
        ops.join_count = real
    torch.cuda.synchronize()
    check(len(captured) > 0, "no join probe on the main path to measure")
    totals = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
              "library_ms": 0.0, "bound_ms": 0.0}
    for probe, build in captured:
        B, L = probe.shape
        S = build.shape[1]
        err = compare_kernel(ops, ref, probe, build)
        check(err == 0, f"join_count differs at main-path shape "
                        f"B={B} L={L} S={S}")
        max_err = max(max_err, err)
        k_ms = cuda_ms(lambda: ops.join_count(probe, build), reps=50)
        p_ms = cuda_ms(lambda: ref.join_count_ref(probe, build), reps=50)
        lib_ms = cuda_ms(lambda: (
            torch.searchsorted(build, probe, side="left", out_int32=True),
            torch.searchsorted(build, probe, side="right", out_int32=True)),
            reps=50)
        k_dev = graph_ms(lambda: jc.join_count_cuda(probe, build))
        bd = bound_ms(B, L, S)
        totals["ms"] += k_ms
        totals["device_ms"] += k_dev
        totals["plain_ms"] += p_ms
        totals["library_ms"] += lib_ms
        totals["bound_ms"] += bd
        log(f"[shape] B={B} L={L} S={S}: exact; kernel {k_ms:.4f} ms "
            f"(device {k_dev:.5f} ms), plain {p_ms:.4f} ms, library "
            f"{lib_ms:.4f} ms, bound {bd:.6f} ms")

    # where the time of one workload run goes on the device
    from torch.profiler import ProfilerActivity, profile

    runs_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.workload.run(ex.tt, ex.device_views)
        torch.cuda.synchronize()
        runs_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[trace] one workload run (unprofiled, 5 runs): "
        f"{' '.join(f'{m:.3f}' for m in runs_ms)} ms")
    # the program's only host sync is the one transfer of all overflow
    # flags per execute, as in the JAX package
    torch.cuda.synchronize()
    _, syncs = count_syncs(lambda: ex.workload.run(ex.tt, ex.device_views))
    log(f"[syncs] one workload run: {len(syncs)} synchronizing operation(s) "
        + " ".join(syncs))
    check(len(syncs) == 1, f"a workload run made {len(syncs)} host syncs, "
                           f"expected 1 (the overflow flags)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ex.workload.run(ex.tt, ex.device_views)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    by_name: dict[str, float] = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"[trace] one workload run (profiled): wall {wall_ms:.3f} ms "
        f"(the process's first profiler session: its start-up included), "
        f"device busy {busy_ms:.3f} ms in {len(kern)} device events")
    for nm, us in top:
        log(f"[trace]   {us / 1e3:.4f} ms  {nm[:100]}")
    log("[steps] " + json.dumps({k: round(v, 4) for k, v in steps.items()}))

    # ---- 5. streaming maintenance ------------------------------------
    t0 = time.perf_counter()
    maint = maint_phase(session, workload, jc, sa, fm)
    steps["maint"] = time.perf_counter() - t0
    shape_err, append_stream = append_shape_phase(ops, ref, sa,
                                                  maint["shapes"], dev)
    append_err = max(append_err, shape_err)
    log(f"[maint] phase {steps['maint']:.3f} s")

    kernels = [{
        "name": "join_count", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": main_launches["join_count"],
        "max_abs_err": max_err, "ms": totals["ms"],
        "plain_ms": totals["plain_ms"], "bound_ms": totals["bound_ms"],
        "bound_by": "bytes", "library_ms": totals["library_ms"],
        "device_ms": totals["device_ms"],
        "main_path_calls": len(captured),
        "maint_launches": maint["launches"]["join_count"],
    }, {
        "name": "scatter_append", "route": "cuda", "source": APPEND_SOURCE,
        "replaces": APPEND_REPLACES,
        "launches": maint["launches"]["scatter_append"],
        "max_abs_err": append_err, "ms": append_stream["ms"],
        "plain_ms": append_stream["plain_ms"],
        "bound_ms": append_stream["bound_ms"], "bound_by": "bytes",
        "library_ms": append_stream["library_ms"],
        "device_ms": append_stream["device_ms"],
        "main_path_calls": append_stream["calls"],
        "at_2p19": append_2p19,
    }, {
        "name": "filter_mask", "route": "cuda", "source": FILTER_SOURCE,
        "replaces": FILTER_REPLACES,
        "launches": main_launches["filter_mask"],
        "max_abs_err": filter_err, "ms": filter_2p20["ms"],
        "plain_ms": filter_2p20["plain_ms"],
        "bound_ms": filter_2p20["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "device_ms": filter_2p20["device_ms"],
        "maint_launches": maint["launches"]["filter_mask"],
        "shape": "N=2^20 W=3, one condition",
    }]
    log(card_line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
