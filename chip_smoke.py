#!/usr/bin/env python3
"""Drive the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on any failed check:

1. device  — require CUDA; print the card's name and power limit;
2. build   — compile the join-probe kernel from `src/repro_torch/kernels/
             csrc/` with nvcc into `build/` (seconds);
3. kernel  — the CUDA `join_count` against its plain PyTorch version,
             exactly, at B=2, L=S=2^19 and on edge cases; times and bound;
4. main    — the wizard's query path at 1,400 LUBM-style universities
             (1,013,987 triples): TuningSession.retune() -> apply() ->
             answer(q) for q1..q6, each equal to direct evaluation; the
             join probes must have gone through the kernel; a delta swap
             (remove q1, retune, apply) keeps the other answers exact; the
             views materialized on the device equal the host extents;
5. report  — the kernel at the shapes the main path gave it (exact match,
             times, bound), a `{"kernels": [...]}` line, and as the last
             line `{"ok": true, "device": {...}}`.

Imports nothing of JAX or of the JAX package `repro`.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
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


def device_ms(fn, name: str | None = None, reps: int = 20):
    """Mean device time per call of `fn`, summed over the kernels it
    launches (only those whose name contains `name`, if given), from a
    `torch.profiler` trace; None when the trace shows no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and (name is None or name in e.name)]
    if not kernels:
        return None
    return sum(e.time_range.elapsed_us() for e in kernels) / reps / 1e3


def host_us(fn, reps: int = 200) -> float:
    """Mean host time of one call of `fn` (enqueue only, no sync)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def bound_ms(B: int, L: int, S: int) -> float:
    """Least time for the probe: read B*L probes and B*S build keys, write
    B*L lo and B*L counts (4 bytes each) at the card's memory rate."""
    return B * (12 * L + 4 * S) / HBM_BYTES_PER_S * 1e3


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


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    import repro_torch
    from repro_torch.api import TuningSession
    from repro_torch.kernels import join_count as jc
    from repro_torch.kernels import ops, ref
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

    # ---- 2. build -----------------------------------------------------
    t0 = time.perf_counter()
    lib = jc.build()
    log(f"[build] {lib.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.3f} s")

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
            k_dev = device_ms(lambda: ops.join_count(probe, build),
                              "join_count_kernel")
            p_dev = device_ms(lambda: ref.join_count_ref(probe, build))
            log(f"[kernel] {label}: exact; kernel {k_ms:.4f} ms (device "
                f"{k_dev} ms), plain/library (torch.searchsorted x2) "
                f"{p_ms:.4f} ms (device {p_dev} ms), bound "
                f"{bound_ms(B, L, S):.4f} ms")
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
    jc.launches = 0
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
    main_launches = jc.launches
    check(main_launches > 0, "the main path launched no join_count kernel")
    ex = session.executor
    tele = ex.telemetry()
    prog = ex.workload._prog
    log(f"[main] join_count launches on the main path: {main_launches}; "
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
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
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
        k_dev = device_ms(lambda: ops.join_count(probe, build),
                          "join_count_kernel")
        p_dev = device_ms(lambda: ref.join_count_ref(probe, build))
        k_host = host_us(lambda: ops.join_count(probe, build))
        launch_host = host_us(lambda: jc.join_count_cuda(probe, build))
        p_host = host_us(lambda: ref.join_count_ref(probe, build))
        bd = bound_ms(B, L, S)
        totals["ms"] += k_ms
        totals["plain_ms"] += p_ms
        totals["library_ms"] += lib_ms
        totals["bound_ms"] += bd
        if k_dev is not None:
            totals["device_ms"] = totals.get("device_ms", 0.0) + k_dev
        log(f"[shape] B={B} L={L} S={S}: exact; kernel {k_ms:.4f} ms "
            f"(device {k_dev} ms; host enqueue {k_host:.1f} us, of which "
            f"the launch without the operand checks {launch_host:.1f} us), "
            f"plain {p_ms:.4f} ms (device {p_dev} ms; host enqueue "
            f"{p_host:.1f} us), library {lib_ms:.4f} ms, "
            f"bound {bd:.6f} ms")

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
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            ex.workload.run(ex.tt, ex.device_views)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    log(f"[syncs] one workload run: {len(syncs)} synchronizing operation(s) "
        + " ".join(f"{Path(w.filename).name}:{w.lineno}" for w in syncs))
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
    log(f"[trace] one workload run (profiled): wall {wall_ms:.3f} ms, "
        f"device busy {busy_ms:.3f} ms in {len(kern)} device events")
    for nm, us in top:
        log(f"[trace]   {us / 1e3:.4f} ms  {nm[:100]}")
    log("[steps] " + json.dumps({k: round(v, 4) for k, v in steps.items()}))

    kernels = [{
        "name": "join_count", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": main_launches,
        "max_abs_err": max_err, "ms": totals["ms"],
        "plain_ms": totals["plain_ms"], "bound_ms": totals["bound_ms"],
        "bound_by": "bytes", "library_ms": totals["library_ms"],
        "device_ms": totals.get("device_ms"),
        "main_path_calls": len(captured),
    }]
    log(card_line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
