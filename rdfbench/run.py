"""Run one cell of the benchmark once and print its result line.

    python3 -m rdfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cell's CUDA cards.
The run makes its data from the seed, sets the port up (timed as
`setup_s`), warms every shape the cell's traffic uses, then sends that
traffic for `--seconds` (closed loop, one client).  Once the window has
closed it reads the device's peak memory, checks that no module of JAX
or of the JAX package was loaded, and compares the window's answers
with the plain reference (`check.py`).  The last line of standard
output is one JSON object: `correct`, `attempted`, `failed`, `metrics`,
`device`, with `--trace 1` also `breakdown`, and last `checks`, the
numbers compared beside their limits.  With `--trace 0` the metrics
are the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics, read under `torch.profiler` over the first `TRACE_SECONDS` of
the window (or `--seconds`, if shorter).

The process runs on two fixed cores (`pin`), so that the host's part of
each request is not moved between cores; it logs those cores' clock and
steal time and the machine's load before and after the window.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()   # the process's start, as near as Python sees it

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

from rdfbench import registry  # noqa: E402

ROOT = registry.ROOT
# top-level module names a run may not load (compared whole): JAX, its
# libraries and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_SECONDS = 3.0       # the traced part of a --trace 1 window
PIN_CORES = 2


@dataclass
class Context:
    """What a metric reader reads."""

    cell: str
    kind: str                   # "workload" or "group"
    setup_s: float
    steps: dict                 # set-up step -> seconds
    window_s: float
    latencies_s: list           # every request of the window, in order
    failed: int
    telemetry: dict             # counters over the window (after - before)
    trace: object = None        # trace.TraceSummary, when traced


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def fixed_caches(root: Path) -> None:
    """Kernel caches at fixed paths inside the checkout, so that only a
    cell's first run there builds."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def _log(msg: str) -> None:
    print(f"[rdfbench] {msg}", file=sys.stderr, flush=True)


def pin() -> list[int]:
    """Run this process (and the threads it starts) on the last
    `PIN_CORES` cores it may use."""
    cores = sorted(os.sched_getaffinity(0))[-PIN_CORES:]
    os.sched_setaffinity(0, cores)
    return cores


def host_state(cores: list[int]) -> str:
    """The pinned cores' clock (MHz), the time the hypervisor gave them
    to others (steal, in clock ticks since boot) and the load average."""
    mhz, steal = {}, {}
    try:
        with open("/proc/stat") as f:
            for line in f:
                name, *ticks = line.split()
                if name[3:].isdigit() and int(name[3:]) in cores:
                    steal[int(name[3:])] = int(ticks[7]) if len(ticks) > 7 else 0
    except OSError:
        pass
    try:
        with open("/proc/cpuinfo") as f:
            cpu = None
            for line in f:
                if line.startswith("processor"):
                    cpu = int(line.split(":")[1])
                elif line.startswith("cpu MHz") and cpu in cores:
                    mhz[cpu] = float(line.split(":")[1])
    except OSError:
        pass
    load = " ".join(f"{x:.2f}" for x in os.getloadavg())
    return (f"cores {cores} MHz {mhz or 'unknown'}, steal ticks "
            f"{steal or 'unknown'}, load {load}")


def _log_spread(lat: list, split: list) -> None:
    """Quartiles of the requests' times, by fifths of the window, and of
    the fused runs' two parts: where a run's spread comes from."""
    import numpy as np

    def q(x):
        return "/".join(f"{v * 1e3:.3f}" for v in np.percentile(x, [25, 50, 75]))

    fifths = [q(part) for part in np.array_split(np.asarray(lat), 5)
              if len(part)]
    _log("request ms quartiles by fifth of the window: " + " | ".join(fifths))
    if split:
        d, h = zip(*split[-len(lat):])
        _log(f"fused run ms quartiles: driver {q(d)}, copies to host {q(h)}")


@contextlib.contextmanager
def _join_count_spans(shapes: list):
    """Put a span around each `kernels.ops.join_count` call and record
    its (B, L, S) in `shapes`, for the traced window only."""
    import torch
    from repro_torch.kernels import ops

    from rdfbench.trace import JOIN_SPAN

    real = ops.join_count

    def spanned(probe, build_sorted):
        with torch.profiler.record_function(JOIN_SPAN):
            if probe.is_cuda and probe.numel():
                B = probe.shape[0] if probe.dim() == 2 else 1
                shapes.append((B, probe.shape[-1], build_sorted.shape[-1]))
            return real(probe, build_sorted)

    ops.join_count = spanned
    try:
        yield
    finally:
        ops.join_count = real


def window(prog, cell, seed: int, seconds: float, traced: bool):
    """Send the cell's traffic for `seconds`; returns (latencies, failed,
    keeper, the window's seconds, trace summary or None)."""
    import torch

    from rdfbench import loadgen, trace
    from rdfbench.check import Keeper

    reqs = loadgen.requests(cell.traffic, cell.config["weights"], seed)
    keeper = Keeper(seed)
    lat, failed = [], 0
    shapes: list = []
    prof = None
    with contextlib.ExitStack() as stack:
        if traced:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if prog.executor.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            stack.enter_context(_join_count_spans(shapes))
            prof = stack.enter_context(profile(activities=acts))
            stack.enter_context(prog.tracing())
            stack.enter_context(torch.profiler.record_function(trace.WINDOW))
        t_open = time.perf_counter()
        for req in reqs:
            t0 = time.perf_counter()
            try:
                rows = (prog.run_workload() if req is None
                        else prog.run_group(req))
            except RuntimeError as e:   # e.g. a capacity overflow
                failed += 1
                rows = None
                _log(f"request {req or 'workload'} failed: {e}")
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            if rows is not None:
                keeper.add(req or "workload", rows)
            if t1 - t_open >= seconds:
                break
        loop_s = time.perf_counter() - t_open
    summary = None
    if prof is not None:
        t0 = time.perf_counter()
        summary = trace.summarize(prof, shapes, len(lat))
        _log(f"trace of {len(lat)} requests reduced in "
             f"{time.perf_counter() - t0:.1f} s")
        for note in summary.notes:
            _log(f"trace: {note}")
    return lat, failed, keeper, loop_s, summary


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", root: Path = ROOT,
             t_start: float = T_START, overrides: dict | None = None,
             cores: list | None = None) -> dict:
    """One run of cell `name`; returns the result object.  `overrides`
    replaces top-level keys of the configuration (the control's broken
    guarantee); a benchmark run passes none.  The caller has set the
    caches (`fixed_caches`)."""
    import torch

    import repro_torch

    from rdfbench import check, program
    from rdfbench import data as datasets

    cell = registry.load_cell(name, root)
    if overrides:
        cell = dataclasses.replace(cell, config={**cell.config, **overrides})
    metrics = cell.per_layer if traced else cell.end_to_end
    readers = {m["name"]: registry.metric_reader(m["name"], root)
               for m in metrics}
    dev = repro_torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    prog = program.set_up(cell.config, seed, device, _log)
    program.warm_up(prog, cell.traffic, device)
    gc.collect()
    gc.freeze()      # set-up's objects are not rescanned in the window
    tele0 = prog.telemetry()
    setup_s = time.perf_counter() - t_start
    _log("set-up " + json.dumps({k: round(v, 4) for k, v in
                                 prog.steps.items()})
         + f"; setup_s {setup_s:.3f}")

    run_for = min(seconds, TRACE_SECONDS) if traced else seconds
    if cores:
        _log("before the window: " + host_state(cores))
    lat, failed, keeper, window_s, summary = window(prog, cell, seed,
                                                    run_for, traced)
    tele1 = prog.telemetry()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = "workload" if cell.traffic["request"] == "workload" else "group"
    _log(f"window {window_s:.3f} s, {len(lat)} requests, {failed} failed")
    if cores:
        _log("after the window: " + host_state(cores))
    _log_spread(lat, prog.split)

    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or of the JAX package were loaded: "
                         f"{found}")

    ctx = Context(cell=name, kind=kind, setup_s=setup_s, steps=prog.steps,
                  window_s=window_s, latencies_s=lat, failed=failed,
                  telemetry={k: tele1[k] - tele0[k] for k in tele0},
                  trace=summary)
    values = {}
    for m in metrics:
        v = readers[m["name"]](ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}

    # the reference, once the window is closed and the program is freed
    groups, triples, consts = prog.groups, prog.triples, prog.consts
    del prog
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    wrong, parts = check.compare(keeper, groups, triples,
                                 datasets.module(cell.config), consts,
                                 cell.config["queries"])
    _log(f"reference compared in {time.perf_counter() - t0:.3f} s")
    checks = {"wrong_rows": {"value": wrong, "limit": 0}}

    result = {
        "correct": bool(wrong <= 0 and keeper.seen),
        "attempted": len(lat),
        "failed": failed,
        "metrics": values,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    _log("parts of wrong_rows: " + json.dumps(parts))
    for k, v in checks.items():
        _log(f"check {k} {v['value']} limit {v['limit']}")
    return result


def main(argv=None, device: str = "cuda", root: Path = ROOT) -> int:
    """The command line.  `device` and `root` are for the tests, which run
    it on the CPU; the command line itself always runs on the card."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fixed_caches(root)
    cores = None
    if device == "cuda":     # the command line, not a test in a shared worker
        cores = pin()
    import torch

    if cores:
        torch.set_num_threads(len(cores))
    cell = registry.load_cell(args.workload, root)
    if device == "cuda":
        if not torch.cuda.is_available():
            _log("torch.cuda.is_available() is false: this benchmark runs "
                 "on a CUDA card")
            return 2
        if torch.cuda.device_count() < cell.chips:
            _log(f"the cell needs {cell.chips} cards, "
                 f"{torch.cuda.device_count()} present")
            return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), device=device, root=root,
                      cores=cores)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
