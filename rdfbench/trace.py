"""Reduce a `torch.profiler` trace of the traced window to numbers.

The window is the CPU span `WINDOW`, which the harness opens around the
traced requests.  Device activity is every CUDA event the profiler
records inside it (kernels, copies, sets), not the annotations that
mirror CPU spans on the device's timeline.  What the metric readers use:

- `busy_s`: the union of device activity in the window;
- `kernels`: (name, start_us, dur_us) of each kernel;
- `d2h_us`: device time of device-to-host copies;
- `join_count`: (B, L, S, device_us) of each `join_count` call, the
  shapes as the harness's span around `kernels.ops.join_count` saw them,
  the time the kernels of that call took (`sample_kernel`, when the
  launch plan runs one, and `join_count_kernel`);
- `device_ops` / `idle_gaps`: the ten device operations with the most
  time, and the ten longest idle gaps labelled by what the host was
  doing when the device went idle (the benchmark's span, and the
  innermost operation under it).
"""
from __future__ import annotations

from dataclasses import dataclass, field

WINDOW = "bench.window"
# the benchmark's spans around its calls into the port's layers
WORKLOAD_RUN = "run.workload/driver.run"
WORKLOAD_COPY = "run.workload/answers.to_host"
QUERY_MEMBER = "request.query/operators.member"
JOIN_SPAN = "kernels.join_count"
SPANS = {WORKLOAD_RUN, WORKLOAD_COPY, QUERY_MEMBER, JOIN_SPAN}
# the profiler's own host work, left out of the idle gaps' labels
PROFILER_OWN = {"Activity Buffer Request"}


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: list = field(default_factory=list)
    d2h_us: float = 0.0
    join_count: list = field(default_factory=list)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)
    requests: int = 0
    notes: list = field(default_factory=list)


def _is_device(e) -> bool:
    import torch
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def _union(intervals) -> tuple[float, list]:
    """Total length of the union, and the merged intervals, sorted."""
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def summarize(prof, join_shapes: list, requests: int,
              span_names: set = SPANS) -> TraceSummary:
    events = list(prof.events())
    windows = [e for e in events if e.name == WINDOW and not _is_device(e)]
    if len(windows) != 1:
        raise RuntimeError(f"{len(windows)} '{WINDOW}' spans in the trace")
    w0, w1 = windows[0].time_range.start, windows[0].time_range.end
    dev = [e for e in events if _is_device(e) and e.name not in span_names
           and e.name != WINDOW
           and e.time_range.end > w0 and e.time_range.start < w1]
    clipped = [(max(e.time_range.start, w0), min(e.time_range.end, w1))
               for e in dev]
    busy_us, merged = _union(clipped)
    out = TraceSummary(window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
                       requests=requests)
    by_name: dict[str, float] = {}
    for e in dev:
        dur = e.time_range.end - e.time_range.start
        by_name[e.name] = by_name.get(e.name, 0.0) + dur
        if e.name.startswith("Memcpy") or e.name.startswith("Memset"):
            if "DtoH" in e.name:
                out.d2h_us += dur
        else:
            out.kernels.append((e.name, e.time_range.start, dur))
    out.device_ops = [[n, us / 1e6] for n, us in
                      sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]

    # join_count calls: one join_count_kernel each, after an optional
    # sample_kernel of the same call (one stream: launch order holds)
    probes, pending = [], 0.0
    for name, _start, dur in sorted(out.kernels, key=lambda k: k[1]):
        if "sample_kernel" in name:
            pending += dur
        elif "join_count_kernel" in name:
            probes.append(pending + dur)
            pending = 0.0
    if probes and len(probes) == len(join_shapes):
        out.join_count = [(*shape, us) for shape, us in
                          zip(join_shapes, probes)]
    elif probes or join_shapes:
        out.notes.append(f"{len(join_shapes)} join_count calls but "
                         f"{len(probes)} join_count kernels: no roofline")

    # idle gaps inside the window, labelled by the host's spans
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i + 1] - edges[i], edges[i])
            for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    cpu = [e for e in events if not _is_device(e) and e.name != WINDOW]
    for length, at in gaps[:10]:
        out.idle_gaps.append([_label(cpu, at, span_names), length / 1e6])
    return out


def _label(cpu, at: float, span_names: set) -> str:
    """The benchmark span open at time `at`, and the innermost operation
    open under it."""
    open_ = [e for e in cpu if e.time_range.start <= at < e.time_range.end]
    spans = [e for e in open_ if e.name in span_names]
    inner = [e for e in open_ if e.name not in span_names
             and e.name not in PROFILER_OWN]
    span = max(spans, key=lambda e: e.time_range.start).name if spans \
        else "harness"
    if inner:
        return f"{span} > {max(inner, key=lambda e: e.time_range.start).name}"
    return span
