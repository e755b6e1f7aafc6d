"""Host time blocked on the device per workload run in the traced
window, in ms: the port's `sync.*` spans, one around each blocking
device-to-host transfer (`repro_torch.trace`)."""


def read(ctx):
    t = ctx.trace
    if ctx.kind != "workload" or t is None or not t.requests:
        return None
    try:
        from repro_torch import trace
    except ImportError:     # a program without the port's spans
        return None
    syncs = [s for s in trace.spans() if s.name.startswith("sync.")]
    if not syncs:
        return None
    return sum(s.end_ns - s.start_ns for s in syncs) / 1e6 / t.requests
