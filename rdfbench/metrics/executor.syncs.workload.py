"""Blocking device-to-host transfers per workload run in the traced
window: the port's `sync.*` spans (`repro_torch.trace`)."""


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
    return len(syncs) / t.requests
