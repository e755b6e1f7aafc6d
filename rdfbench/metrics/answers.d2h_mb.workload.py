"""Bytes brought to the host per workload run in the traced window, in
MB (1e6): the `bytes` of the port's `sync.*` spans, the overflow flags,
each answer's count and its rows (`repro_torch.trace`)."""


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
    return sum(s.attrs.get("bytes", 0) for s in syncs) / 1e6 / t.requests
