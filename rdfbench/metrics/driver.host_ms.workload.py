"""Host time the workload driver spends issuing work per workload run in
the traced window, in ms: the port's `workload.run` spans less the
`sync.*` spans inside them, the host blocked on the device
(`repro_torch.trace`)."""


def _under(span, name):
    p = span.parent
    while p is not None and p.name != name:
        p = p.parent
    return p is not None


def read(ctx):
    t = ctx.trace
    if ctx.kind != "workload" or t is None or not t.requests:
        return None
    try:
        from repro_torch import trace
    except ImportError:     # a program without the port's spans
        return None
    spans = trace.spans()
    runs = [s for s in spans if s.name == "workload.run"]
    if not runs:
        return None
    waits = [s for s in spans
             if s.name.startswith("sync.") and _under(s, "workload.run")]
    ns = (sum(s.end_ns - s.start_ns for s in runs)
          - sum(s.end_ns - s.start_ns for s in waits))
    return ns / 1e6 / t.requests
