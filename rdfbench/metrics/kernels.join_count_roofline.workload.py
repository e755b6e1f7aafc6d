"""The share of its roofline that `join_count` reaches in the traced
window, in %: the least time of every call from its shapes
(`rdfbench.roofline`), over the device time of its kernels (profiler)."""
from rdfbench.roofline import join_count_bound_ms


def read(ctx):
    t = ctx.trace
    if ctx.kind != "workload" or t is None or not t.join_count:
        return None
    bound = sum(join_count_bound_ms(B, L, S) for B, L, S, _us in t.join_count)
    spent = sum(us for *_shape, us in t.join_count) / 1e3
    return 100.0 * bound / spent if spent > 0 else None
