"""The 95th percentile of every workload run of the window, in ms
(host clock; numpy's linear interpolation)."""
import numpy as np


def read(ctx):
    if ctx.kind != "workload" or not ctx.latencies_s:
        return None
    return float(np.percentile(ctx.latencies_s, 95)) * 1e3
