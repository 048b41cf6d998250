"""``device_idle_share``: the share of the profiled stretch in which the
device ran nothing (1 - the union of its kernels', copies' and sets'
intervals over the stretch), in percent, from ``torch.profiler``."""

from perfbench import trace


def read(result, ctx):
    return trace.idle_pct(result.get("trace"))
