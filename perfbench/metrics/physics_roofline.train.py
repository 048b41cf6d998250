"""``physics_roofline``: the physics kernel's share of its roofline, in
percent: the least time one launch could take at the cell's env count (the
larger of its frozen operations over 67 TFLOP/s and its frozen bytes over
3.35 TB/s, ``yardstick.kernel_bound_s``) over the kernel's mean device time
per launch in the profiled stretch, found by its symbol."""

from perfbench import trace, yardstick

SYMBOL = "physics_step_kernel"


def read(result, ctx):
    counts = ctx.config["physics_kernel"]
    bound, _ = yardstick.kernel_bound_s(int(result["counters"]["num_envs"]),
                                        counts["ops_per_env"], counts["bytes_per_env"])
    return trace.kernel_roofline_pct(result.get("trace"), SYMBOL, bound)
