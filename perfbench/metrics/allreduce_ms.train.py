"""``allreduce_ms.train``: rank 0's time in its collectives per epoch, in
milliseconds: the device time of the NCCL kernels (found by the symbol
``nccl`` in ``trace.summarize``'s per-kernel times) over the profiled
stretch's epochs. A kernel's time includes its wait for the other ranks,
which is what the rank loses. Where the collectives run on the host (a
gloo group, which no device trace holds: the CPU tests), the host seconds
inside rank 0's collectives over the window's epochs (``DataShard.seconds``,
the driver's ``collective_host_s``) in their place. None where neither is
there."""

SYMBOL = "nccl"


def read(result, ctx):
    counters, summary = result["counters"], result.get("trace")
    if summary is not None and counters.get("profile_epochs"):
        seconds = sum(s for k, s in summary.kernel_s.items() if SYMBOL in k.lower())
        if seconds > 0:
            return 1e3 * seconds / counters["profile_epochs"]
    if counters.get("collective_host_s") is not None and counters.get("epochs"):
        return 1e3 * counters["collective_host_s"] / counters["epochs"]
    return None
