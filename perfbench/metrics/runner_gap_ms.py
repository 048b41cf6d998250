"""``runner_gap_ms``: the median over the window's epochs of the CUDA-event time
from the end of each window epoch's update phase to the next epoch's start: the metrics' assembly and the host loop of Runner.train (read-back, summary writes, checkpoints, the curriculum controller) as far as the device waits for it."""

import statistics


def read(result, ctx):
    values = result["spans"].get("runner_gap_ms")
    return statistics.median(values) if values else None
