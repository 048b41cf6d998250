"""``update_ms``: the median over the window's epochs of the CUDA-event time
from the end of each window epoch's GAE phase to the end of its update phase (the actor-critic and central-value minibatch steps' graph replays)."""

import statistics


def read(result, ctx):
    values = result["spans"].get("update_ms")
    return statistics.median(values) if values else None
