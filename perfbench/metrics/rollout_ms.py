"""``rollout_ms``: the median over the window's epochs of the CUDA-event time
from each window epoch's start to the end of its rollout phase (the draws into the static buffers, then the rollout graph: policy, action noise, 32 env steps with their physics kernel launches)."""

import statistics


def read(result, ctx):
    values = result["spans"].get("rollout_ms")
    return statistics.median(values) if values else None
