"""``epoch_ms_p90``: the 90th percentile of the window's start-to-start epoch
times, from CUDA events at each epoch's start: the host loop's periodic
stalls (the ``last`` checkpoint every 100 epochs, the metric read-back, the
curriculum's checkpoint) and the card's slower spells. The last epoch, whose
interval runs into ``Runner.train``'s final checkpoint and drain, is left
out."""

import numpy as np


def read(result, ctx):
    values = result["spans"].get("epoch_ms", [])[:-1]
    return float(np.percentile(values, 90)) if len(values) >= 10 else None
