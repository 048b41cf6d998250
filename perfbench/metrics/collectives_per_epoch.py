"""``collectives_per_epoch``: the median over the window's epochs
(``leibnizgym_tpu_torch/utils/trace.py`` ``window``) of the collectives
rank 0 issued in each: the ``collectives`` attribute of the program's
``epoch`` span (the change of ``parallel/mesh.py`` ``DataShard.counts``
over the epoch, a graph's replays adding the collectives it captured),
summed over the kinds. None from a program without the attribute."""

import statistics


def read(result, ctx):
    try:
        from leibnizgym_tpu_torch.utils import trace
    except ImportError:
        return None
    w = trace.window()
    values = [sum(s.attrs["collectives"].values()) for _, under in w.iterations for s in under
              if s.name == "epoch" and "collectives" in s.attrs] if w else []
    return float(statistics.median(values)) if values else None
