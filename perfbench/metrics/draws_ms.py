"""``draws_ms``: the median over the window's host-loop iterations
(``leibnizgym_tpu_torch/utils/trace.py`` ``window``) of the program's
``epoch.draws`` spans: ``GraphedEpoch._load_draws``, the epoch's action
noise, env draws and permutations drawn and copied into the graphs' static
buffers. None from a program without the tracer."""

import statistics


def read(result, ctx):
    try:
        from leibnizgym_tpu_torch.utils import trace
    except ImportError:
        return None
    w = trace.window()
    values = [sum(s.wall_ms for s in under if s.name == "epoch.draws")
              for _, under in w.iterations] if w else []
    return statistics.median(values) if values else None
