"""``graph_launch_ms``: the median over the window's host-loop iterations
(``leibnizgym_tpu_torch/utils/trace.py`` ``window``) of the host time of the
program's ``epoch.launch.rollout``, ``.gae`` and ``.update`` spans together:
the epoch's graph replays as the host issues them (1 + 1 + the update's
minibatch steps). None from a program without the tracer."""

import statistics


def read(result, ctx):
    try:
        from leibnizgym_tpu_torch.utils import trace
    except ImportError:
        return None
    w = trace.window()
    values = [sum(s.wall_ms for s in under if s.name.startswith("epoch.launch."))
              for _, under in w.iterations] if w else []
    return statistics.median(values) if values else None
