"""``graph_replays_per_epoch``: the median over the window's epochs
(``leibnizgym_tpu_torch/utils/trace.py`` ``window``) of the ``replays``
attribute of the program's ``epoch`` span: the change of
``ops/cuda_engine.py`` ``replay_count`` over the epoch, one rollout and one
GAE graph and one graph per minibatch step. None from a program without the
tracer."""

import statistics


def read(result, ctx):
    try:
        from leibnizgym_tpu_torch.utils import trace
    except ImportError:
        return None
    w = trace.window()
    values = [s.attrs["replays"] for _, under in w.iterations for s in under
              if s.name == "epoch" and "replays" in s.attrs] if w else []
    return float(statistics.median(values)) if values else None
