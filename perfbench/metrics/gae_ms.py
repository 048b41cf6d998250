"""``gae_ms``: the median over the window's epochs (``leibnizgym_tpu_torch/
utils/trace.py`` ``window``) of the device time from the program's mark at
the end of the rollout phase to its mark at the end of the GAE phase (CUDA
events on the epoch's stream, resolved after the epoch's read-back): the
last value, GAE, the advantages' normalisation and the minibatch sources.
None from a program without the tracer."""

import statistics


def read(result, ctx):
    try:
        from leibnizgym_tpu_torch.utils import trace
    except ImportError:
        return None
    w = trace.window()
    values = []
    for _, under in w.iterations if w else []:
        for s in under:
            if s.name == "epoch" and s.marks_ms and {"rollout", "gae"} <= set(s.marks_ms):
                values.append(s.marks_ms["gae"] - s.marks_ms["rollout"])
    return statistics.median(values) if values else None
