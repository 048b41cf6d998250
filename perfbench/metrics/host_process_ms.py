"""``host_process_ms``: the median over the window's host-loop iterations
(``leibnizgym_tpu_torch/utils/trace.py`` ``window``) of the program's
``runner.snapshot`` span (the per-epoch device snapshot of the learner) and
``runner.process`` span (the processed epoch's summary writes, curriculum
controller, checkpoints and log line) together. None from a program without
the tracer."""

import statistics


def read(result, ctx):
    try:
        from leibnizgym_tpu_torch.utils import trace
    except ImportError:
        return None
    w = trace.window()
    values = [sum(s.wall_ms for s in under if s.name in ("runner.snapshot", "runner.process"))
              for _, under in w.iterations] if w else []
    return statistics.median(values) if values else None
