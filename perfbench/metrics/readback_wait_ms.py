"""``readback_wait_ms``: the median wall time of the program's
``runner.readback`` spans in the window (``leibnizgym_tpu_torch/utils/
trace.py``: the ``Runner.train`` call that ran the most host-loop
iterations): ``fetch_metrics`` of the epoch ``host_pipeline_depth`` epochs
back, with its wait for the device. None from a program without the
tracer."""

import statistics


def read(result, ctx):
    try:
        from leibnizgym_tpu_torch.utils import trace
    except ImportError:
        return None
    w = trace.window()
    values = [s.wall_ms for s in w.spans if s.name == "runner.readback"] if w else []
    return statistics.median(values) if values else None
