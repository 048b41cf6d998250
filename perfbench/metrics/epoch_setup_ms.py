"""``epoch_setup_ms``: the wall time of the process's first
``epoch.setup`` span (``leibnizgym_tpu_torch/utils/trace.py``): the graphed
epoch's buffers, its warm-up epoch on a side stream and the capture of its
four graphs, a part of ``setup_s``. None from a program without the
tracer."""


def read(result, ctx):
    try:
        from leibnizgym_tpu_torch.utils import trace
    except ImportError:
        return None
    setup = [s for s in trace.records() if s.name == "epoch.setup"]
    return min(setup, key=lambda s: s.start_ns).wall_ms if setup else None
