"""``host_offcpu_ms``: the median over the window's host-loop iterations
(``leibnizgym_tpu_torch/utils/trace.py`` ``window``) of the training
thread's time off its CPU outside the read-back: the ``runner.iteration``
span's wall time less its ``runner.readback`` spans', less the same
difference of the thread's CPU time. What is left is time the thread was
descheduled or blocked on the interpreter lock or I/O. None from a program
without the tracer."""

import statistics


def read(result, ctx):
    try:
        from leibnizgym_tpu_torch.utils import trace
    except ImportError:
        return None
    w = trace.window()
    values = []
    for it, under in w.iterations if w else []:
        readback = [s for s in under if s.name == "runner.readback"]
        wall = it.wall_ms - sum(s.wall_ms for s in readback)
        cpu = it.cpu_ms - sum(s.cpu_ms for s in readback)
        values.append(wall - cpu)
    return statistics.median(values) if values else None
