"""Spans timed by CUDA events, and the reduction of a ``torch.profiler`` window
to what the per-layer metrics and the result line read: device busy time,
kernel times by name, kernel counts, and the idle gaps with what the host
was doing in each."""

from __future__ import annotations

import bisect
import collections
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch


class EventSpans:
    """Named CUDA events recorded on the current stream, read once the device
    has passed them: ``mark(name)`` appends an event to ``name``'s list. Off
    the card (the CPU tests) the marks are host-clock readings."""

    def __init__(self, on_card: bool = True):
        self.on_card = on_card
        self.events: Dict[str, list] = collections.defaultdict(list)

    def mark(self, name: str) -> None:
        if self.on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            ev = time.perf_counter()
        self.events[name].append(ev)

    def between_ms(self, starts, ends) -> List[float]:
        """Milliseconds from each of ``starts`` to the matching ``ends``."""
        if self.on_card:
            return [a.elapsed_time(b) for a, b in zip(starts, ends)]
        return [(b - a) * 1e3 for a, b in zip(starts, ends)]


@dataclasses.dataclass
class TraceSummary:
    """One profiled stretch, in seconds."""

    window_s: float
    busy_s: float
    kernels: int
    kernel_s: Dict[str, float]  # summed device time per kernel (or copy) name
    kernel_n: Dict[str, int]
    device_ops: List[Tuple[str, float]]  # the ten names that took most time
    idle_gaps: List[Tuple[str, float]]  # the ten longest gaps, by the host op at their end


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(prof: "torch.profiler.profile", t_start_ns: Optional[int] = None,
              t_end_ns: Optional[int] = None) -> Optional[TraceSummary]:
    """The device's work in ``prof``'s window: kernels, copies and sets on the
    device; the window runs from the first device activity (or
    ``t_start_ns``) to the last (or ``t_end_ns``). None when the trace holds
    no device activity."""
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start, dur = ev.start_ns(), ev.duration_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((start, start + dur, ev.name()))
        elif dur >= 0:
            host.append((start, ev.name()))
    if not dev:
        return None
    t0 = min(s for s, _, _ in dev) if t_start_ns is None else t_start_ns
    t1 = max(e for _, e, _ in dev) if t_end_ns is None else t_end_ns
    merged = _merge([(max(s, t0), min(e, t1)) for s, e, _ in dev if e > t0 and s < t1])
    busy = sum(e - s for s, e in merged)
    kernel_s, kernel_n = collections.Counter(), collections.Counter()
    for s, e, name in dev:
        kernel_s[name] += (e - s) * 1e-9
        kernel_n[name] += 1
    host.sort()
    host_starts = [s for s, _ in host]
    gaps = []
    for (_, e0), (s1, _) in zip(merged[:-1], merged[1:]):
        gaps.append((s1 - e0, e0, s1))
    gaps.sort(reverse=True)
    idle = []
    for length, _, end in gaps[:10]:
        i = bisect.bisect_right(host_starts, end) - 1
        idle.append((host[i][1] if i >= 0 else "(none)", length * 1e-9))
    return TraceSummary(
        window_s=(t1 - t0) * 1e-9, busy_s=busy * 1e-9, kernels=len(dev),
        kernel_s=dict(kernel_s), kernel_n=dict(kernel_n),
        device_ops=[(k, v) for k, v in kernel_s.most_common(10)], idle_gaps=idle)


def profiler() -> "torch.profiler.profile":
    """A profiler of the host and the device, not yet started."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)


def kernel_roofline_pct(summary: Optional[TraceSummary], symbol: str, bound_s: float) -> Optional[float]:
    """``bound_s`` over the mean device time of one launch of the kernels
    whose name holds ``symbol``, in percent; None where the trace has none."""
    if summary is None:
        return None
    launches = sum(n for k, n in summary.kernel_n.items() if symbol in k)
    if not launches:
        return None
    seconds = sum(s for k, s in summary.kernel_s.items() if symbol in k)
    return 100.0 * bound_s / (seconds / launches)


def idle_pct(summary: Optional[TraceSummary]) -> Optional[float]:
    """The share of the profiled window in which no device activity ran, in
    percent; None without a trace."""
    if summary is None or summary.window_s <= 0:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
