"""The port's tracer: named host spans and the epoch's device phase marks,
kept in memory.

``span(name, **attrs)`` is a context manager. Each span records an id and
its parent's (spans nest per thread), its name, the host-loop epoch it
belongs to, its process's rank in the process group (0 alone: ``rank``,
which ``parallel/mesh.py`` ``initialize_distributed`` sets and each
``sync_clock`` reads), its thread, its start and end, its attributes and,
for the host loop's long spans (``CPU_TIMED``), the thread's CPU time at
both ends (``time.thread_time_ns``). Durations come from the
monotonic clock; starts and ends are placed on the clock that
``torch.profiler`` gives host events (``c10::getTime``: CLOCK_REALTIME ns on
Linux) through an offset that ``sync_clock`` takes, at each
``Runner.train`` start. The spans go into a bounded buffer, read through
``records()``: the last ``ITERATIONS`` host-loop iterations
(``runner.iteration`` spans and everything closed while one is open), the
process's set-up spans (``runner.train``, ``epoch.setup``) apart, and the
last ``LOOSE`` spans closed outside any iteration (an epoch function called
directly, the drain after ``Runner.train``'s loop).

Under a profiler: ``refresh`` (called once per host-loop iteration and at
each ``Runner.train`` start) asks whether a ``torch.profiler`` is
recording; while one is, each span also opens
``torch.profiler.record_function(<name>)``, so the program's spans appear in
the profiler's trace on the device timeline's clock and each idle stretch
of the device falls inside a named span (``scripts/profile_env.py --what
train`` prints the ten longest with the span open at their end). With no
profiler recording the spans are kept all the same and no range is opened.

Device phase marks: ``mark(phase, cuda)`` records a CUDA event on the
current stream (off the card, a host-clock reading) into the innermost open
``epoch`` span of the thread, on the stream of the epoch's first mark: the
epoch functions mark their start and the end of their rollout, GAE and
update phases, never inside a capture.
``resolve`` turns an epoch's marks into milliseconds since its
``Runner.train`` call's origin (the call's first mark, ``sync_clock``) once
its metrics have been read back, when the events are complete, so nothing
waits for the device.

``gc_spans()`` records each collection of generation 1 or 2 as a
``host.gc`` span, with its generation, while it is entered
(``Runner.train``'s duration).

``window()`` gives the ``Runner.train`` call that ran the most iterations,
each iteration with the spans under it: the window the benchmark's readers
take their medians over.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["Span", "Tracer", "Window", "TRACER", "span", "iteration", "mark", "resolve",
           "refresh", "sync_clock", "gc_spans", "records", "window"]

ITERATION = "runner.iteration"
SETUP = frozenset({"runner.train", "epoch.setup"})
# the spans that read the thread's CPU time: the host loop's long ones. A
# reading is a system call (2.3 us on the H100's host, whose thread CPU
# clock ticks every 10 ms), too dear and too coarse for the short spans.
CPU_TIMED = frozenset({"runner.train", "runner.iteration", "epoch", "runner.readback",
                       "runner.process"})
ITERATIONS = 4096
LOOSE = 65536
FREE_EVENTS = 64  # CUDA events kept for reuse by later marks

_wall_ns = time.perf_counter_ns
_cpu_ns = time.thread_time_ns


class Span:
    """One span; its own context manager. ``start_ns`` and ``end_ns`` are on
    the profiler's clock, ``cpu_*_ns`` the thread's CPU time. An ``epoch``
    span's ``marks_ms`` holds its phase marks once resolved, in milliseconds
    since its ``Runner.train`` call's origin."""

    __slots__ = ("tracer", "id", "parent", "name", "epoch", "rank", "thread", "start_ns",
                 "end_ns", "cpu_start_ns", "cpu_end_ns", "attrs", "marks", "marks_ms", "origin",
                 "stream", "offset", "range")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.tracer, self.name, self.attrs, self.rank = tracer, name, attrs, tracer.rank
        self.end_ns = self.marks = self.marks_ms = self.origin = self.stream = None

    def __enter__(self) -> "Span":
        tracer = self.tracer
        local = tracer._local
        stack = local.stack
        self.id = next(tracer._ids)
        self.parent = stack[-1].id if stack else None
        self.thread = local.ident
        if self.name == ITERATION:
            tracer._epoch, tracer._group = self.attrs["epoch"], []
        self.epoch = tracer._epoch
        if tracer._ranges:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        else:
            self.range = None
        stack.append(self)
        self.offset = tracer._offset
        self.start_ns = _wall_ns() + self.offset
        self.cpu_start_ns = _cpu_ns() if self.name in CPU_TIMED else None
        return self

    def __exit__(self, *exc) -> None:
        self.cpu_end_ns = None if self.cpu_start_ns is None else _cpu_ns()
        self.end_ns = _wall_ns() + self.offset
        tracer = self.tracer
        tracer._local.stack.pop()  # spans nest, so this one is on top
        if self.range is not None:
            self.range.__exit__(None, None, None)
            self.range = None
        group = tracer._group
        if self.name in SETUP:
            tracer._setup.append(self)
        elif group is None:
            tracer._loose.append(self)
        else:
            group.append(self)
            if self.name == ITERATION:
                tracer._iterations.append(group)
                tracer._group = tracer._epoch = None

    @property
    def wall_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    @property
    def cpu_ms(self) -> Optional[float]:
        """The thread's CPU time in the span; None for a span outside
        ``CPU_TIMED``."""
        if self.cpu_start_ns is None:
            return None
        return (self.cpu_end_ns - self.cpu_start_ns) * 1e-6

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, epoch={self.epoch}, "
                f"rank={self.rank}, "
                f"wall_ms={self.wall_ms if self.end_ns is not None else None}, {self.attrs})")


@dataclasses.dataclass
class Window:
    """A ``Runner.train`` call: its span, its iterations each with every
    span under it, and every span under the call."""

    call: Span
    iterations: List[Tuple[Span, List[Span]]]
    spans: List[Span]


class _Local(threading.local):
    """A thread's open spans, its id and its open ``host.gc`` span."""

    def __init__(self):
        self.stack: List[Span] = []
        self.ident = threading.get_ident()
        self.gc: Optional[Span] = None


class Tracer:
    """The buffer and the per-thread span stacks (module docstring)."""

    def __init__(self, iterations: int = ITERATIONS, loose: int = LOOSE):
        self._ids = itertools.count(1)
        self._local = _Local()
        self._iterations = collections.deque(maxlen=iterations)
        self._setup = collections.deque(maxlen=iterations)
        self._loose = collections.deque(maxlen=loose)
        self._group: Optional[list] = None  # the open iteration's spans
        self._epoch = None
        self._ranges = False
        self.rank = 0  # this process's rank in the process group
        self._offset = time.time_ns() - _wall_ns()
        self._origin = None  # the first mark since sync_clock
        self._free_events: list = []
        self._gc_users = 0
        self._gc_lock = threading.Lock()

    # ------------------------------------------------------------------ spans

    def span(self, name: str, /, **attrs) -> Span:
        return Span(self, name, attrs)

    def iteration(self, epoch: int) -> Span:
        """The ``runner.iteration`` span of one host-loop iteration; asks
        first whether a profiler is recording."""
        self.refresh()
        return Span(self, ITERATION, {"epoch": epoch})

    def refresh(self) -> None:
        """Open a profiler range with each span from now on while a
        ``torch.profiler`` is recording."""
        self._ranges = bool(torch._C._autograd._profiler_enabled())

    def sync_clock(self) -> None:
        """Take the offset from the monotonic clock to the profiler's and
        this process's rank; the next mark becomes the origin of the marks
        that follow."""
        self.rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
        self._offset = time.time_ns() - _wall_ns()
        self._origin = None
        self.refresh()

    # ------------------------------------------------------------ phase marks

    def mark(self, phase: str, cuda: bool) -> None:
        """Mark ``phase`` in the innermost open ``epoch`` span of this
        thread: a CUDA event on the current stream where ``cuda``, else a
        host-clock reading; nothing without such a span or inside a
        capture."""
        ep = next((s for s in reversed(self._local.stack) if s.name == "epoch"), None)
        if ep is None:
            return
        if cuda:
            if torch.cuda.is_current_stream_capturing():
                return
            if ep.stream is None:  # the stream of the epoch's first mark takes them all
                ep.stream = torch.cuda.current_stream()
            at = (self._free_events.pop() if self._free_events
                  else torch.cuda.Event(enable_timing=True))
            at.record(ep.stream)
        else:
            at = _wall_ns()
        if self._origin is None:
            self._origin = at
        if ep.marks is None:
            ep.marks, ep.origin = {}, self._origin
        ep.marks[phase] = at

    def resolve(self, ep: Optional[Span]) -> None:
        """``ep.marks_ms`` from its marks, where the device has passed them
        all (a read-back of the epoch's metrics has waited for them); its
        events but the origin are kept for reuse."""
        if ep is None or not ep.marks:
            return
        marks, origin = ep.marks, ep.origin
        if isinstance(origin, int):
            ep.marks_ms = {k: (v - origin) * 1e-6 for k, v in marks.items()}
        else:
            try:
                ep.marks_ms = {k: origin.elapsed_time(ev) for k, ev in marks.items()}
            except RuntimeError:  # an event the device has not reached yet
                return
            for ev in marks.values():
                if ev is not origin and len(self._free_events) < FREE_EVENTS:
                    self._free_events.append(ev)
        ep.marks = ep.origin = ep.stream = None

    # ---------------------------------------------------------- collections

    def _on_gc(self, phase: str, info: dict) -> None:
        if info.get("generation", 0) < 1:
            return
        local = self._local
        if phase == "start":
            local.gc = Span(self, "host.gc", {"generation": info["generation"]}).__enter__()
        elif local.gc is not None:
            local.gc.__exit__()
            local.gc = None

    @contextlib.contextmanager
    def gc_spans(self):
        """Record ``host.gc`` spans while entered (nests)."""
        with self._gc_lock:
            self._gc_users += 1
            if self._gc_users == 1:
                gc.callbacks.append(self._on_gc)
        try:
            yield
        finally:
            with self._gc_lock:
                self._gc_users -= 1
                if self._gc_users == 0 and self._on_gc in gc.callbacks:
                    gc.callbacks.remove(self._on_gc)

    # ---------------------------------------------------------------- reading

    def records(self) -> List[Span]:
        """Every kept span, by start."""
        out = list(self._setup) + list(self._loose)
        for group in list(self._iterations):
            out.extend(group)
        out.sort(key=lambda s: s.start_ns)
        return out

    def window(self, recs: Optional[List[Span]] = None) -> Optional[Window]:
        """The ``Runner.train`` call with the most host-loop iterations (the
        latest of equals), or None where there is none."""
        recs = self.records() if recs is None else recs
        children: Dict[Optional[int], List[Span]] = collections.defaultdict(list)
        for s in recs:
            children[s.parent].append(s)

        def under(root: Span) -> List[Span]:
            out, todo = [], list(children.get(root.id, ()))
            while todo:
                s = todo.pop()
                out.append(s)
                todo.extend(children.get(s.id, ()))
            return sorted(out, key=lambda s: s.start_ns)

        calls = [s for s in recs if s.name == "runner.train"]
        if not calls:
            return None
        call = max(calls, key=lambda c: (sum(k.name == ITERATION for k in children[c.id]),
                                         c.start_ns))
        its = [(k, under(k)) for k in children[call.id] if k.name == ITERATION]
        if not its:
            return None
        return Window(call, its, under(call))


TRACER = Tracer()
span = TRACER.span
iteration = TRACER.iteration
mark = TRACER.mark
resolve = TRACER.resolve
refresh = TRACER.refresh
sync_clock = TRACER.sync_clock
gc_spans = TRACER.gc_spans
records = TRACER.records
window = TRACER.window
