"""CUDA-graph capture, written once for the port's hot paths: the env's
reset and step (``envs/trifinger/env.py``), the play policy and the PPO
epoch (``learning/graphs.py``), the counterparts of the reference's
``jax.jit``.

Every capture follows PyTorch's CUDA-graph notes: the body runs eagerly on
a side stream first (``warm_up``; that run also makes every first launch of
a hand-written kernel, which raises the physics kernel's shared-memory cap
on its device, happen outside a capture), then it is captured through a
``CountedGraph``, then replayed. ``Captured`` is the whole cycle for a body
with inputs and outputs; ``GraphedEpoch`` drives its four graphs on one
pool itself.

Counters: ``replay_count`` counts the replays of every ``CountedGraph``
(off the card ``GraphedEpoch`` adds each body run as the replay it stands
for); a replay adds the kernel launches its capture counted to
``cuda_engine.launch_count`` and, given ``counts`` (a ``DataShard``'s), the
collectives its capture counted there. ``Runner.train``'s ``epoch`` span
carries an epoch's share of each (``utils/trace.py``).
"""

from __future__ import annotations

import collections
import contextlib
import gc
from typing import Callable

import torch

from leibnizgym_tpu_torch.ops import cuda_engine

__all__ = ["replay_count", "CountedGraph", "Captured", "warm_up", "clone_nested",
           "copy_nested_"]

replay_count = 0


def clone_nested(x):
    """A copy of nested tuples and dicts of tensors and Nones (the draws'
    and the step outputs' layouts)."""
    if isinstance(x, dict):
        return {k: clone_nested(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return tuple(clone_nested(v) for v in x)
    return None if x is None else x.clone()


def copy_nested_(dst, src) -> None:
    """Write ``src`` into ``dst``, nested tuples of one layout; raises
    ValueError on another layout."""
    if isinstance(dst, (tuple, list)):
        if not isinstance(src, (tuple, list)) or len(src) != len(dst):
            raise ValueError("inputs of another layout than the captured ones")
        for d, v in zip(dst, src):
            copy_nested_(d, v)
    elif dst is None:
        if src is not None:
            raise ValueError("inputs of another layout than the captured ones")
    else:
        dst.copy_(src)


def _layout(x):
    """The shapes, dtypes and Nones of a nested tuple of tensors."""
    if isinstance(x, (tuple, list)):
        return tuple(_layout(v) for v in x)
    return None if x is None else (tuple(x.shape), x.dtype, x.device)


class CountedGraph:
    """A ``torch.cuda.CUDAGraph`` whose replays count in ``replay_count``
    and add the kernel launches it captured to ``cuda_engine.launch_count``
    and, given ``counts`` (a ``collections.Counter`` counted in Python, such
    as a ``DataShard``'s collectives), what its capture counted there;
    capturing launches nothing and counts nothing.

    Every capture runs in ``torch.cuda.graph``'s ``"thread_local"`` error
    mode: an NCCL process group's watchdog thread queries CUDA events while
    a capture is open, which the default ``"global"`` mode would turn into
    an invalidated capture, whether or not the graph holds collectives.

    Python's cyclic garbage collector is off while a capture is open:
    collecting a dead cycle that holds another CUDA graph (an env and its
    graphs form one) would destroy that graph inside the capture, which
    CUDA forbids and which invalidates the capture. ``torch.cuda.graph`` no
    longer collects before a capture."""

    def __init__(self, counts: collections.Counter | None = None):
        self.graph = torch.cuda.CUDAGraph()
        self.launches = 0
        self.counts = counts
        self.counted = collections.Counter()

    @contextlib.contextmanager
    def capture(self, pool=None):
        before = cuda_engine.launch_count
        counts_before = collections.Counter(self.counts)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
                yield self
        finally:
            if collecting:
                gc.enable()
            self.launches = cuda_engine.launch_count - before
            cuda_engine.launch_count = before
            if self.counts is not None:
                self.counted = self.counts - counts_before
                self.counts.clear()
                self.counts.update(counts_before)

    def replay(self) -> None:
        global replay_count
        self.graph.replay()
        cuda_engine.launch_count += self.launches
        replay_count += 1
        if self.counts is not None:
            self.counts.update(self.counted)


@contextlib.contextmanager
def warm_up():
    """The block on a new side stream of the current device, joined to the
    current stream both ways: the eager run before a capture."""
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        yield
    main.wait_stream(side)


class Captured:
    """``body(*inputs)`` as one CUDA graph on ``device``, captured per key:
    the objects ``bound()`` returns, by identity (those the graph reads
    besides its inputs), and the layout of the inputs. The first call for a
    key runs the body in ``warm_up`` and returns that result, then captures
    it on clones of the inputs; a later call copies its inputs in, replays
    and returns clones of the outputs. The body writes in place whatever
    else it changes; inputs and outputs are nested tuples of tensors and
    Nones (outputs also dicts)."""

    def __init__(self, body: Callable, device, bound: Callable[[], tuple] = tuple):
        self.body, self.device, self.bound = body, device, bound
        self.graph = self.objs = self.layout = self.inputs = self.outputs = None

    def __call__(self, *inputs):
        objs, layout = tuple(self.bound()), _layout(inputs)
        if (self.graph is not None and layout == self.layout and len(objs) == len(self.objs)
                and all(a is b for a, b in zip(objs, self.objs))):
            copy_nested_(self.inputs, inputs)
            self.graph.replay()
            return clone_nested(self.outputs)
        with torch.cuda.device(self.device):
            with warm_up():
                outputs = self.body(*inputs)
            self.inputs = clone_nested(inputs)
            self.graph = CountedGraph()
            with self.graph.capture():
                self.outputs = self.body(*self.inputs)
        self.objs, self.layout = objs, layout
        return outputs
