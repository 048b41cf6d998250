"""Env-axis data parallelism over ``torch.distributed`` (counterpart of
``leibnizgym_tpu/parallel/mesh.py``).

One process per device. Each rank steps ``N / W`` of the ``N`` envs and
holds a full replica of the learner. Two rules keep a W-rank run equal to
the 1-rank run on the same seed and global ``N``, up to float reduction
order:

1. every random draw draws the global ``(N, ...)`` block from a generator
   seeded alike on every rank and keeps the rank's rows (``shard_batch``,
   ``DataShard.take``), so a minibatch permutation is the same on every rank;
2. every batch-wide reduction of the epoch is a collective, as XLA's
   partitioner made it one for the JAX package's data mesh: the advantage
   mean and std (``global_mean_std``), each minibatch step's gradients with
   its KL packed in (``all_reduce_mean_``), the epoch metrics
   (``reduce_metrics``) and, for the global-shuffle minibatch layout only,
   the trajectory itself (``all_gather_envs``).

A ``DataShard`` always issues its collectives, at ``W = 1`` too; the plain
single-process path passes no shard and issues none. ``DataShard.counts``
counts the collectives each helper issues; inside a CUDA graph the helper
counts once at capture, and ``ops/capture.py``'s ``CountedGraph`` takes
that back and adds it at each replay. ``DataShard.seconds`` sums the host
time inside each collective call: under gloo, which runs its collectives
on the host, the collective itself with its wait for the peers; under
NCCL only its enqueue, and a replay adds nothing.

The helpers issue only device work on the current stream (no read back to
the host, no tensor made from host data), so that an NCCL shard's
collectives can be captured in the epoch's CUDA graphs
(``learning/graphs.py``); the CPU tests run them under a guard that fails on
either.

The JAX Runner also shards over the local devices of one process; the port
does not: without a process group the Runner uses its one device.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import gc
import os
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from leibnizgym_tpu_torch.utils import trace


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           timeout: Optional[float] = None):
    """Join the process group, once per process and before the device is
    used. Without arguments the rendezvous is ``torchrun``'s (``env://``:
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); a
    ``host:port`` address becomes ``tcp://host:port`` and a ``tcp://`` or
    ``file://`` URL is used as it is, with ``num_processes`` and
    ``process_id``. ``backend`` defaults to NCCL where there is a card and
    gloo elsewhere. ``timeout`` (seconds) bounds every collective, so that a
    rank that died does not leave the others blocked forever. Returns
    (rank, world size)."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if timeout:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout))
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        url = str(coordinator_address)
        if "://" not in url:
            url = f"tcp://{url}"
        dist.init_process_group(backend, init_method=url, world_size=int(num_processes),
                                rank=int(process_id), **kw)
    trace.TRACER.rank = dist.get_rank()
    return dist.get_rank(), dist.get_world_size()


def shutdown_distributed() -> None:
    """Leave the process group. CUDA graphs that captured its NCCL
    collectives must be gone first: NCCL waits for every graph that holds a
    communicator before it tears that down (over several ranks; one rank's
    collectives are copies). Such graphs may sit in reference cycles (an
    env and its graphs, a Runner and its epoch) that only the cyclic
    collector frees, so it runs here; a caller drops its own references
    before."""
    gc.collect()
    dist.destroy_process_group()
    trace.TRACER.rank = 0


def local_rank() -> int:
    """This process's index on its host: ``LOCAL_RANK`` where ``torchrun``
    sets it, else the global rank."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))


@dataclasses.dataclass
class DataShard:
    """This rank's part of the env axis: rows ``[lo, hi)`` of ``n_global``,
    and the process group its collectives run in (None: the default group).
    ``counts`` counts the collectives issued through it, by kind, and
    ``seconds`` the host seconds inside their calls (module docstring)."""

    rank: int
    world: int
    n_global: int
    group: Optional[dist.ProcessGroup] = None
    counts: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    seconds: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    def __post_init__(self):
        if self.n_global % self.world:
            raise ValueError(f"{self.n_global} envs do not split over {self.world} ranks; "
                             "num_instances must be a multiple of the world size")

    @property
    def n_local(self) -> int:
        return self.n_global // self.world

    @property
    def lo(self) -> int:
        return self.rank * self.n_local

    @property
    def hi(self) -> int:
        return self.lo + self.n_local

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))

    def take(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The rank's rows of a global tensor along ``dim``."""
        return x.narrow(dim, self.lo, self.n_local)


def data_shard(n_global: int, group: Optional[dist.ProcessGroup] = None) -> DataShard:
    """The shard of the current process in ``group`` (default: the default
    group, which must be initialised)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed first")
    return DataShard(dist.get_rank(group), dist.get_world_size(group), int(n_global), group)


def shard_batch(tree, shard: Optional[DataShard]):
    """The rank's slice of every leaf with a global env axis: row-major
    ``(N, ...)`` leaves along axis 0, component-major ``(..., N)`` leaves
    (the ``*_cm`` fields) along the last axis; every other leaf (scalars,
    host numbers, None) as it is. Walks tuples, lists, dicts and
    dataclasses. ``shard`` None returns ``tree``."""
    if shard is None:
        return tree
    n = shard.n_global

    def cut(x):
        if torch.is_tensor(x):
            if x.dim() >= 1 and x.shape[0] == n:
                return shard.take(x, 0)
            if x.dim() >= 2 and x.shape[-1] == n:
                return shard.take(x, x.dim() - 1)
            return x
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(cut(v) for v in x)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{f.name: cut(getattr(x, f.name))
                                             for f in dataclasses.fields(x) if f.init})
        return x

    return cut(tree)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _issue(shard: DataShard, kind: str, collective, *args, **kwargs) -> None:
    """``collective(*args, **kwargs)`` counted and timed under ``kind``."""
    shard.counts[kind] += 1
    t0 = time.perf_counter()
    collective(*args, **kwargs)
    shard.seconds[kind] += time.perf_counter() - t0


def _all_reduce(buf: torch.Tensor, shard: DataShard, op=dist.ReduceOp.SUM):
    _issue(shard, "all_reduce", dist.all_reduce, buf, op=op, group=shard.group)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], shard: DataShard) -> None:
    """Replace each tensor by its mean over the ranks, in ONE all-reduce of
    a flat buffer of their common dtype: sum, divide by W, copy back. The
    results stay in the callers' tensors: views into the buffer would sit at
    other alignments, where CUDA's vectorised ``_foreach_norm`` sums in
    another order, and a one-rank run would then differ from the run without
    a process group in the last bits."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _all_reduce(flat, shard)
    if shard.world > 1:
        flat.div_(shard.world)
    torch._foreach_copy_(list(tensors),
                         [x.view_as(t) for x, t in zip(flat.split([t.numel() for t in tensors]),
                                                       tensors)])


def global_mean_std(x: torch.Tensor, shard: Optional[DataShard]):
    """(mean, population std) of ``x`` over every rank's equal-sized shard, in
    two passes: the sum, then the sum of squared deviations from the global
    mean (two one-element all-reduces). ``shard`` None: the same formulas
    on ``x`` alone."""
    count = x.numel() * (shard.world if shard is not None else 1)
    total = x.sum().reshape(1)
    if shard is not None:
        _all_reduce(total, shard)
    mean = total[0] / count
    dev = torch.square(x - mean).sum().reshape(1)
    if shard is not None:
        _all_reduce(dev, shard)
    return mean, torch.sqrt(dev[0] / count)


def all_gather_envs(x: torch.Tensor, shard: DataShard) -> torch.Tensor:
    """Every rank's time-major ``x`` (h, n, ...) concatenated along the env
    axis 1 in rank order: the global (h, N, ...) tensor on every rank. NCCL
    gathers CUDA tensors and gloo CPU tensors; the port does not gather CUDA
    tensors over gloo."""
    if x.is_cuda and shard.backend == "gloo":
        raise NotImplementedError(
            "all_gather_envs: the global-shuffle minibatch layout gathers the trajectory, "
            "which the port does over NCCL, or over gloo on the CPU, but not over gloo on "
            "CUDA tensors; use NCCL, or a minibatch count that divides the horizon (the "
            "time-sliced layout gathers nothing)")
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(shard.world)]
    _issue(shard, "all_gather", dist.all_gather, parts, x, group=shard.group)
    return torch.cat(parts, dim=1)


def broadcast_(tensors: Sequence[torch.Tensor], shard: DataShard):
    """Overwrite ``tensors`` in place with rank 0's, in one broadcast of a
    flat buffer of their common dtype."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    _issue(shard, "broadcast", dist.broadcast, flat,
           src=dist.get_global_rank(shard.group, 0) if shard.group is not None else 0,
           group=shard.group)
    with torch.no_grad():
        for t, x in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(x.view_as(t))


# Epoch metrics by how they combine over ranks. Left as they are: values
# every rank already holds alike (the learning rate, the KL and gradient
# norms taken after the gradients' all-reduce, the curriculum's level and
# tolerances, counters).
REPLICATED = frozenset({
    "info/kl", "info/lr", "info/epochs", "info/frames", "env/curriculum_level",
    "env/position_tolerance", "env/orientation_tolerance", "nan/grad_fin", "nan/grad_max",
    "nan/kl_mb_fin", "nan/kl_first_bad", "nan/params_fin",
})
SUMMED = frozenset({
    "episodes/finished_return_sum", "episodes/finished_count",
    "episodes/finished_success_sum", "env/current_position_goal/count",
    "env/current_orientation_goal/count",
})
PER_ENV = frozenset({"episodes/finished_returns", "episodes/finished_n"})


def _combine(key: str) -> str:
    if key in REPLICATED:
        return "keep"
    if key in SUMMED:
        return "sum"
    if key in PER_ENV:
        return "gather"
    if key.startswith("nan/"):
        if key.endswith("_fin") or key.endswith("_min"):
            return "min"
        if key.endswith("_max"):
            return "max"
    return "mean"


def reduce_metrics(metrics: Dict[str, torch.Tensor], shard: DataShard) -> Dict[str, torch.Tensor]:
    """The epoch metrics over every rank: sums add, means average, maxima
    take the largest and minima and finiteness flags the smallest (a flag is
    1.0 only if it is 1.0 on every rank); the per-env vectors become the
    global (N,) vectors. One float64 all-reduce for the sums, means and
    vectors, and one more (maxima, minima negated) where there are any."""
    out = dict(metrics)
    total, extreme = [], []
    for k, v in metrics.items():
        how = _combine(k)
        if how == "keep" or not torch.is_tensor(v):
            continue
        if how == "gather":
            full = v.new_zeros((shard.n_global,), dtype=torch.float64)
            full[shard.lo:shard.hi] = v.to(torch.float64)
            total.append((k, how, full))
        elif how in ("max", "min"):
            x = v.to(torch.float64).reshape(1)
            extreme.append((k, how, -x if how == "min" else x))
        else:
            total.append((k, how, v.to(torch.float64).reshape(1)))
    for items, op in ((total, dist.ReduceOp.SUM), (extreme, dist.ReduceOp.MAX)):
        if not items:
            continue
        flat = torch.cat([x for _, _, x in items])
        _all_reduce(flat, shard, op)
        for (k, how, x), y in zip(items, flat.split([x.numel() for _, _, x in items])):
            if how == "mean":
                y = y / shard.world
            elif how == "min":
                y = -y
            out[k] = y.to(metrics[k].dtype).reshape(metrics[k].shape if how != "gather"
                                                    else (shard.n_global,))
    return out
