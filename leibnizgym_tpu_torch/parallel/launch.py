"""Run a function in W processes, one per rank, each in a process group.

    results = launch("package.module:function", world=2, kwargs={...}, backend="gloo")

    with join("package.module:function", world=4, kwargs={...}, backend="nccl") as ranks:
        ...                        # the calling process is rank 0 of the group
        results = ranks.results()  # ranks 1..3's return values

``launch`` starts all W ranks as new processes and blocks until they end;
``join`` starts ranks 1..W-1 and makes the calling process rank 0 of the
same group, so that the children's start-up overlaps the caller's own
set-up. Each child is ``python -m leibnizgym_tpu_torch.parallel.launch
<dir> <rank>``: it joins the group through a file rendezvous in a fresh
temporary directory, calls ``function(**kwargs)`` and hands its return
value back through ``torch.save`` (tensors, numbers, strings, lists,
tuples and dicts). The children get ``OMP_NUM_THREADS=1`` unless the
caller's environment sets it, and the repository root on ``PYTHONPATH``;
a child whose parent process has gone exits at once.

If a rank fails or the timeout passes, every child still running is killed
and the error carries the end of each child's output. Under ``join`` a
watcher thread of the caller does the killing, and if the caller has not
left the ``with`` block ``grace`` seconds later (it may be blocked on a
collective whose peer is gone, which a CUDA graph's NCCL kernels never
give up), it ends the calling process with exit code 1, so that no rank is
left running or waiting.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, List, Optional

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class _Job:
    """Ranks ``first..world-1`` of ``target`` started as children, with the
    job's files (kwargs, rendezvous, logs, results) in a temporary
    directory."""

    def __init__(self, target: str, world: int, kwargs: Optional[dict], backend: str,
                 timeout: float, pythonpath: Optional[List[str]], first: int):
        self.target, self.world, self.first = target, world, first
        self.tmp = tempfile.mkdtemp(prefix="lg_launch_")
        self.rendezvous = f"file://{os.path.join(self.tmp, 'rendezvous')}"
        torch.save(kwargs or {}, os.path.join(self.tmp, "kwargs.pt"))
        with open(os.path.join(self.tmp, "job.json"), "w") as f:
            json.dump({"target": target, "world": world, "backend": backend,
                       "timeout": timeout}, f)
        child_env = dict(os.environ)
        child_env.setdefault("OMP_NUM_THREADS", "1")
        paths = list(pythonpath or []) + [ROOT]
        if child_env.get("PYTHONPATH"):
            paths.append(child_env["PYTHONPATH"])
        child_env["PYTHONPATH"] = os.pathsep.join(paths)
        self.deadline = time.time() + timeout
        self.procs, self.logs = [], []
        try:
            for rank in range(first, world):
                log = open(os.path.join(self.tmp, f"rank{rank}.log"), "w+")
                self.logs.append(log)
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "leibnizgym_tpu_torch.parallel.launch", self.tmp,
                     str(rank)], stdout=log, stderr=subprocess.STDOUT, env=child_env,
                    cwd=ROOT))
        except BaseException:
            self.close()
            raise

    def _out(self, rank: int) -> str:
        return os.path.join(self.tmp, f"out{rank}.pt")

    def fault(self) -> Optional[str]:
        """What went wrong: a child that exited non-zero, or the timeout
        passed with a child still running; None while all is well."""
        codes = [p.poll() for p in self.procs]
        bad = [r for r, c in zip(range(self.first, self.world), codes) if c not in (None, 0)]
        if bad:
            return f"rank {bad[0]} exited with {codes[bad[0] - self.first]}"
        if None in codes and time.time() > self.deadline:
            return "the timeout passed"
        return None

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def tails(self) -> str:
        out = []
        for rank, p, log in zip(range(self.first, self.world), self.procs, self.logs):
            log.flush()
            with open(log.name) as f:
                text = f.read()
            out.append(f"--- rank {rank} (exit {p.poll()}) ---\n{text[-3000:]}")
        return "\n".join(out)

    def wait(self, exited: bool) -> List[Any]:
        """Each child's return value, in rank order, once every child has
        exited (``exited``) or has written it; a failure kills the children
        still running and raises with the end of their output."""
        def ready():
            if exited:
                return all(p.poll() is not None for p in self.procs)
            return all(os.path.exists(self._out(r)) or p.poll() is not None
                       for r, p in zip(range(self.first, self.world), self.procs))

        while not ready() and self.fault() is None:
            time.sleep(0.05)
        fault = self.fault() or next(
            (f"rank {r} exited without a result" for r in range(self.first, self.world)
             if not os.path.exists(self._out(r))), None)
        if fault is not None:
            self.kill()
            raise RuntimeError(f"launch {self.target} x{self.world} failed ({fault}):\n"
                               f"{self.tails()}")
        return [torch.load(self._out(r), weights_only=True)
                for r in range(self.first, self.world)]

    def echo(self) -> None:
        for log in self.logs:
            log.flush()
            with open(log.name) as f:
                sys.stdout.write(f.read())
        sys.stdout.flush()

    def close(self) -> None:
        self.kill()
        for log in self.logs:
            log.close()
        shutil.rmtree(self.tmp, ignore_errors=True)


def launch(target: str, world: int, kwargs: Optional[dict] = None, backend: str = "gloo",
           timeout: float = 600.0, echo: bool = False,
           pythonpath: Optional[List[str]] = None) -> List[Any]:
    """``target`` ("module:function") run by ``world`` new processes under
    ``backend``; returns each rank's return value in rank order. ``echo``
    prints each rank's output when all have finished; ``pythonpath``
    prepends directories to the children's import path."""
    job = _Job(target, world, kwargs, backend, timeout, pythonpath, first=0)
    try:
        return job.wait(exited=True)
    finally:
        if echo:
            job.echo()
        job.close()


class Ranks:
    """The children of a ``join``: ranks 1..W-1."""

    def __init__(self, job: _Job, grace: float):
        self.job, self.grace = job, grace
        self.fault: Optional[str] = None
        self._left = threading.Event()
        self._watcher = threading.Thread(target=self._watch, daemon=True)

    def _watch(self) -> None:
        job = self.job
        while not self._left.wait(0.1):
            fault = job.fault()
            if fault is None:
                if all(p.poll() is not None for p in job.procs):
                    return
                continue
            self.fault = fault
            job.kill()
            if not self._left.wait(self.grace):
                sys.stderr.write(f"launch {job.target} x{job.world}: {fault}; rank 0 is still "
                                 f"inside the launch {self.grace:.0f} s later, so it ends "
                                 f"here\n{job.tails()}\n")
                sys.stderr.flush()
                os._exit(1)
            return

    def results(self) -> List[Any]:
        """Ranks 1..W-1's return values, in rank order, once each child has
        written its own (the children then leave the group as the caller
        does when it leaves the ``with`` block)."""
        return self.job.wait(exited=False)


@contextlib.contextmanager
def join(target: str, world: int, kwargs: Optional[dict] = None, backend: str = "gloo",
         timeout: float = 600.0, pythonpath: Optional[List[str]] = None,
         grace: float = 60.0):
    """Start ranks 1..``world``-1 of ``target`` as children and make the
    calling process rank 0 of their group (``parallel.mesh.
    initialize_distributed`` with ``timeout``, which also bounds every
    collective); yields a ``Ranks`` whose ``results()`` returns the
    children's return values. On leaving, the caller leaves the group
    (``shutdown_distributed``: drop every CUDA graph that holds its NCCL
    collectives first), waits up to 30 s for the children to end and kills
    any still running. A child that fails or outlives ``timeout`` is
    killed at once, and the caller ended ``grace`` seconds later if it is
    still inside (module docstring)."""
    from leibnizgym_tpu_torch.parallel.mesh import initialize_distributed, shutdown_distributed

    job = _Job(target, world, kwargs, backend, timeout, pythonpath, first=1)
    ranks = Ranks(job, grace)
    ranks._watcher.start()
    joined = False
    try:
        initialize_distributed(job.rendezvous, world, 0, backend=backend, timeout=timeout)
        joined = True
        yield ranks
    except BaseException:
        if ranks.fault is not None:
            sys.stderr.write(f"launch {target} x{world}: {ranks.fault}\n{job.tails()}\n")
        job.kill()
        raise
    finally:
        try:
            if joined and torch.distributed.is_initialized():
                shutdown_distributed()
            end = time.time() + 30.0
            while any(p.poll() is None for p in job.procs) and time.time() < end:
                time.sleep(0.05)
        finally:
            ranks._left.set()
            job.close()


def _watch_parent(parent: int) -> None:
    while True:
        time.sleep(0.5)
        if os.getppid() != parent:
            os._exit(1)


def _child(tmp: str, rank: int) -> None:
    from leibnizgym_tpu_torch.parallel.mesh import initialize_distributed, shutdown_distributed

    threading.Thread(target=_watch_parent, args=(os.getppid(),), daemon=True).start()
    with open(os.path.join(tmp, "job.json")) as f:
        job = json.load(f)
    initialize_distributed(f"file://{os.path.join(tmp, 'rendezvous')}", job["world"], rank,
                           backend=job["backend"], timeout=job["timeout"])
    module, name = job["target"].split(":")
    fn = getattr(importlib.import_module(module), name)
    result = fn(**torch.load(os.path.join(tmp, "kwargs.pt"), weights_only=True))
    out = os.path.join(tmp, f"out{rank}.pt")
    torch.save(result, out + ".part")
    os.replace(out + ".part", out)
    del result
    shutdown_distributed()


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]))
