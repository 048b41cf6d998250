"""Run a function in W new processes, one per rank, each in a process group.

    results = launch("package.module:function", world=2, kwargs={...}, backend="gloo")

Each rank is ``python -m leibnizgym_tpu_torch.parallel.launch <dir> <rank>``:
it joins the group through a file rendezvous in a fresh temporary
directory, calls ``function(**kwargs)`` and hands its return value back
through ``torch.save`` (tensors, numbers, strings, lists, tuples and dicts).
The children get ``OMP_NUM_THREADS=1`` unless the caller's environment sets
it, and the repository root on ``PYTHONPATH``. If a rank fails or the
timeout passes, every rank still running is killed and the error carries
the end of each rank's output.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, List, Optional

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def launch(target: str, world: int, kwargs: Optional[dict] = None, backend: str = "gloo",
           timeout: float = 600.0, echo: bool = False,
           pythonpath: Optional[List[str]] = None) -> List[Any]:
    """``target`` ("module:function") run by ``world`` ranks under
    ``backend``; returns each rank's return value in rank order. ``echo``
    prints each rank's output when all have finished; ``pythonpath``
    prepends directories to the children's import path."""
    with tempfile.TemporaryDirectory(prefix="lg_launch_") as tmp:
        torch.save(kwargs or {}, os.path.join(tmp, "kwargs.pt"))
        with open(os.path.join(tmp, "job.json"), "w") as f:
            json.dump({"target": target, "world": world, "backend": backend,
                       "timeout": timeout}, f)
        child_env = dict(os.environ)
        child_env.setdefault("OMP_NUM_THREADS", "1")
        paths = list(pythonpath or []) + [ROOT]
        if child_env.get("PYTHONPATH"):
            paths.append(child_env["PYTHONPATH"])
        child_env["PYTHONPATH"] = os.pathsep.join(paths)
        procs, logs = [], []
        try:
            for rank in range(world):
                log = open(os.path.join(tmp, f"rank{rank}.log"), "w+")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "leibnizgym_tpu_torch.parallel.launch", tmp,
                     str(rank)], stdout=log, stderr=subprocess.STDOUT, env=child_env,
                    cwd=ROOT))
            deadline = time.time() + timeout
            while any(p.poll() is None for p in procs):
                failed = [p for p in procs if p.returncode not in (None, 0)]
                if failed or time.time() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            outputs = []
            for log in logs:
                log.seek(0)
                outputs.append(log.read())
                log.close()
        if echo:
            for out in outputs:
                sys.stdout.write(out)
            sys.stdout.flush()
        codes = [p.returncode for p in procs]
        if any(c != 0 for c in codes):
            tails = "\n".join(f"--- rank {r} (exit {c}) ---\n{out[-3000:]}"
                              for r, (c, out) in enumerate(zip(codes, outputs)))
            raise RuntimeError(f"launch {target} x{world} failed:\n{tails}")
        return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=True)
                for r in range(world)]


def _child(tmp: str, rank: int) -> None:
    from leibnizgym_tpu_torch.parallel.mesh import initialize_distributed, shutdown_distributed

    with open(os.path.join(tmp, "job.json")) as f:
        job = json.load(f)
    initialize_distributed(f"file://{os.path.join(tmp, 'rendezvous')}", job["world"], rank,
                           backend=job["backend"], timeout=job["timeout"])
    module, name = job["target"].split(":")
    fn = getattr(importlib.import_module(module), name)
    result = fn(**torch.load(os.path.join(tmp, "kwargs.pt"), weights_only=True))
    torch.save(result, os.path.join(tmp, f"out{rank}.pt"))
    del result
    shutdown_distributed()


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]))
