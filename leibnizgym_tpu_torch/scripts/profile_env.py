"""Profile the env step, the physics step or a training epoch with
torch.profiler (counterpart of ``scripts/profile_env.py``, same options and
configurations).

    python -m leibnizgym_tpu_torch.scripts.profile_env --what env
    python -m leibnizgym_tpu_torch.scripts.profile_env --what train --num-envs 8192
    python -m leibnizgym_tpu_torch.scripts.profile_env --what physics --num-envs 8 --device cpu

- ``env``: ``TrifingerEnv.step`` of a torque-mode env with 2 substeps and a
  zero action, ``--steps`` steps (on the card the captured step);
- ``physics``: the physics step alone (the CUDA kernel on the card, its
  plain version on the CPU) from the default state and scene,
  ``SolverConfig(substeps=2, solver_iterations=4)``, ``--steps`` steps;
- ``train``: ``--epochs`` (3) epochs with ``PPOConfig(minibatch_size=N)``
  on an asymmetric env, ``--horizon`` (32) env steps each: on the card the
  captured epoch of ``learning/graphs.py``, as ``Runner.train`` runs it.

``--eager`` profiles the eager functions instead (``env_step``,
``train_iteration``). After one warm-up call (which builds the kernel and,
graphed, captures) the window runs under ``torch.profiler`` with CPU and
CUDA activities, and its Chrome trace is written into ``--trace-dir`` (open
it in Perfetto or chrome://tracing). Printed, with the card's name and
power limit: the window's wall time and the device's busy time (the union
of the kernel, memcpy and memset intervals of the trace) and idle share;
the same window's wall time run again without the profiler, and the idle
share against it; per env step the kernels the device ran (a graph's
included), the launches the host made (kernel, graph, memcpy and memset
calls, ``cuda*`` of the runtime API and ``cu*`` below it, a ``cu*`` call
inside a ``cuda*`` call counted once) and the operator calls (top-level ``aten`` ops); the 10
device operations that took the most time; the 10 longest idle gaps of the
window, each with the innermost program span (``utils/trace.py``, a range of
the trace) open on the host at the gap's end: with ``--what train`` the
epoch's ``epoch.*`` spans. On the CPU the busy time is the
union of the top-level operator calls and there are no kernels. The plain physics step is ~80,000 operator calls, so on the CPU
keep the window small (``--steps 1``, ``--epochs 1 --horizon 1``).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from leibnizgym_tpu_torch.envs.trifinger.env import (
    TrifingerEnv,
    draw_init_randoms,
    draw_step_randoms,
    env_reset,
    env_step,
)
from leibnizgym_tpu_torch.utils import trace as program_trace
from leibnizgym_tpu_torch.utils.helpers import resolve_device, smi

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union_ms(intervals) -> float:
    """Total length (ms) of the union of (start_us, end_us) intervals."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def idle_gaps(trace, busy_cats, top: int = 10) -> list:
    """The ``top`` longest gaps between the union of the trace's events of
    the categories ``busy_cats``, longest first, as (ms, the innermost
    program span open at the gap's end: the ``user_annotation`` range of
    latest start that holds it, or "(none)"; the end's trace time in us)."""
    merged = []
    for a, b in sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in trace
                       if e.get("cat") in busy_cats):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    spans = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in trace
             if e.get("cat") == "user_annotation"]
    gaps = sorted(((b0 - a1, b0) for (_, a1), (b0, _) in zip(merged, merged[1:])), reverse=True)
    out = []
    for length, end in gaps[:top]:
        held = [(s, name) for s, e, name in spans if s <= end <= e]
        out.append((length / 1e3, max(held)[1] if held else "(none)", end))
    return out


def _top_level_op(e) -> bool:
    """An ``aten`` operator call on the host inside no other one (a program
    span's range may hold it)."""
    if e.device_type != torch.autograd.DeviceType.CPU or not e.name.startswith("aten::"):
        return False
    p = e.cpu_parent
    while p is not None:
        if p.name.startswith("aten::"):
            return False
        p = p.cpu_parent
    return True


HOST_LAUNCHES = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel", "cudaGraphLaunch",
    "cudaMemcpyAsync", "cudaMemsetAsync", "cuLaunchKernel", "cuLaunchKernelEx", "cuGraphLaunch",
    "cuMemcpyAsync", "cuMemsetD8Async", "cuMemsetD32Async"})


def host_launches(trace) -> dict:
    """The trace's launch calls by name; a ``cu*`` call that lies inside a
    ``cuda*`` call of the same thread is that call's and is left out."""
    calls = [e for e in trace if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and e.get("name") in HOST_LAUNCHES]
    runtime = collections.defaultdict(list)
    for e in calls:
        if e["cat"] == "cuda_runtime":
            runtime[e.get("tid")].append((e["ts"], e["ts"] + e.get("dur", 0)))
    out = collections.Counter()
    for e in calls:
        if e["cat"] == "cuda_driver" and any(
                a <= e["ts"] <= b for a, b in runtime.get(e.get("tid"), ())):
            continue
        out[e["name"]] += 1
    return dict(out)


def build_workload(what: str, n: int, steps: int, device, epochs: int = 3,
                   horizon: int = 32, eager: bool = False):
    """(one call of the workload, env steps per call, calls in the window)."""
    env = TrifingerEnv(config={"num_instances": n, "command_mode": "torque",
                               "asymmetric_obs": what == "train", "sim": {"substeps": 2}},
                       device=device, verbose=False)
    static, params = env.static, env.params
    if what == "train":
        from leibnizgym_tpu_torch.learning.graphs import GraphedEpoch
        from leibnizgym_tpu_torch.learning.ppo import PPOConfig, init_train_state, train_iteration

        cfg = PPOConfig(minibatch_size=n, horizon=horizon)
        ts = init_train_state(cfg, static, params, 0)
        epoch = train_iteration if eager or device.type != "cuda" else GraphedEpoch()
        return (lambda: epoch(cfg, static, params, ts)), cfg.horizon, epochs
    if what == "physics":
        from leibnizgym_tpu_torch.ops.cuda_engine import physics_step_cuda
        from leibnizgym_tpu_torch.ops.types import PhysicsState, SceneParams, SolverConfig

        box = {"state": PhysicsState.default(n, device)}
        scene = SceneParams.default(device=device).broadcast(n)
        tau = torch.zeros((n, 9), device=device)
        solver = SolverConfig(substeps=2, solver_iterations=4)

        def physics():
            box["state"], _ = physics_step_cuda(box["state"], tau, scene, solver, 0.02)

        return physics, 1, steps
    action = torch.zeros((n, static.action_dim), device=device)
    if not eager:
        env.seed(0)
        env.reset()
        return (lambda: env.step(action)), 1, steps
    gen = torch.Generator(device=device).manual_seed(0)
    state, _ = env_reset(static, params, *draw_init_randoms(static, gen, n, device))
    box = {"state": state}

    def step():
        box["state"] = env_step(static, params, box["state"], action,
                                draw_step_randoms(static, gen, n, device))[0]

    return step, 1, steps


def profile_workload(what: str, num_envs: int = 8192, steps: int = 20,
                     trace_dir: str = "output/torch_trace", device="cuda:0", epochs: int = 3,
                     horizon: int = 32, eager: bool = False) -> dict:
    """Warm up, profile the window, write the trace, print and return the
    figures."""
    device = resolve_device(device, cpu_hint="--device cpu")
    cuda = device.type == "cuda"
    call, env_steps_per_call, calls = build_workload(what, num_envs, steps, device, epochs,
                                                     horizon, eager)
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def window() -> float:
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        sync()
        return (time.perf_counter() - t0) * 1e3

    call()  # warm-up: builds the kernel, fills the caching allocator
    sync()
    wall_unprofiled = window()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        program_trace.refresh()  # the program's spans as ranges of the trace
        wall_ms = window()
    program_trace.refresh()
    os.makedirs(trace_dir, exist_ok=True)
    mode = "graphed" if cuda and not eager and what != "physics" else "eager"
    path = os.path.join(trace_dir, f"{what}_{device.type}_{num_envs}"
                                   f"{'_eager' if eager else ''}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]

    top_ops = [e for e in prof.events() if _top_level_op(e)]
    dev_events = [e for e in trace if e.get("cat") in DEVICE_CATS]
    kernels = [e for e in dev_events if e["cat"] == "kernel"]
    if cuda:
        busy_ms = _union_ms((e["ts"], e["ts"] + e["dur"]) for e in dev_events)
        per_op = collections.defaultdict(lambda: [0.0, 0])
        for e in dev_events:
            per_op[e["name"]][0] += e["dur"] / 1e3
            per_op[e["name"]][1] += 1
    else:
        busy_ms = _union_ms((e.time_range.start, e.time_range.end) for e in top_ops)
        per_op = collections.defaultdict(lambda: [0.0, 0])
        for e in top_ops:
            per_op[e.name][0] += e.time_range.elapsed_us() / 1e3
            per_op[e.name][1] += 1
    env_steps = env_steps_per_call * calls
    launched = host_launches(trace)
    gaps = idle_gaps(trace, DEVICE_CATS if cuda else ("cpu_op",))
    out = {
        "what": what, "mode": mode, "device": str(device), "num_envs": num_envs,
        "env_steps": env_steps,
        "wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
        "wall_ms_unprofiled": wall_unprofiled,
        "idle_share_unprofiled": 1.0 - busy_ms / wall_unprofiled,
        "launches_per_env_step": len(kernels) / env_steps,
        "host_launches_per_env_step": sum(launched.values()) / env_steps,
        "host_launches": launched,
        "ops_per_env_step": len(top_ops) / env_steps,
        "top": sorted(((name, ms, k) for name, (ms, k) in per_op.items()),
                      key=lambda x: -x[1])[:10],
        "idle_gaps": [(ms, span) for ms, span, _ in gaps],
        "trace": path,
    }
    where = smi() if cuda else "cpu"
    print(f"{where} profile what={what} mode={mode} num_envs={num_envs} env_steps={env_steps} "
          f"wall_ms={wall_ms:.3f} busy_ms={busy_ms:.3f} idle_share={out['idle_share']:.4f} "
          f"wall_ms_unprofiled={wall_unprofiled:.3f} "
          f"idle_share_unprofiled={out['idle_share_unprofiled']:.4f}", flush=True)
    print(f"{where} profile what={what} mode={mode} "
          f"launches_per_env_step={out['launches_per_env_step']:.1f} "
          f"host_launches_per_env_step={out['host_launches_per_env_step']:.1f} "
          f"ops_per_env_step={out['ops_per_env_step']:.1f} kernels={len(kernels)} "
          f"top_level_ops={len(top_ops)} host_launches={launched}", flush=True)
    for name, ms, k in out["top"]:
        print(f"{where} profile what={what} top ms={ms:.3f} calls={k} op={name[:120]}", flush=True)
    for ms, span, _ in gaps:
        print(f"{where} profile what={what} idle_gap ms={ms:.3f} span={span}", flush=True)
    if cuda and not kernels:
        cats = sorted({str(e.get("cat")) for e in trace})
        print(f"profile: the trace holds no kernel (categories {cats}); the device was not "
              "traced", flush=True)
    print(f"trace written to {path}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace-dir", type=str, default="output/torch_trace")
    ap.add_argument("--num-envs", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--what", choices=["env", "physics", "train"], default="env")
    ap.add_argument("--epochs", type=int, default=3, help="train: epochs in the window")
    ap.add_argument("--horizon", type=int, default=32, help="train: env steps per epoch")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--eager", action="store_true",
                    help="profile the eager env_step / train_iteration, not the captured ones")
    args = ap.parse_args(argv)
    profile_workload(args.what, args.num_envs, args.steps, args.trace_dir, args.device,
                     args.epochs, args.horizon, args.eager)
    return 0


if __name__ == "__main__":
    sys.exit(main())
