"""What the host does in each idle stretch of the card, from the program's
spans (``leibnizgym_tpu_torch/utils/trace.py``), for a benchmark cell.

    python3 tools/trace_window.py --workload d1_asymm_8192 --seed 5 --seconds 150 \\
        --out output/trace_window

Builds the cell's Runner as ``perfbench/drivers/train.py`` does (its set-up
epochs included) and then:

1. trains a window of ``--seconds`` through ``Runner.train``, no profiler
   recording, and prints the benchmark's span metrics (``perfbench/
   metrics``), per span name its median wall time per iteration, and the
   same split between the window's fast and slow epochs (device
   start-to-start time from the program's marks, split at the midpoint of
   its 10th and 90th percentiles) with the thread's off-CPU time and the
   card's SM clock, memory clock, power and throttle reasons, sampled by
   ``nvidia-smi`` every 500 ms through the window: which part of the host
   loop, or of the card, differs between the two speeds;
2. profiles ``--profile-epochs`` epochs six times in turns, with the
   program's ranges in the trace or without (on, off, off, on, on, off); prints each
   stretch's epoch time (the cost of the ranges) and, from the first
   stretch's Chrome trace, the ten longest device idle gaps, each with the
   innermost program span open at its end and the last CUDA runtime call
   before it, and per ``runner.readback`` range how long the device stayed
   busy inside it and how far its end lies from the device's last activity
   (a read-back that waits for the epoch enqueued just before it ends as
   the device goes idle);
3. times the tracer's own host cost per host-loop iteration with no
   profiler recording: an iteration's spans and device marks, repeated.

Each window's per-iteration rows go to ``--out``/``<workload>_rows.jsonl``.
Needs a CUDA device; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import datetime
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from leibnizgym_tpu_torch.scripts.profile_env import idle_gaps  # noqa: E402
from leibnizgym_tpu_torch.utils import trace  # noqa: E402
from leibnizgym_tpu_torch.utils.helpers import smi  # noqa: E402
from perfbench import harness  # noqa: E402

METRICS = ("readback_wait_ms", "draws_ms", "graph_launch_ms", "host_process_ms",
           "host_offcpu_ms", "gae_ms", "graph_replays_per_epoch", "epoch_setup_ms")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def build(cell: harness.Cell, seed: int, device: str):
    """(runner, harness context, seconds an epoch): the cell's set-up."""
    ctx = harness.Context(root=ROOT, cell=cell.spec, config=cell.config, traffic=cell.traffic,
                          seed=seed, seconds=0.0, trace=False, device=device,
                          tmpdir=os.environ.get("TMPDIR", tempfile.gettempdir()),
                          t_start=time.perf_counter())
    runner, _, _, epoch_s = cell.driver.setup(ctx)
    return runner, ctx, epoch_s


def rows_of(w: trace.Window) -> list:
    """Per iteration of the window: its process's rank, wall and CPU ms of
    the iteration and of each span name under it (summed), the off-CPU ms
    outside the read-back, and the device phases from the epoch's marks."""
    rows = []
    for it, under in w.iterations:
        row = {"epoch": it.attrs["epoch"], "rank": it.rank, "t_ns": it.start_ns,
               "wall": it.wall_ms, "cpu": it.cpu_ms, "spans": {}}
        for s in under:
            row["spans"][s.name] = row["spans"].get(s.name, 0.0) + s.wall_ms
            if s.name == "epoch":
                row["marks"] = s.marks_ms
        rb = [s for s in under if s.name == "runner.readback"]
        row["offcpu"] = (it.wall_ms - sum(s.wall_ms for s in rb)) - \
            (it.cpu_ms - sum(s.cpu_ms for s in rb))
        rows.append(row)
    for row, nxt in zip(rows, rows[1:]):
        m, n = row.get("marks"), nxt.get("marks")
        if m and n:
            row["device"] = {"epoch": n["start"] - m["start"], "rollout": m["rollout"] - m["start"],
                             "gae": m["gae"] - m["rollout"], "update": m["update"] - m["gae"],
                             "gap": n["start"] - m["update"]}
    return rows


SMI_FIELDS = ("clocks.sm", "clocks.mem", "power.draw", "temperature.gpu",
              "clocks_throttle_reasons.active")


def start_smi() -> Optional[subprocess.Popen]:
    """``nvidia-smi`` printing ``SMI_FIELDS`` every 500 ms, or None."""
    try:
        return subprocess.Popen(["nvidia-smi", "--query-gpu=timestamp," + ",".join(SMI_FIELDS),
                                 "--format=csv,noheader,nounits", "-lms", "500"],
                                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError:
        return None


def stop_smi(proc: Optional[subprocess.Popen]) -> list:
    """The samples as (realtime ns, {field: value}), in order."""
    if proc is None:
        return []
    proc.terminate()
    out, _ = proc.communicate(timeout=30)
    samples = []
    for line in out.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) != len(SMI_FIELDS) + 1:
            continue
        try:
            t = datetime.datetime.strptime(parts[0], "%Y/%m/%d %H:%M:%S.%f").timestamp()
        except ValueError:
            continue
        vals = {}
        for k, v in zip(SMI_FIELDS, parts[1:]):
            try:
                vals[k] = int(v, 16) if v.startswith("0x") else float(v)
            except ValueError:
                pass
        samples.append((int(t * 1e9), vals))
    return samples


def attach_smi(rows: list, samples: list) -> None:
    """Each row's ``smi``: the last sample taken before its iteration began."""
    times = [t for t, _ in samples]
    for row in rows:
        i = bisect.bisect_right(times, row["t_ns"]) - 1
        if i >= 0:
            row["smi"] = samples[i][1]


def split_speeds(rows: list) -> dict:
    """Medians of every quantity over the fast and the slow epochs."""
    rows = [r for r in rows if "device" in r]
    if len(rows) < 10:
        return {}
    t = [r["device"]["epoch"] for r in rows]
    p10, p90 = np.percentile(t, [10, 90])
    cut = (p10 + p90) / 2
    out = {}
    for tag, group in (("fast", [r for r in rows if r["device"]["epoch"] <= cut]),
                       ("slow", [r for r in rows if r["device"]["epoch"] > cut])):
        if not group:
            continue
        med = {"n": len(group), "offcpu": statistics.median(r["offcpu"] for r in group),
               "wall": statistics.median(r["wall"] for r in group),
               "cpu": statistics.median(r["cpu"] for r in group)}
        for k in group[0]["device"]:
            med["device." + k] = statistics.median(r["device"][k] for r in group)
        for name in sorted({n for r in group for n in r["spans"]}):
            med[name] = statistics.median(r["spans"].get(name, 0.0) for r in group)
        for k in SMI_FIELDS:
            vals = [r["smi"][k] for r in group if k in r.get("smi", {})]
            if vals:
                med["smi." + k] = statistics.median(vals)
        reasons = collections.Counter(r["smi"].get("clocks_throttle_reasons.active")
                                      for r in group if "smi" in r)
        med["smi.throttle_reasons"] = {hex(int(k)) if k is not None else None: n
                                       for k, n in reasons.items()}
        out[tag] = med
    out["cut_ms"] = cut
    return out


def profiled(runner, epochs: int, ranges: bool):
    """(ms an epoch, profiler) of ``epochs`` epochs under ``torch.profiler``,
    the program's ranges in the trace or not."""
    from perfbench import trace as bench_trace

    if not ranges:
        trace.TRACER.refresh = lambda: None  # keeps the ranges off under the profiler
        trace.TRACER._ranges = False
    prof = bench_trace.profiler()
    start = int(runner.ts.epoch)
    try:
        torch.cuda.synchronize()
        prof.start()
        t0 = time.perf_counter()
        runner.train(max_epochs=start + epochs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / epochs
        prof.stop()
    finally:
        if not ranges:
            del trace.TRACER.refresh
    return ms, prof


def gap_report(prof, path: str) -> dict:
    """The ten longest device idle gaps with their spans and host calls, and
    the read-backs against the device's activity, from ``prof``'s Chrome
    trace (written to ``path``, then removed)."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    os.remove(path)
    dev = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                 if e.get("cat") in DEVICE_CATS)
    runtime = sorted((e["ts"], e["name"]) for e in events if e.get("cat") == "cuda_runtime")
    merged = []
    for a, b in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    window = merged[-1][1] - merged[0][0] if merged else 0.0
    gaps = []
    for ms, span, end in idle_gaps(events, DEVICE_CATS):
        calls = [n for ts, n in runtime if ts <= end]
        gaps.append({"ms": ms, "span": span, "host_call": calls[-1] if calls else None})
    readbacks = []
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] == "runner.readback":
            s0, s1 = e["ts"], e["ts"] + e["dur"]
            inside = sum(max(0.0, min(b, s1) - max(a, s0)) for a, b in merged)
            last = max((b for a, b in merged if a <= s1), default=None)
            readbacks.append({"ms": e["dur"] / 1e3, "device_busy_ms": inside / 1e3,
                              "end_after_device_ms": (s1 - last) / 1e3 if last else None})
    return {"idle_share": 1.0 - busy / window if window else None, "window_ms": window / 1e3,
            "gaps": gaps, "readbacks": readbacks}


class _Off:
    """The tracer's calls as no-ops: the loop's cost without it."""

    _null = contextlib.nullcontext()

    def iteration(self, epoch):
        return self._null

    def span(self, name, /, **attrs):
        return self._null

    def mark(self, phase, cuda):
        pass

    def resolve(self, ep):
        pass


def _iterations(t, n: int, cuda: bool) -> float:
    """Seconds for ``n`` host-loop iterations' tracer calls on ``t``: 12
    spans, the epoch's 4 marks, the resolution of the epoch before."""
    prev = None
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        with t.iteration(i):
            with t.span("epoch") as ep:
                t.mark("start", cuda)
                with t.span("epoch.draws"):
                    pass
                for phase in ("rollout", "gae", "update"):
                    with t.span("epoch.launch." + phase):
                        t.mark(phase, cuda)
                with t.span("epoch.metrics"):
                    pass
            with t.span("runner.snapshot"):
                pass
            with t.span("runner.readback", read=i - 1):
                pass
            t.resolve(prev)
            with t.span("runner.process"):
                with t.span("runner.summary"):
                    pass
                with t.span("runner.checkpoint", name="last"):
                    pass
        prev = ep
    seconds = time.perf_counter() - t0
    if cuda:
        torch.cuda.synchronize()
    return seconds


def tracer_cost(cuda: bool, n: int = 2000) -> float:
    """Host microseconds per host-loop iteration that the tracer's calls
    take with no profiler recording: the loop above on a tracer, less the
    same loop with no-ops, medians of five turns each."""
    t = trace.Tracer()
    t.sync_clock()
    _iterations(t, 100, cuda)  # warm
    on = statistics.median(_iterations(t, n, cuda) for _ in range(5))
    off = statistics.median(_iterations(_Off(), n, cuda) for _ in range(5))
    return (on - off) / n * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--seconds", type=float, default=150.0)
    ap.add_argument("--profile-epochs", type=int, default=5)
    ap.add_argument("--out", default="output/trace_window")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_window needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.resolve(bench, args.workload)
    name = args.workload
    runner, ctx, epoch_s = build(cell, args.seed, "cuda:0")
    print(f"{smi()} {name}: set-up {time.perf_counter() - ctx.t_start:.1f} s, "
          f"epoch {epoch_s * 1e3:.1f} ms", flush=True)

    start = int(runner.ts.epoch)
    epochs = max(10, math.ceil(args.seconds / epoch_s))
    sampler = start_smi()
    runner.train(max_epochs=start + epochs)
    torch.cuda.synchronize()
    samples = stop_smi(sampler)
    w = trace.window()
    metrics = {m: harness.load_module(os.path.join(ROOT, "perfbench", "metrics", m + ".py"),
                                      "tw_" + m).read({}, ctx) for m in METRICS}
    print(f"{name} metrics {json.dumps(metrics)}", flush=True)
    rows = rows_of(w)
    attach_smi(rows, samples)
    print(f"{name} nvidia-smi samples {len(samples)}", flush=True)
    with open(os.path.join(args.out, f"{name}_rows.jsonl"), "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    names = sorted({n for r in rows for n in r["spans"]})
    med = {n: round(statistics.median(r["spans"].get(n, 0.0) for r in rows), 4) for n in names}
    print(f"{name} window {len(rows)} iterations; median ms per iteration {json.dumps(med)}",
          flush=True)
    speeds = split_speeds(rows)
    for tag in ("fast", "slow"):
        if tag in speeds:
            print(f"{name} {tag} (device epoch vs {speeds['cut_ms']:.1f} ms) "
                  + json.dumps({k: round(v, 4) if isinstance(v, float) else v
                                for k, v in speeds[tag].items()}), flush=True)

    for turn, ranges in enumerate((True, False, False, True, True, False)):
        ms, prof = profiled(runner, args.profile_epochs, ranges)
        print(f"{name} profiled turn {turn} ranges={ranges}: {ms:.2f} ms an epoch", flush=True)
        if turn == 0:
            rep = gap_report(prof, os.path.join(ctx.tmpdir, f"trace_window_{name}.json"))
            print(f"{name} profiled idle share {rep['idle_share']:.4f} of "
                  f"{rep['window_ms']:.1f} ms", flush=True)
            for g in rep["gaps"]:
                print(f"{name} idle_gap ms={g['ms']:.3f} span={g['span']} "
                      f"host_call={g['host_call']}", flush=True)
            for r in rep["readbacks"]:
                print(f"{name} readback {json.dumps({k: round(v, 3) if v is not None else v for k, v in r.items()})}",
                      flush=True)
            with open(os.path.join(args.out, f"{name}_profiled.json"), "w") as f:
                json.dump(rep, f)
        del prof
    print(f"{name} tracer cost, no profiler: {tracer_cost(True):.2f} us an iteration "
          f"(host clock only: {tracer_cost(False):.2f})", flush=True)
    if runner.writer is not None:
        runner.writer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
