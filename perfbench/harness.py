"""The benchmark of ``leibnizgym_tpu_torch``, driven by ``BENCHMARK.json``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration and a traffic mix; the harness finds each by
name: ``perfbench/configs/<config>.json`` (the configuration as run),
``perfbench/traffic/<traffic>.json`` (the mix's parameters, whose
``driver`` names the module under ``perfbench/drivers/`` that runs it),
``perfbench/limits/<cell>.json`` (the limit of each number that decides
``correct``) and ``perfbench/metrics/<metric>.py`` for each per-layer
metric (its ``read(result, ctx)`` returns the value, or None where the run
holds nothing to read). No code path names a cell.

A driver's ``run(ctx)`` sets up, calls ``ctx.setup_done()`` where the
window starts, measures for ``ctx.seconds``, reads the device's memory
peak, frees the program's state and compares with the reference. It
returns the end-to-end values (``e2e``), the spans and counters, with
``--trace 1`` the profiled stretch (``trace``), and the numbers compared
(``numbers``).

The result is the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which also end standard error. Without a CUDA device, with fewer devices
than the cell asks for, or when JAX or the JAX package is loaded once the
window has closed, the run exits with 2 and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import math
import statistics
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "leibnizgym_tpu")


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def load_module(path: str, name: str):
    """The module of the file at ``path`` (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with everything found by its names."""

    spec: dict
    config: dict
    traffic: dict
    limits: dict
    driver: object
    end_to_end: list
    per_layer: list  # (metric entry, reader module)


def resolve(bench: dict, name: str) -> Cell:
    """The cell ``name`` of ``bench`` with its configuration, traffic,
    limits, driver and the metrics it reports."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    spec = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(ROOT, configs[spec["config"]]["file"]))
    base = HERE
    traffic = load_json(os.path.join(base, "traffic", spec["traffic"] + ".json"))
    limits = load_json(os.path.join(base, "limits", name + ".json"))
    driver = load_module(os.path.join(base, "drivers", traffic["driver"] + ".py"),
                         f"perfbench_driver_{traffic['driver']}")

    def mine(entry):
        return name in entry.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    layer = [(m, load_module(os.path.join(base, "metrics", m["name"] + ".py"),
                             "perfbench_metric_" + m["name"].replace(".", "_")))
             for m in bench["per_layer"] if mine(m)]
    return Cell(spec, config, traffic, limits, driver, e2e, layer)


@dataclasses.dataclass
class Context:
    """What a driver and a metric reader are given."""

    root: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    tmpdir: str
    t_start: float
    setup_s: Optional[float] = None

    @property
    def on_card(self) -> bool:
        return self.device.startswith("cuda")

    def log(self, msg: str) -> None:
        log(msg)

    def sync(self) -> None:
        if self.on_card:
            import torch

            torch.cuda.synchronize()

    def setup_done(self) -> None:
        """Called where the window starts: set-up ends here."""
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start

    def free(self) -> None:
        """Release the program's state before the reference runs."""
        gc.collect()
        if self.on_card:
            import torch

            torch.cuda.empty_cache()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float) -> dict:
    """Run a cell through its driver; returns the driver's result with
    ``setup_s`` among its end-to-end values and the checks judged."""
    ctx = Context(root=ROOT, cell=cell.spec, config=cell.config, traffic=cell.traffic,
                  seed=seed, seconds=seconds, trace=trace, device=device,
                  tmpdir=os.environ.get("TMPDIR", tempfile.gettempdir()), t_start=t_start)
    result = cell.driver.run(ctx)
    result["e2e"]["setup_s"] = ctx.setup_s
    checks = {}
    for name, value in result["numbers"].items():
        limit = cell.limits["numbers"][name]
        checks[name] = {"value": value, "limit": limit}
    result["checks"] = checks
    result["correct"] = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                            for c in checks.values())
    result["per_layer"] = {}
    for entry, reader in cell.per_layer:
        value = reader.read(result, ctx)
        if value is not None:
            result["per_layer"][entry["name"]] = {"value": value, "unit": entry["unit"]}
    result["ctx"] = ctx
    return result


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (compared whole: ``leibnizgym_tpu_torch`` is not
    ``leibnizgym_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line(query: str = "name,power.limit") -> str:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def result_line(cell: Cell, result: dict, trace: bool) -> dict:
    import torch

    metrics = result["per_layer"] if trace else {
        m["name"]: {"value": result["e2e"][m["name"]], "unit": m["unit"]}
        for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell.spec["chips"]),
              "memory_peak_bytes": int(result["memory_peak_bytes"])}
    line = {"correct": bool(result["correct"]), "attempted": int(result["attempted"]),
            "failed": int(result["failed"]), "metrics": metrics, "device": device}
    summary = result.get("trace")
    if trace and summary is not None:
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
        line["breakdown"] = {"device_ops": [[k, v] for k, v in summary.device_ops],
                             "idle_gaps": [[k, v] for k, v in summary.idle_gaps]}
    line["checks"] = result["checks"]
    return line


def main(argv, t_start: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = resolve(bench, args.workload)
    import torch

    from perfbench import yardstick

    chips = int(cell.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {card_line()}; peaks: {yardstick.PEAKS_SOURCE}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", t_start)
    found = forbidden_modules()
    if found:
        log(f"loaded after the window: {', '.join(found)}; no result")
        return 2
    ctx = result["ctx"]
    log("after the window: " + card_line("clocks.sm,temperature.gpu,power.draw"))
    log("; ".join(f"{k} {v!r}" for k, v in result["e2e"].items()))
    for name, values in result["spans"].items():
        if len(values) >= 2:
            q = statistics.quantiles(values, n=10)
            log(f"{name}: {len(values)} spans, deciles {[round(x, 3) for x in q]}, "
                f"max {max(values):.3f}")
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result_line(cell, result, bool(args.trace))), flush=True)
    return 0
