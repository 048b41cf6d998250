"""``BENCHMARK.json`` holds to the benchmark's contract, and the harness finds
everything of a cell by the names it gives: no code path names a cell."""

import json
import os
import re

import pytest

from perfbench import harness

BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entries():
    names = {}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.setdefault(group, set()).add(entry["name"])
        assert len(names[group]) == len(BENCH[group])
    metric_names = names["end_to_end"] | names["per_layer"]
    assert len(metric_names) == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in names["end_to_end"]
        assert 1 <= len(m["layer"]) <= 200
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must():
    configs = {c["name"] for c in BENCH["configs"]}
    used = set()
    for cell in BENCH["workloads"]:
        assert cell["config"] in configs and cell["chips"] in (1, 4)
        assert len(cell["why"]) <= 200 and "\n" not in cell["why"]
        used.add(cell["config"])

        def mine(m):
            return cell["name"] in m.get("workloads", [cell["name"]])

        e2e = [m["name"] for m in BENCH["end_to_end"] if mine(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in BENCH["per_layer"] if mine(m)]
        assert layer and all(m["moves"] in e2e for m in layer)
    assert used == configs
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_config_files_hold_the_configuration():
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/")
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert c["reduced"] == cfg["reduced_from_source"] == []
        assert c["source"].startswith("https://")
        assert {"gym", "rlg_params", "physics_kernel"} <= set(cfg)


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_cell_resolves_by_name(cell):
    """The cell's configuration, traffic, driver, limits and metric readers,
    each found by the name ``BENCHMARK.json`` gives."""
    resolved = harness.resolve(BENCH, cell)
    spec = resolved.spec
    assert resolved.traffic == harness.load_json(
        os.path.join(harness.ROOT, "perfbench", "traffic", spec["traffic"] + ".json"))
    assert hasattr(resolved.driver, "run")
    assert set(resolved.limits["numbers"])
    for entry, reader in resolved.per_layer:
        assert hasattr(reader, "read"), entry["name"]


def test_no_code_names_a_cell():
    cells = [c["name"] for c in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    for dirpath, _, files in os.walk(os.path.join(harness.ROOT, "perfbench")):
        if os.sep + "tests" in dirpath:
            continue
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                for name in cells:
                    assert name not in text, (f, name)
