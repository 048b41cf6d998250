"""The port's tracer (``leibnizgym_tpu_torch/utils/trace.py``) on the CPU:
spans nest per thread with their parents, epochs and threads in a bounded
buffer; a 32-env ``Runner.train`` keeps one ``runner.iteration`` per epoch
with the loop's and the epoch function's spans in order, host-clock phase
marks and the epoch's replays (``ops/capture.py`` ``replay_count``) and
kernel launches; ranges open only while a ``torch.profiler``
records, and then sit in its trace where the spans are; a collection of
generation 2 is a ``host.gc`` span."""

import gc
import json
import threading

import pytest
import torch

from leibnizgym_tpu_torch.config.presets import parse_cli, update_cfg
from leibnizgym_tpu_torch.learning.graphs import GraphedEpoch
from leibnizgym_tpu_torch.learning.runner import Runner
from leibnizgym_tpu_torch.ops import capture, cuda_engine
from leibnizgym_tpu_torch.utils import trace

torch.set_num_threads(1)


@pytest.mark.parametrize("keep", [2, 5])
def test_spans_nest_per_thread_in_a_bounded_buffer(keep):
    t = trace.Tracer(iterations=keep, loose=keep)
    with t.span("runner.train") as call:
        for epoch in range(1, 9):
            with t.iteration(epoch) as it:
                with t.span("epoch", replays=3) as ep:
                    with t.span("epoch.draws") as draws:
                        pass
                box = {}

                def other():
                    with t.span("worker") as w:
                        box["w"] = w

                th = threading.Thread(target=other)
                th.start()
                th.join(timeout=30)
                assert not th.is_alive()
            assert (ep.parent, draws.parent, it.parent) == (it.id, ep.id, call.id)
            assert ep.epoch == draws.epoch == box["w"].epoch == epoch
            assert box["w"].parent is None and box["w"].thread != ep.thread == it.thread
            assert ep.attrs == {"replays": 3} and it.attrs == {"epoch": epoch}
            assert it.start_ns <= ep.start_ns <= draws.start_ns <= draws.end_ns <= ep.end_ns
            assert 0 <= ep.cpu_ms <= ep.wall_ms and 0 <= it.cpu_ms <= it.wall_ms
            assert draws.cpu_ms is None  # too short for the thread's CPU clock
        for _ in range(3 * keep):
            with t.span("loose"):
                pass
    recs = t.records()
    names = [s.name for s in recs]
    assert names.count("runner.iteration") == keep  # the last ones
    assert {s.attrs["epoch"] for s in recs if s.name == "runner.iteration"} == \
        set(range(9 - keep, 9))
    assert names.count("loose") == keep and names.count("runner.train") == 1
    assert len(recs) == 1 + keep * 4 + keep
    assert [s.start_ns for s in recs] == sorted(s.start_ns for s in recs)
    w = t.window()
    assert w.call is call and len(w.iterations) == keep
    assert all({s.name for s in under} == {"epoch", "epoch.draws"} for _, under in w.iterations)


def _runner(tmp_path):
    cfg = parse_cli([])
    cfg["args"].update(num_envs=32, seed=0)
    cfg = update_cfg(cfg)
    cfg["gym"]["sim"]["substeps"] = 1
    cfg["gym"]["sim"]["physx"]["num_position_iterations"] = 2
    cfg["rlg"]["params"]["config"].update(steps_num=2, mini_epochs=1, minibatch_size=32,
                                          host_pipeline_depth=2, save_frequency=1)
    cfg["rlg"]["params"]["config"]["central_value_config"].update(mini_epochs=1,
                                                                  minibatch_size=32)
    return Runner(cfg["gym"], cfg["rlg"]["params"], logdir=str(tmp_path), seed=0, device="cpu")


@pytest.mark.parametrize("graphed", [True, False])
def test_runner_train_keeps_the_loop_and_epoch_spans(tmp_path, graphed):
    """Three epochs at depth 2: each iteration holds its epoch (with the
    epoch function's spans, its marks and its replays: the graphed epoch's
    body runs off the card, none eagerly), its snapshot and from the second
    on the read-back of the epoch before and its processing."""
    r = _runner(tmp_path)
    r.reset()
    if graphed:
        r._train_iter = GraphedEpoch()
    before = trace.records()[-1].id if trace.records() else 0
    replays = capture.replay_count
    r.train(max_epochs=3)
    w = trace.window([s for s in trace.records() if s.id > before])
    assert w is not None and [it.attrs["epoch"] for it, _ in w.iterations] == [1, 2, 3]
    kids = {}
    for s in w.spans:
        kids.setdefault(s.parent, []).append(s.name)
    epochs = []
    for it, under in w.iterations:
        epoch = next(s for s in under if s.name == "epoch")
        epochs.append(epoch)
        loop = ["epoch", "runner.snapshot"]
        if it.attrs["epoch"] > 1:
            loop += ["runner.readback", "runner.process"]
        assert kids[it.id] == loop
        process = [s for s in under if s.name == "runner.process"]
        if process:
            readback = next(s for s in under if s.name == "runner.readback")
            assert readback.attrs == {"read": it.attrs["epoch"] - 1}
            assert kids[process[0].id][:1] == ["runner.summary"]
            assert "runner.checkpoint" in kids[process[0].id]  # save_frequency 1: "last"
        inner = ["epoch.draws", "epoch.launch.rollout", "epoch.launch.gae",
                 "epoch.launch.update", "epoch.metrics"]
        if not graphed:
            inner = inner[1:]
        elif it.attrs["epoch"] == 1:
            inner = ["epoch.setup"] + inner
        assert kids[epoch.id] == inner
        steps = (2 + r._train_iter.ac_steps + r._train_iter.cv_steps) if graphed else 0
        assert epoch.attrs["replays"] == steps
        assert epoch.attrs["launches"] == 0  # no kernel runs off the card
        m = epoch.marks_ms
        assert m is not None and list(m) == ["start", "rollout", "gae", "update"]
        assert 0 <= m["start"] <= m["rollout"] <= m["gae"] <= m["update"]
        assert m["update"] - m["start"] <= epoch.wall_ms  # host-clock readings inside it
    assert epochs[0].marks_ms["update"] <= epochs[1].marks_ms["start"]
    assert capture.replay_count - replays == sum(e.attrs["replays"] for e in epochs)
    names = [s.name for s in w.spans if s.parent == w.call.id]
    assert names.count("runner.readback") == 1  # the drain's, after the loop
    assert names[-1] == "runner.checkpoint"  # "final"


def test_epoch_span_counts_the_kernel_launches(tmp_path):
    """The ``epoch`` span's ``launches`` is the change of
    ``cuda_engine.launch_count`` over the epoch function: here a stand-in
    that adds what the graphed D1 epoch's rollout replay adds on the card
    (32 steps of a physics and a fingertip launch) before the real body."""
    r = _runner(tmp_path)
    r.reset()
    body = r._train_iter

    def launching(*args):
        cuda_engine.launch_count += 64
        return body(*args)

    r._train_iter = launching
    before = trace.records()[-1].id if trace.records() else 0
    r.train(max_epochs=2)
    epochs = [s for s in trace.records() if s.id > before and s.name == "epoch"]
    assert [s.attrs["launches"] for s in epochs] == [64, 64]


@pytest.mark.parametrize("profiling", [False, True])
def test_ranges_open_only_under_a_profiler(tmp_path, monkeypatch, profiling):
    """Without a profiler no ``record_function`` is entered; under one each
    span of an iteration is a range of its name in the trace, its start
    within 200 us of the range's."""
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    t = trace.Tracer()
    t.sync_clock()
    if not profiling:
        with t.iteration(1), t.span("epoch"), t.span("epoch.launch.rollout"):
            torch.ones(4).sum()
        assert entered == [] and len(t.records()) == 3
        return
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for epoch in (0, 1, 2):  # the profiler's first range costs more: epoch 0's
            with t.iteration(epoch), t.span("epoch"), t.span("epoch.launch.rollout"):
                torch.ones(4).sum()
    assert entered == ["runner.iteration", "epoch", "epoch.launch.rollout"] * 3
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    ranges = sorted((e for e in doc["traceEvents"] if e.get("cat") == "user_annotation"),
                    key=lambda e: e["ts"])[3:]
    spans = [s for s in t.records() if s.epoch in (1, 2)]
    assert [e["name"] for e in ranges] == [s.name for s in spans]
    for e, s in zip(ranges, spans):
        assert abs(s.start_ns - (base + e["ts"] * 1e3)) < 200e3, (s.name, s.start_ns, e)


def test_a_collection_inside_a_span_is_a_host_gc_child():
    t = trace.Tracer()
    with t.gc_spans(), t.span("runner.process") as outer:
        gc.collect(2)
    gc.collect(2)  # after the context: no span
    spans = [s for s in t.records() if s.name == "host.gc"]
    assert len(spans) == 1 and spans[0].parent == outer.id
    assert spans[0].attrs == {"generation": 2} and spans[0].thread == outer.thread
    assert t._on_gc not in gc.callbacks

