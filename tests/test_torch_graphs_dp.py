"""The port's compiled paths under a data-parallel shard and for play
(``learning/graphs.py``: ``GraphedEpoch`` with a ``DataShard`` and with
``nan_telemetry``, ``GraphedPolicy``; ``ops/capture.py``'s
``CountedGraph`` counting the collectives a graph captured and its
``Captured`` cycle of warm-up, capture and replay, with stand-ins for the
CUDA calls).

On the CPU nothing is captured. Two gloo ranks, spawned by
``parallel.launch`` once for the module (``torch_parallel_workers.
graph_bodies``), run the epoch's graph bodies under ``CaptureGuard`` (no
host data, no read back to the host, no random draw inside a body) on the
D1 config at 8 envs, in both minibatch layouts and with ``nan_telemetry``,
over 3 epochs: the first from the generator, the others from injected
global draws, epoch 1's checkpoint restored in place before the third. On
each rank every metric (every ``nan/*`` key included) and every learner and
carry tensor must be bitwise equal to ``ppo.train_iteration``'s under the
same shard, and each epoch must issue the eager path's collectives. The
play policy's graph body, deterministic and with noise (the global block's
rows), is held bitwise to the eager policy on both ranks and alone.

The graph bodies against the JAX package's ``train_iteration`` on a
2-device mesh are in ``tests/test_torch_parallel.py``; the single-process
``nan_telemetry`` epoch in ``tests/test_torch_graphs.py``; captures on the
card in ``tests/test_torch_cuda_graphs.py``.
"""

import collections
import contextlib
import gc

import pytest
import torch

import torch_parallel_workers as workers
from leibnizgym_tpu_torch.learning import ppo as tppo
from leibnizgym_tpu_torch.learning.graphs import GraphedEpoch, GraphedPolicy, epoch_for
from leibnizgym_tpu_torch.ops import capture, cuda_engine
from leibnizgym_tpu_torch.parallel.launch import launch
from test_torch_runner import _real_runner

torch.set_num_threads(1)
TESTS = workers.__file__.rsplit("/", 1)[0]
N, WORLD = 8, 2
NAN_KEYS = 22  # ppo.nan_metrics


@pytest.fixture(scope="module")
def ranks():
    return launch("torch_parallel_workers:graph_bodies", WORLD, dict(num_envs=N),
                  pythonpath=[TESTS], timeout=300)


@pytest.mark.parametrize("case", list(workers.GRAPH_CASES))
def test_sharded_graph_bodies_match_train_iteration(case, ranks):
    for r, out in enumerate(ranks):
        rows = out[case]["epochs"]
        assert len(rows) == 3
        for e, row in enumerate(rows, 1):
            assert not row["metrics_unequal"], (r, e, row["metrics_unequal"])
            assert not row["state_unequal"], (r, e, row["state_unequal"])
            assert len(row["nan_keys"]) == (NAN_KEYS if case == "nan_telemetry" else 0)
        # epoch 1's steps, then epoch 1's restored count and the third's
        steps = out[case]["ac_steps"]
        assert [row["ac_count"] for row in rows] == [steps, 2 * steps, 2 * steps]


@pytest.mark.parametrize("case", list(workers.GRAPH_CASES))
def test_sharded_graph_bodies_issue_the_eager_collectives(case, ranks):
    """Epoch by epoch the eager path's collectives: one all-reduce per
    minibatch step, two for the advantages, one for the metrics (two with
    ``nan_telemetry``: its maxima), and the trajectory's all-gather in the
    global-shuffle layout."""
    for out in ranks:
        steps = out[case]["ac_steps"] + out[case]["cv_steps"]
        want = {"all_reduce": steps + 3 + (case == "nan_telemetry")}
        if case == "global_shuffle":
            want["all_gather"] = 1
        for row in out[case]["epochs"]:
            assert row["counts_graphed"] == row["counts_eager"] == want, row


@pytest.mark.parametrize("mode", ["deterministic", "stochastic"])
def test_sharded_policy_graph_body_matches_eager(mode, ranks):
    for out in ranks:
        assert out["policy"][mode] == [True, True, True]


@pytest.mark.parametrize("deterministic", [True, False])
def test_policy_graph_body_matches_eager(deterministic, tmp_path):
    """``Runner.make_policy``'s policy is the graphed one; its body under
    ``CaptureGuard`` gives the eager policy's actions bitwise over calls
    whose obs change (some beyond the obs clip), the noise drawn from the
    caller's generator in the eager order."""
    r = _real_runner(tmp_path)
    r.reset()
    r.train(max_epochs=1)
    assert isinstance(r.make_policy(deterministic), GraphedPolicy)
    cfg, ac = r.ppo_cfg, r.ts.actor_critic
    policy = workers.GuardedPolicy(cfg, ac, N, deterministic)
    g_eager, g_graph = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    obs = r.ts.carry.obs
    for t, x in enumerate((obs, 3.0 * obs, -obs)):
        want = workers.eager_policy(cfg, ac, x, deterministic, N, None, g_eager)
        got = policy(x, g_graph)
        assert got.shape == (N, r.static.action_dim)
        assert torch.equal(want, got), t
    assert torch.equal(g_eager.get_state(), g_graph.get_state())


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: replay does
    nothing."""

    def replay(self):
        pass


def test_counted_graph_adds_captured_collectives_on_replay(monkeypatch):
    """A capture counts nothing, in ``launch_count`` and in the counter
    given; each replay adds what the capture counted, to that counter
    only. Python's cyclic garbage collector is off inside the capture (a
    dead cycle holding another graph, collected there, would destroy it
    mid-capture, which invalidated a capture on the card) and on again
    after it. The capture runs in ``thread_local`` error mode."""
    modes = []
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, pool=None, capture_error_mode="global":
                        modes.append(capture_error_mode) or contextlib.nullcontext())
    monkeypatch.setattr(cuda_engine, "launch_count", 7)
    counts = collections.Counter(all_reduce=3, broadcast=1)
    other = collections.Counter(all_reduce=5)
    graph = capture.CountedGraph(counts)
    assert gc.isenabled()
    with graph.capture():
        assert not gc.isenabled()
        cuda_engine.launch_count += 32
        counts["all_reduce"] += 2
        counts["all_gather"] += 1
        other["all_reduce"] += 1  # not a counter of this graph
    assert gc.isenabled() and modes == ["thread_local"]
    assert cuda_engine.launch_count == 7 and graph.launches == 32
    assert counts == collections.Counter(all_reduce=3, broadcast=1)
    for k in range(1, 4):
        graph.replay()
        assert cuda_engine.launch_count == 7 + 32 * k
        assert counts == collections.Counter(all_reduce=3 + 2 * k, broadcast=1, all_gather=k)
    assert other == collections.Counter(all_reduce=6)


class _FakeStream:
    """Stands in for a ``torch.cuda.Stream`` on the CPU: notes its joins."""

    def __init__(self, name, events):
        self.name, self.events = name, events

    def wait_stream(self, other):
        self.events.append(f"{self.name} waits {other.name}")


def test_captured_warms_up_captures_and_replays_per_key(monkeypatch):
    """``capture.Captured``: the first call for a key runs the body on a side
    stream joined to the current one both ways, returns that result and
    captures the body on clones of the inputs; a call with the same bound
    object and input layout copies its inputs in and replays without
    running the body, counted in ``replay_count``, and returns copies of the
    captured outputs; a new bound object or another input layout (a shape,
    a None become a tensor) captures again."""
    events = []

    @contextlib.contextmanager
    def phase(name, *args, **kwargs):
        events.append(name)
        yield
        events.append("/" + name)

    main = _FakeStream("main", events)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda *a, **k: phase("capture"))
    monkeypatch.setattr(torch.cuda, "device", lambda device: phase("device"))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: main)
    monkeypatch.setattr(torch.cuda, "Stream", lambda: _FakeStream("side", events))
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: phase(stream.name))

    def body(x, extra):
        events.append("body")
        return x + 1.0, {"twice": 2.0 * x if extra is None else extra * x}

    bound = [object()]
    graphed = capture.Captured(body, "cpu", lambda: (bound[0],))
    cycle = ["device", "side waits main", "side", "body", "/side", "main waits side",
             "capture", "body", "/capture", "/device"]
    x0 = torch.arange(4.0)
    out = graphed(x0, None)
    assert events == cycle
    assert torch.equal(out[0], x0 + 1.0) and torch.equal(out[1]["twice"], 2.0 * x0)
    assert graphed.inputs[0] is not x0 and torch.equal(graphed.inputs[0], x0)
    captured = graphed.outputs
    for t in range(1, 4):
        events.clear()
        replays = capture.replay_count
        x = torch.arange(4.0) * (t + 2)
        out = graphed(x, None)
        assert events == [] and capture.replay_count == replays + 1, t
        assert torch.equal(graphed.inputs[0], x) and graphed.inputs[1] is None, t
        assert graphed.outputs is captured, t
        for got, kept in ((out[0], captured[0]), (out[1]["twice"], captured[1]["twice"])):
            assert torch.equal(got, kept) and got.data_ptr() != kept.data_ptr(), t
    for call in (lambda: graphed(torch.arange(6.0), None),
                 lambda: graphed(torch.arange(6.0), torch.ones(6)),
                 lambda: bound.__setitem__(0, object()) or graphed(torch.arange(6.0),
                                                                  torch.ones(6))):
        events.clear()
        replays = capture.replay_count
        out = call()
        assert events == cycle and capture.replay_count == replays
        assert graphed.outputs is not captured
        captured = graphed.outputs
    assert torch.equal(out[1]["twice"], torch.arange(6.0))


@pytest.mark.parametrize("backend, device, graphed", [
    (None, "cuda", True), ("nccl", "cuda", True), ("gloo", "cuda", False),
    (None, "cpu", False), ("gloo", "cpu", False)])
def test_epoch_for_graphs_what_a_card_can_capture(backend, device, graphed, capsys):
    """``epoch_for`` (the Runner's, the dry run's, the demo's and the
    scaling bench's choice): the graphed epoch on a card without a group and
    under NCCL; ``train_iteration`` on the CPU and under gloo on a card,
    which says why."""
    shard = None if backend is None else type("Shard", (), {"backend": backend})()
    epoch = epoch_for(torch.device(device), shard, "test: ")
    assert isinstance(epoch, GraphedEpoch) == graphed
    assert graphed or epoch is tppo.train_iteration
    said = capsys.readouterr().out
    assert ("gloo runs its collectives on the host" in said) == (backend == "gloo"
                                                                and device == "cuda")


def test_shutdown_collects_before_leaving_the_group(monkeypatch):
    """``shutdown_distributed`` (the launcher's, the demo's and the training
    CLI's way out of a group) runs the cyclic collector before it destroys
    the group: NCCL waits for the CUDA graphs that hold its communicator,
    and a Runner with its graphed epoch is a reference cycle."""
    from leibnizgym_tpu_torch.parallel import mesh

    calls = []
    monkeypatch.setattr(mesh.gc, "collect", lambda: calls.append("collect"))
    monkeypatch.setattr(mesh.dist, "destroy_process_group", lambda: calls.append("destroy"))
    mesh.shutdown_distributed()
    assert calls == ["collect", "destroy"]
