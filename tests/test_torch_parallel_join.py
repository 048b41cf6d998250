"""A process group whose rank 0 is the calling process
(``parallel/launch.py`` ``join``), and what the tracer records of a rank
(``utils/trace.py``, ``learning/runner.py``), on the CPU: gloo ranks, a
file rendezvous in a fresh temporary directory.

Every ``join`` makes this process rank 0 at once, while its children are
fresh interpreters that import torch before they join: rank 0's rendezvous
waits out their whole start-up, which a loaded host stretches from seconds
to minutes (``launch``'s ranks all start cold together and wait only for
each other). So each ``join`` keeps the launcher's default bound, 600 s,
and a timed check starts once the group is up.

- ``join`` returns every child's result while the caller takes part as
  rank 0, and leaves the group on exit; a child that fails, or dies while
  rank 0 waits in a collective with it, ends the launch with an error and
  no child left running.
- ``Runner.train`` at 2 ranks x 16 envs with rl_games' per-process
  minibatch (16 rows a rank, so a global minibatch of 32): the layout stays
  time-sliced (one time row a minibatch step), the ``epoch`` span's
  ``collectives`` is the change of ``DataShard.counts`` over each epoch,
  eagerly and as ``GraphedEpoch``'s bodies (one all-reduce per minibatch
  step, two for the advantages, one for the metrics, no all-gather), every
  span carries its process's rank, and the ranks' learners (parameters,
  Adam states, lr) are bitwise equal. Against one process at 32 envs with a
  minibatch of 32, whose spans have no ``collectives`` and rank 0, the
  learner agrees at rtol 1e-5 and atol 1e-5, as in
  ``test_torch_parallel.py``: the ranks' matmuls run on 16 rows where the
  one process runs on 32, so they round differently, and Adam moves an
  element by about ``lr`` whatever its gradient, so a gradient near its
  rounding level moves the two runs apart by a share of ``lr``.
"""

import time

import pytest
import torch
import torch.distributed as dist

import torch_parallel_workers as workers
from leibnizgym_tpu_torch.parallel.launch import join

torch.set_num_threads(1)
TESTS = workers.__file__.rsplit("/", 1)[0]
PER_RANK, WORLD, EPOCHS = 16, 2, 3


def test_join_returns_every_rank_result():
    with join("torch_parallel_workers:rank_value", 3, dict(x=2.0),
              pythonpath=[TESTS]) as ranks:
        assert dist.is_initialized() and dist.get_rank() == 0
        mine = workers.rank_value(2.0)
        others = ranks.results()
    assert not dist.is_initialized()
    assert [mine] + others == [{"rank": r, "world": 3, "sum": 12.0} for r in range(3)]


def test_join_kills_the_children_when_one_fails():
    with pytest.raises(RuntimeError, match="rank 2 exited") as err:
        with join("torch_parallel_workers:fail_on_rank", 4, dict(rank=2),
                  pythonpath=[TESTS]) as ranks:
            procs = ranks.job.procs
            ranks.results()
    assert "fails on purpose" in str(err.value)
    assert all(p.poll() is not None for p in procs)
    assert not dist.is_initialized()


def test_join_ends_a_collective_whose_peer_died():
    """The collective fails within a minute of the group being up, long
    before its 600 s timeout, which ``grace`` outlasts."""
    t0 = None
    with pytest.raises(RuntimeError):
        with join("torch_parallel_workers:fail_on_rank", 2, dict(rank=1), pythonpath=[TESTS],
                  grace=900) as ranks:
            procs = ranks.job.procs
            t0 = time.perf_counter()
            dist.all_reduce(torch.ones(1))
    assert t0 is not None and time.perf_counter() - t0 < 60
    assert all(p.poll() is not None for p in procs)
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {"one": workers.per_process_runner(WORLD * PER_RANK, EPOCHS,
                                             str(tmp_path_factory.mktemp("one")), False)}
    for graphed in (False, True):
        logdir = str(tmp_path_factory.mktemp("ranks"))
        kwargs = dict(num_envs=PER_RANK, epochs=EPOCHS, logdir=logdir, graphed=graphed)
        with join("torch_parallel_workers:per_process_runner", WORLD, kwargs,
                  pythonpath=[TESTS]) as ranks:
            mine = workers.per_process_runner(**kwargs)
            out[graphed] = [mine] + ranks.results()
    return out


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graph_bodies"])
def test_epoch_span_counts_the_collectives_each_rank_issued(runs, graphed):
    steps = 2 * 4 + 2 * 4  # 2 mini-epochs of 4 time rows, actor and central value
    for rank, out in enumerate(runs[graphed]):
        assert out["rank"] == rank
        assert len(out["span_collectives"]) == EPOCHS
        assert out["span_collectives"] == out["issued"]
        assert all(c == {"all_reduce": steps + 2 + 1} for c in out["issued"]), out["issued"]
        assert out["span_ranks"] == [rank]
    assert runs["one"]["span_collectives"] == [None] * EPOCHS
    assert runs["one"]["span_ranks"] == [0]


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graph_bodies"])
def test_per_process_minibatch_stays_time_sliced_and_matches_one_process(runs, graphed):
    one, ranks = runs["one"], runs[graphed]
    for out in ranks + [one]:
        assert out["layout"] == [[4, 1, True], [4, 1, True]]  # 4 steps of one time row
    for other in ranks[1:]:
        assert len(other["learner"]) == len(ranks[0]["learner"])
        assert all(torch.equal(a, b) for a, b in zip(ranks[0]["learner"], other["learner"]))
    for a, b in zip(ranks[0]["learner"], one["learner"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
