"""The port's multi-process entry points on the CPU, each in gloo
processes with ``OMP_NUM_THREADS=1`` and a file rendezvous (or a free port)
of its own:

- checkpoints: a 2-rank ``Runner`` (one rank of a process group found at
  construction) trains 2 epochs; a 1-rank ``Runner`` restores its ``final``
  bit-identically, and each rank restores a 1-rank run's checkpoint
  bit-identically (the learner is replicated);
- the training CLI with ``args.multihost=True`` and the explicit
  coordinator arguments, 2 ranks, 2 epochs: rank 0 alone writes the log
  directory and the checkpoint, which holds 2 epochs over all 8 envs;
- ``scripts/multihost_demo.py`` as 2 processes: the same ``loss ... kl ...``
  line on both (``tests/test_multihost.py``'s check), and within float
  rounding of the demo as 1 process with the same 16 envs;
- the dry run (``graft_entry.dryrun_multichip(2, "cpu")``): the env step, the
  training step and the flagship recipe with ``frames=2`` on both ranks;
- ``scripts/scaling_bench.py --device cpu`` at device counts 1 and 2;
- ``tools/dp_cards.py`` as 2 gloo ranks against one.
"""

import copy
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from leibnizgym_tpu_torch.learning.runner import Runner
from leibnizgym_tpu_torch.parallel.launch import launch
from leibnizgym_tpu_torch.scripts import multihost_demo, scaling_bench
import torch_parallel_workers as workers

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
TIMEOUT = 120


def _child_env(**extra):
    return dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", **extra)


def _equal(a, b, where=""):
    if torch.is_tensor(a):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}/{k}")
    else:
        assert a == b, where


def test_checkpoints_restore_across_world_sizes(tmp_path):
    cfg = workers.d1_config(8, {})
    single = Runner(copy.deepcopy(cfg["gym"]), cfg["rlg"]["params"], logdir=str(tmp_path / "one"),
                    seed=3, device="cpu")
    assert single.shard is None
    single.train(max_epochs=1)
    one_path = single.save("final")
    out = launch("torch_parallel_workers:runner_train_restore", 2,
                 dict(num_envs=8, epochs=2, logdir=str(tmp_path / "two"), restore=one_path),
                 pythonpath=[TESTS], timeout=TIMEOUT)
    _equal(out[0]["trained"], out[1]["trained"], "ranks")
    assert out[0]["trained"]["epoch"] == 2 and out[1]["final"] is None
    (stamp,) = os.listdir(tmp_path / "two")  # rank 0 alone writes
    fresh = Runner(copy.deepcopy(cfg["gym"]), cfg["rlg"]["params"], logdir=str(tmp_path / "one"),
                   seed=5, device="cpu")
    fresh.restore(out[0]["final"])
    _equal(workers.learner_payload(fresh), out[0]["trained"], "W=2 -> W=1")
    for r in out:
        _equal(r["restored"], workers.learner_payload(single), "W=1 -> W=2")


def test_cli_multihost_two_ranks(tmp_path):
    argv = ["gym=trifinger_difficulty_1", "args.num_envs=8", "args.device=cpu",
            "gym.sim.substeps=2", "rlg.params.config.steps_num=4",
            "rlg.params.config.mini_epochs=2", "args.max_epochs=2", f"args.logdir={tmp_path}",
            "args.multihost=True", f"args.coordinator_address=file://{tmp_path}/rendezvous",
            "args.num_processes=2"]
    procs = [subprocess.Popen([sys.executable, "-m", "leibnizgym_tpu_torch.scripts.train", *argv,
                               f"args.process_id={rank}"], cwd=ROOT, env=_child_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs[0][-3000:] + outs[1][-3000:]
    assert "over 2 ranks (gloo), 4 on each" in outs[0]
    (stamp,) = [d for d in os.listdir(tmp_path) if d != "rendezvous"]
    ckpt = torch.load(tmp_path / stamp / "nn" / "final", weights_only=True)
    assert ckpt["epoch"] == 2 and ckpt["frame"] == 2 * 4 * 8
    assert ckpt["ac_opt_state"]["count"] == 2 * 2 * 4


def test_multihost_demo_two_processes(tmp_path, monkeypatch):
    env = _child_env(COORD_ADDR=f"file://{tmp_path}/rendezvous", ENVS_PER_DEVICE="8")
    procs = [subprocess.Popen([sys.executable, "-m", "leibnizgym_tpu_torch.scripts.multihost_demo",
                               str(rank), "2", "--device", "cpu"], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    lines = [re.search(r"loss ([-\d.]+) kl ([-\d.]+)", out) for out in outs]
    assert all(lines), outs
    assert lines[0].groups() == lines[1].groups()  # a replicated learner
    monkeypatch.setenv("ENVS_PER_DEVICE", "16")
    alone = multihost_demo.main(["0", "1", "--device", "cpu"])
    np.testing.assert_allclose(float(lines[0].group(1)), alone["loss"], rtol=1e-4)


def test_dryrun_two_processes(capsys):
    from leibnizgym_tpu_torch.graft_entry import dryrun_multichip

    out = dryrun_multichip(2, "cpu")
    printed = capsys.readouterr().out
    assert printed.count("[dryrun] sharded FLAGSHIP train step (cone+DR+frames=2) OK") == 2
    for r in out:
        assert r["obs_shape"] == [4, 41] and r["obs_finite"]
        assert r["flagship_obs_width"] == 2 * 89  # two stacked keypoint observations
        assert np.isfinite(r["loss"]) and np.isfinite(r["flagship_loss"])
    assert out[0] == out[1]


def test_scaling_bench_cpu(capsys):
    rows = scaling_bench.main(["--device", "cpu", "--envs-per-device", "4", "--steps", "2",
                               "--device-counts", "1", "2"])
    assert [r["devices"] for r in rows] == [1, 2] and rows[0]["scaling_eff"] == 100.0
    assert all(r["rollout_sps"] > 0 for r in rows)
    printed = capsys.readouterr().out
    assert "devices=2: rollout" in printed and "scaling eff" in printed


def test_dp_cards_tool_cpu():
    """``tools/dp_cards.py`` (W ranks against one, strong and weak) as 2 gloo
    processes on the CPU: every rank's learner is the same, and at these
    sizes (2 steps of one substep, too short for contacts to amplify the
    rounding) the 2-rank epochs learn as the 1-rank ones to rtol 1e-4; on
    the CPU no epoch is graphed and no graphed-against-eager pair runs."""
    sys.path.insert(0, ROOT)
    from tools import dp_cards

    out = dp_cards.main(["--device", "cpu", "--world", "2", "--num-envs", "4", "--horizon", "2",
                         "--substeps", "1", "--epochs", "2"])
    assert out["world"] == 2 and out["learners_replicated"]
    assert out["strong_free_run_max_rel_diff"] < 1e-4
    assert out["weak_env_steps_per_s"] > 0 and out["one_rank_env_steps_per_s"] > 0
    assert not any(out["graphed_epochs"]) and out["graphed_equals_eager_bitwise"] is None
    assert "eager" not in out
