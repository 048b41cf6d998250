"""The port's runner (``learning/runner.py``): twins of tests/test_runner.py's
train-loop tests on a stubbed Runner (no env, no PPO), plus checkpoints on
a real 8-env Runner on the CPU.

The stub's ``_train_iter`` changes the train state in place, as the port's
``train_iteration`` does, and ``_ckpt_payload`` reports the state's epoch;
so a save that took the pipeline head instead of the processed epoch's
snapshot shows up as the wrong epoch.
"""

import collections
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from leibnizgym_tpu_torch.config.presets import GYM_PRESETS, default_config, parse_cli, update_cfg
from leibnizgym_tpu_torch.learning import ppo as tppo
from leibnizgym_tpu_torch.learning.runner import AverageMeter, Runner, fetch_metrics

torch.set_num_threads(1)


class TestAverageMeter:
    def test_window(self):
        m = AverageMeter(maxlen=3)
        assert m.get_mean() == 0.0 and m.current_size == 0
        m.update([1.0, 2.0, 3.0, 4.0])  # the window keeps the last 3
        assert m.current_size == 3 and np.isclose(m.get_mean(), 3.0)

    def test_scalar_update(self):
        m = AverageMeter()
        m.update(5.0)
        assert m.get_mean() == 5.0


def test_fetch_metrics():
    m = {"a": torch.tensor(1.5), "b": torch.tensor(3, dtype=torch.int32),
         "v": torch.arange(4.0), "f": 2.0}
    out = fetch_metrics(m)
    assert out["a"] == 1.5 and out["b"] == 3 and out["f"] == 2.0
    np.testing.assert_array_equal(out["v"], np.arange(4.0))


# ---------------------------------------------------------------------------
# Train loop on a stub
# ---------------------------------------------------------------------------


class _StubTS:
    def __init__(self, epoch):
        self.epoch = epoch
        self.frame = epoch * 100


class _StubStatic:
    num_envs = 8


@dataclasses.dataclass
class _StubParams:
    """EnvParams stand-in for the curriculum controller."""

    curriculum_level: float = 0.0

    def with_curriculum_level(self, level):
        return dataclasses.replace(self, curriculum_level=level)


def _metrics(epoch, kl=0.01, ep_return=None, cur=None):
    m = {
        "info/frames": np.float32(epoch * 100),
        "info/kl": np.float32(kl),
        "info/lr": np.float32(3e-4),
        "episodes/finished_returns": np.zeros(8, np.float32),
        "episodes/finished_n": np.zeros(8, np.int32),
    }
    if ep_return is not None:
        m["episodes/finished_returns"] = np.full(8, ep_return, np.float32)
        m["episodes/finished_n"] = np.ones(8, np.int32)
    if cur is not None:
        m["episodes/finished_count"] = np.float32(8.0)
        m["episodes/finished_success_sum"] = np.float32(8.0 * cur)
        m["env/strict_success_frac"] = np.float32(0.5)
        m["env/curriculum_level"] = np.float32(0.0)
    return m


def _stub_runner(tmp_path, cfg, metrics_for_epoch, cur_gated=False):
    """A Runner skeleton with only what ``train`` touches; ``_train_iter``
    and ``save`` stubbed."""
    r = Runner.__new__(Runner)
    r.verbose = False
    r.ppo_cfg = cfg
    r.static = _StubStatic()
    r.env_params = _StubParams()
    r.logdir = str(tmp_path)
    r.nn_dir = os.path.join(str(tmp_path), "nn")
    r.writer = None
    r.game_rewards = AverageMeter(cfg.games_to_track)
    r.ts = _StubTS(0)
    r._cur_gated = cur_gated
    if cur_gated:
        r._cur_level = 0.0
        r._cur_up_thresh, r._cur_down_thresh = 0.5, 0.1
        r._cur_up_step, r._cur_down_step = 0.1, 0.2
        r._suc_win = collections.deque(maxlen=2)
        r._strict_win = collections.deque(maxlen=64)
        r._best_cur_score = float("inf")  # no best_curriculum saves
        r._last_cur_save = 0.0
    calls = {"iters": 0, "saves": []}

    def train_iter(cfg_, static_, params_, ts):
        calls["iters"] += 1
        ts.epoch = calls["iters"]  # in place, like ppo.train_iteration
        return metrics_for_epoch(calls["iters"])

    r._train_iter = train_iter
    r._ckpt_payload = lambda clone=False: {"epoch": r.ts.epoch}
    r.save = lambda name, payload=None: calls["saves"].append(
        (name, (payload if payload is not None else r._ckpt_payload())["epoch"]))
    return r, calls


def _loop_cfg(**kw):
    base = dict(host_pipeline_depth=4, save_best_after=1, save_frequency=0,
                score_to_win=1e9, games_to_track=100, horizon=32, max_epochs=100000)
    base.update(kw)
    return dataclasses.replace(tppo.PPOConfig(), **base)


class TestTrainLoopPipelining:
    def test_best_save_holds_the_epoch_that_earned_it(self, tmp_path):
        """At depth 4, 'best' checkpoints the snapshot of the epoch whose
        metrics triggered it, not the state 3 epochs ahead."""
        r, calls = _stub_runner(tmp_path, _loop_cfg(), lambda e: _metrics(e, ep_return=float(e)))
        r.train(max_epochs=10)
        assert [e for name, e in calls["saves"] if name == "best"] == list(range(1, 11))
        assert calls["iters"] == 10

    def test_depth_one_saves_the_current_state(self, tmp_path):
        cfg = _loop_cfg(host_pipeline_depth=1)
        r, calls = _stub_runner(tmp_path, cfg, lambda e: _metrics(e, ep_return=float(e)))
        r.train(max_epochs=5)
        assert [e for name, e in calls["saves"] if name == "best"] == [1, 2, 3, 4, 5]

    def test_drain_processes_every_epoch_once(self, tmp_path):
        r, calls = _stub_runner(tmp_path, _loop_cfg(save_frequency=1), lambda e: _metrics(e))
        r.train(max_epochs=6)
        assert [e for name, e in calls["saves"] if name == "last"] == [1, 2, 3, 4, 5, 6]
        assert calls["saves"][-1] == ("final", 6)

    def test_max_epochs_is_cumulative_across_resume(self, tmp_path):
        """A resume restores ts.epoch; the loop trains the remaining budget,
        and a spent budget trains nothing and keeps the final checkpoint."""
        r, calls = _stub_runner(tmp_path, _loop_cfg(), lambda e: _metrics(e))
        r.ts = _StubTS(7)
        r.train(max_epochs=10)
        assert calls["iters"] == 3
        r2, calls2 = _stub_runner(tmp_path, _loop_cfg(), lambda e: _metrics(e))
        r2.ts = _StubTS(10)
        r2.train(max_epochs=10)
        assert calls2["iters"] == 0 and calls2["saves"] == []

    def test_watchdog_tightens_on_resumed_run(self, tmp_path):
        r, _ = _stub_runner(tmp_path, _loop_cfg(), lambda e: _metrics(e))
        r.ts = _StubTS(7)
        r.train(max_epochs=10, watchdog_timeout=10.0)
        assert r._watchdog_timeout == 10.0  # not stuck at the first-epoch floor
        assert r._watchdog_armed is False

    def test_watchdog_rearm_after_first_epoch(self, tmp_path):
        """Armed loose for the first epoch, tightened to the caller's timeout
        once it completes, disarmed when train() returns."""
        r, _ = _stub_runner(tmp_path, _loop_cfg(), lambda e: _metrics(e))
        r.train(max_epochs=3, watchdog_timeout=10.0)
        assert r._watchdog_timeout == 10.0
        assert r._watchdog_armed is False

    def test_nan_halt_saves_first_bad_epoch_and_stops(self, tmp_path):
        cfg = _loop_cfg()
        bad = 5
        r, calls = _stub_runner(
            tmp_path, cfg, lambda e: _metrics(e, kl=float("nan") if e >= bad else 0.01))
        r.train(max_epochs=20)
        assert [e for name, e in calls["saves"] if name == "nan_halt"] == [bad]
        assert calls["iters"] <= bad + cfg.host_pipeline_depth - 1

    def test_score_to_win_early_stop(self, tmp_path):
        r, calls = _stub_runner(tmp_path, _loop_cfg(score_to_win=50.0),
                                lambda e: _metrics(e, ep_return=float(e * 10)))
        r.train(max_epochs=100)
        assert calls["iters"] < 20


class TestCurriculumController:
    def _run(self, tmp_path, spes):
        """Drive the success-gated controller with a scripted
        successes-per-episode sequence; return the level trajectory."""
        levels = []
        r, _ = _stub_runner(tmp_path, _loop_cfg(),
                            lambda e: _metrics(e, cur=spes[min(e - 1, len(spes) - 1)]),
                            cur_gated=True)

        def record(level):
            Runner._set_curriculum_level(r, level)
            levels.append(r._cur_level)

        r._set_curriculum_level = record
        r.train(max_epochs=len(spes))
        return r, levels

    def test_level_advances_on_sustained_success(self, tmp_path):
        _, levels = self._run(tmp_path, [2.0] * 10)
        assert levels and levels[-1] > 0.5
        assert all(b >= a for a, b in zip(levels, levels[1:]))

    def test_level_retreats_on_collapse(self, tmp_path):
        _, levels = self._run(tmp_path, [2.0] * 6 + [0.0] * 6)
        assert max(levels) > 0.3 and levels[-1] < max(levels)

    def test_device_params_track_level(self, tmp_path):
        r, _ = self._run(tmp_path, [2.0] * 8)
        assert abs(float(r.env_params.curriculum_level) - r._cur_level) < 1e-6


# ---------------------------------------------------------------------------
# A real Runner on the CPU
# ---------------------------------------------------------------------------


def _real_runner(tmp_path, vanilla=False, gym=None, gym_changes=None, **rlg):
    cfg = parse_cli((["rlg=vanilla"] if vanilla else []) + ([f"gym={gym}"] if gym else []))
    cfg["args"].update(num_envs=8, seed=0)
    cfg = update_cfg(cfg)
    cfg["gym"]["sim"]["substeps"] = 1
    cfg["gym"]["sim"]["physx"]["num_position_iterations"] = 2
    cfg["gym"].update(gym_changes or {})
    cfg["rlg"]["params"]["config"].update(steps_num=2, mini_epochs=1, **rlg)
    if not vanilla:
        cfg["rlg"]["params"]["config"]["central_value_config"]["mini_epochs"] = 1
    return Runner(cfg["gym"], cfg["rlg"]["params"], logdir=str(tmp_path), seed=0, device="cpu")


def _learner_tensors(r):
    ts = r.ts
    out = {f"ac.{k}": v for k, v in ts.actor_critic.state_dict().items()}
    out.update({f"cv.{k}": v for k, v in ts.central_value.state_dict().items()})
    for tag, opt in (("ac_opt", ts.ac_opt), ("cv_opt", ts.cv_opt)):
        out.update({f"{tag}.mu.{n}": m for n, m in zip(opt.names, opt.mu)})
        out.update({f"{tag}.nu.{n}": m for n, m in zip(opt.names, opt.nu)})
    out["lr"] = ts.lr
    return {k: v.detach().clone() for k, v in out.items()}


def test_checkpoint_round_trip(tmp_path):
    """``final`` of a 2-epoch run restores bit-identically into a fresh
    Runner (both networks, both Adam states, lr, epoch, frame); a snapshot
    taken by the pipeline is a copy, untouched by later epochs."""
    r = _real_runner(tmp_path, host_pipeline_depth=2)
    r.reset()
    start = _learner_tensors(r)
    snapshot = r._ckpt_payload(clone=True)
    r.train(max_epochs=2)
    trained = _learner_tensors(r)
    assert any(not torch.equal(start[k], trained[k]) for k in start)  # it learned
    for k, v in snapshot["ac_state_dict"].items():
        assert torch.equal(v, start[f"ac.{k}"]), k
    final = os.path.join(r.nn_dir, "final")
    assert os.path.exists(final)

    fresh = _real_runner(tmp_path / "fresh")
    fresh.restore(final)
    restored = _learner_tensors(fresh)
    assert restored.keys() == trained.keys()
    for k in trained:
        assert torch.equal(restored[k], trained[k]), k
    assert (fresh.ts.epoch, fresh.ts.frame) == (2, 2 * 2 * 8)
    assert fresh.ts.ac_opt.count == r.ts.ac_opt.count > 0
    # and the restored learner trains on
    fresh.train(max_epochs=3)
    assert fresh.ts.epoch == 3


def test_restore_falls_back_to_weights_on_mismatch(tmp_path, capsys):
    """A checkpoint whose optimizer state does not match (here: missing, as
    in a weights-only file) restores the weights, lr, epoch and frame, warns,
    and starts fresh optimizers."""
    r = _real_runner(tmp_path)
    r.reset()
    r.train(max_epochs=1)
    payload = torch.load(os.path.join(r.nn_dir, "final"), weights_only=True)
    del payload["ac_opt_state"]
    path = os.path.join(str(tmp_path), "weights_only")
    torch.save(payload, path)

    fresh = _real_runner(tmp_path / "fresh")
    fresh.restore(path)
    assert "does not match" in capsys.readouterr().out
    for k, v in r.ts.actor_critic.state_dict().items():
        assert torch.equal(fresh.ts.actor_critic.state_dict()[k], v), k
    assert fresh.ts.ac_opt.count == 0 and fresh.ts.cv_opt.count == 0
    assert fresh.ts.epoch == 1 and float(fresh.ts.lr) == float(r.ts.lr)

    # a file whose weights do not fit is an error, not a silent restart
    payload["ac_state_dict"]["mu.weight"] = torch.zeros(3, 3)
    torch.save(payload, path)
    with pytest.raises(RuntimeError):
        fresh.restore(path)


def test_play_runs_the_policy(tmp_path):
    r = _real_runner(tmp_path, frames=2)
    r.reset()
    policy = r.make_policy()
    obs = torch.zeros(8, 41 * 2)
    assert policy(obs).shape == (8, 9)
    t0 = time.time()
    assert np.isfinite(r.play(num_steps=3, deterministic=False))
    assert time.time() - t0 < 60


def test_vanilla_runner_trains_and_restores(tmp_path):
    """The symmetric config: no central value, the actor-critic's own critic
    gives the values; checkpoints carry None for the central value's parts."""
    r = _real_runner(tmp_path, vanilla=True)
    r.train(max_epochs=1)
    assert r.ts.central_value is None and r.ts.cv_opt is None and r.ts.ac_opt.count > 0
    fresh = _real_runner(tmp_path / "fresh", vanilla=True)
    fresh.restore(os.path.join(r.nn_dir, "final"))
    for k, v in r.ts.actor_critic.state_dict().items():
        assert torch.equal(fresh.ts.actor_critic.state_dict()[k], v), k
    assert fresh.ts.ac_opt.count == r.ts.ac_opt.count


D4_GATED = "trifinger_difficulty_4_curriculum"


def test_curriculum_level_reaches_the_real_env(tmp_path):
    """On a success-gated preset, a level change reaches the env's params as
    a device tensor, and ``make_policy`` sets the play env to level 1.0. (The
    port's EnvParams once lacked ``curriculum_level``, so both raised
    TypeError from dataclasses.replace.)"""
    r = _real_runner(tmp_path, gym=D4_GATED)
    r.reset()
    r._set_curriculum_level(0.3)
    level = r.env_params.curriculum_level
    assert torch.is_tensor(level) and level.dtype == torch.float32 and level.dim() == 0
    assert abs(float(level) - 0.3) < 1e-7 and r._cur_level == 0.3
    policy = r.make_policy()
    assert float(r.env.params.curriculum_level) == 1.0
    obs = r.wrap_env().reset()
    assert obs.shape == (8, 89) and policy(obs).shape == (8, 9)
    policy = r.make_policy(curriculum_level=0.5)
    assert float(r.env.params.curriculum_level) == 0.5


def test_curriculum_controller_on_the_real_env(tmp_path):
    """The success-gated controller on the D4 env: with a threshold every
    episode passes, the level rises by ``up_step`` per finished episode and
    reaches the env's info; ``best_curriculum`` is saved with the level, and
    a fresh Runner restores it into its env params."""
    changes = {"episode_length": 4, "goal_curriculum": dict(
        GYM_PRESETS[D4_GATED]["goal_curriculum"], up_threshold=-1.0, up_step=0.25,
        window_samples=1)}
    r = _real_runner(tmp_path, gym=D4_GATED, gym_changes=changes, host_pipeline_depth=1)
    seen = []
    inner = r._train_iter

    def train_iter(cfg, static, env_params, ts):
        metrics = inner(cfg, static, env_params, ts)
        seen.append((float(env_params.curriculum_level), float(metrics["env/curriculum_level"])))
        return metrics

    r._train_iter = train_iter
    r.train(max_epochs=6)
    # 2-step epochs, 4-step episodes: an episode sample every second epoch
    assert r._cur_level == 0.75
    assert all(a == b for a, b in seen)  # the env read the level it was given
    assert [a for a, _ in seen] == [0.0, 0.0, 0.25, 0.25, 0.5, 0.5]
    best = os.path.join(r.nn_dir, "best_curriculum")
    assert os.path.exists(best)
    saved = torch.load(best, weights_only=True)["curriculum_level"]
    assert 0.0 <= saved <= 0.75
    assert torch.load(os.path.join(r.nn_dir, "final"), weights_only=True)["curriculum_level"] == 0.75

    fresh = _real_runner(tmp_path / "fresh", gym=D4_GATED, gym_changes=changes)
    fresh.restore(os.path.join(r.nn_dir, "final"))
    assert fresh._cur_level == 0.75 and float(fresh.env_params.curriculum_level) == 0.75


_STALL = r'''
import sys, time
sys.path.insert(0, "tests")
import test_torch_runner as t

r, _ = t._stub_runner(sys.argv[1], t._loop_cfg(host_pipeline_depth=1), lambda e: t._metrics(e))
inner = r._train_iter

def stall(*args):
    if r.ts.epoch >= 1:  # the second epoch hangs, as on a wedged device
        time.sleep(60)
    return inner(*args)

r._train_iter = stall
r.train(max_epochs=3, watchdog_timeout=1.0)
print("not reached")
'''


def test_watchdog_exits_42_on_a_stall(tmp_path):
    """After the first epoch the watchdog's timeout drops from the
    first-epoch floor to the caller's; a stalled epoch then ends the process
    with exit code 42 for a supervisor to restart."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _STALL, str(tmp_path)], cwd=root,
                          env=dict(os.environ, PYTHONPATH=root), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 42, proc.stderr[-2000:]
    assert "WATCHDOG" in proc.stdout and "not reached" not in proc.stdout
