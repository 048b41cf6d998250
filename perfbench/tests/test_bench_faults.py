"""A run drives the timed path with a fault planted underneath it, and
``correct`` comes out false: for each fault that the cell can have. The runs
skip the look for a chip (the cells cut to 32 envs on the CPU); the limits
are the cells' own."""

import pytest

from perfbench.drivers import train as driver
from perfbench.tests.small import TRAFFIC, run_small

CELLS = ["d1_asymm_8192", "d4_dr_8192"]


@pytest.fixture
def program():
    from leibnizgym_tpu_torch.envs.trifinger import env
    from leibnizgym_tpu_torch.learning import ppo

    return env, ppo


def _failed(result) -> set:
    return {k for k, c in result["checks"].items() if not c["value"] <= c["limit"]}


@pytest.mark.parametrize("cell", CELLS)
def test_train_state_left_unchanged(monkeypatch, program, cell):
    """The update's optimizer step returns the parameters unchanged."""
    _, ppo = program
    monkeypatch.setattr(ppo.ClippedAdam, "step", lambda self, grads, lr, want_norm=False: None)
    assert not run_small(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_train_state_unchanged_after_early_steps(monkeypatch, program, cell):
    """Each optimizer steps the parameters three times, and from then on
    returns them unchanged: only the parameters' change over an epoch
    shows it."""
    _, ppo = program
    step, calls = ppo.ClippedAdam.step, {}

    def early_only(self, grads, lr, want_norm=False):
        calls[id(self)] = calls.get(id(self), 0) + 1
        return step(self, grads, lr, want_norm) if calls[id(self)] <= 3 else None

    monkeypatch.setattr(ppo.ClippedAdam, "step", early_only)
    result = run_small(cell)
    assert not result["correct"]
    assert "param_change_gap" in _failed(result)


@pytest.mark.parametrize("cell", CELLS)
def test_train_half_batch_left_out(monkeypatch, program, cell):
    """Each minibatch step takes the mean over the first half of its rows."""
    _, ppo = program
    step = ppo.actor_critic_step

    def half(cfg, ac, opt, lr, mb, shard=None):
        return step(cfg, ac, opt, lr, {k: v[:, : v.shape[1] // 2] for k, v in mb.items()}, shard)

    monkeypatch.setattr(ppo, "actor_critic_step", half)
    assert not run_small(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_train_answer_altered(monkeypatch, program, cell):
    """The env step's observations altered where they are produced."""
    env, ppo = program
    step = env.env_step

    def altered(*args, **kwargs):
        state, obs, *rest = step(*args, **kwargs)
        return (state, obs + 1e-2, *rest)

    monkeypatch.setattr(ppo, "env_step", altered)
    assert not run_small(cell)["correct"]


def _window_started(static, state) -> bool:
    """Whether the env step runs in the window (after the set-up's epochs)."""
    steps = (TRAFFIC["check_epochs"] + driver.TIMING_EPOCHS) * 4  # 4 steps an epoch
    return int(state.frames) > steps * static.control_decimation


@pytest.mark.parametrize("cell", CELLS)
def test_window_step_hands_back_its_state(monkeypatch, program, cell):
    """In the window's epochs only, the env step hands back the state it was
    given: the set-up's epochs are sound, the replayed epoch is not."""
    env, ppo = program
    step = env.env_step

    def frozen(static, params, state, action, draws):
        new, *rest = step(static, params, state, action, draws)
        return (state if _window_started(static, state) else new, *rest)

    monkeypatch.setattr(ppo, "env_step", frozen)
    result = run_small(cell)
    assert not result["correct"]
    assert _failed(result) <= {k for k in result["checks"] if k.startswith("replay_")}


@pytest.mark.parametrize("cell", CELLS)
def test_time_out_reset_left_out(monkeypatch, program, cell):
    """An episode that times out is not reset: only the replayed epoch
    holds a time-out."""
    env, ppo = program
    step, reset = env.env_step, env._masked_full_reset
    inside = []

    def in_step(*args, **kwargs):
        inside.append(True)
        try:
            return step(*args, **kwargs)
        finally:
            inside.pop()

    def no_reset(static, params, state, mask, *args, **kwargs):
        return state if inside else reset(static, params, state, mask, *args, **kwargs)

    monkeypatch.setattr(ppo, "env_step", in_step)
    monkeypatch.setattr(env, "_masked_full_reset", no_reset)
    result = run_small(cell)
    assert not result["correct"]
    assert _failed(result) <= {k for k in result["checks"] if k.startswith("replay_")}
