"""Port parity: NaN telemetry (``learning/ppo.py`` ``nan_metrics``, the
runner's NaN-halt dump, ``scripts/nan_replay.py`` and
``scripts/nan_microscope.py``).

- Every ``nan/*`` metric against the reference's ``train_iteration`` with
  ``nan_telemetry`` on the replayed trajectory of ``test_torch_ppo_update.py``
  (its stub env state given a float field, so ``envstate_fin`` has a tensor
  to read), clean and with NaNs put into the trajectory (one env's
  observation at one step, one env's state field at the last step). Flags
  and ``kl_first_bad`` are equal; the magnitudes agree to float32 rounding of
  matmuls and reductions in another order (rtol 1e-5; the gradient norms,
  sums of squares over every parameter after a backward pass, 1e-4); NaN
  magnitudes are NaN on both sides.
- The twin of ``tests/test_runner.py::test_nan_telemetry_dumps_pre_nan_state``
  on a real 8-env Runner: telemetry forces depth 1, and ``nan_prev_ts.pt``
  holds the state of the epoch before the first bad one.
- ``nan_replay`` then ``nan_microscope`` with ``--device cpu`` on an 8-env D1
  run into which one degenerate env (a reference env state, converted with
  ``convert.env_state_from_jax``, whose cube moves at 1e30 m/s) was put
  before epoch 3: the replay names step 0 and that env, and the microscope's
  first non-finite substep equals the one the reference's walk
  (``engine_v2._substep_scalar`` one substep at a time, as
  ``scripts/nan_microscope.py:95-123`` drives it) gives on the same state
  and torque.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

from leibnizgym_tpu.envs.trifinger import env as jenv
from leibnizgym_tpu.learning import ppo as jppo
from leibnizgym_tpu.ops import engine_v2 as jengine
from leibnizgym_tpu_torch.config.presets import parse_cli, update_cfg
from leibnizgym_tpu_torch.convert import env_state_from_jax, train_state_from_jax
from leibnizgym_tpu_torch.learning import ppo as tppo
from leibnizgym_tpu_torch.learning.runner import Runner
from leibnizgym_tpu_torch.scripts import nan_microscope, nan_replay
from test_torch_ppo_update import (
    CASES, OBS, STATES, ACT, UNITS, Static, _jax_train_state, _recorded, port_config,
    reference_draws,
)

torch.set_num_threads(1)

FLAGS = ("nan/obs_fin", "nan/states_fin", "nan/act_fin", "nan/rew_fin", "nan/val_fin",
         "nan/envstate_fin", "nan/adv_fin", "nan/grad_fin", "nan/kl_mb_fin",
         "nan/kl_first_bad", "nan/params_fin")


@struct.dataclass
class JaxStubState:
    t: jax.Array
    reset_buf: jax.Array
    successes: jax.Array
    pos: jax.Array


@dataclasses.dataclass
class TorchStubState:
    t: int
    reset_buf: torch.Tensor
    successes: torch.Tensor
    pos: torch.Tensor


def _jax_stub(tab):
    tab = {k: jnp.asarray(v) for k, v in tab.items()}

    def env_step(static, params, state, action):
        t = state.t
        new = JaxStubState(t=t + 1, reset_buf=tab["reset"][t], successes=tab["successes"][t],
                           pos=tab["pos"][t])
        return new, tab["obs"][t], tab["states"][t], tab["reward"][t], tab["done"][t], {}

    return env_step


def _torch_stub(tab):
    tab = {k: torch.as_tensor(v) for k, v in tab.items()}

    def env_step(static, params, state, action, draws):
        t = state.t
        new = TorchStubState(t + 1, tab["reset"][t], tab["successes"][t], tab["pos"][t])
        return new, tab["obs"][t], tab["states"][t], tab["reward"][t], tab["done"][t], {}

    return env_step


@pytest.mark.parametrize("poison", [False, True], ids=["clean", "nan_in_trajectory"])
def test_nan_metrics_match_reference(poison, monkeypatch):
    n, h = 64, 8
    static = Static(n, OBS, STATES, ACT, True)
    jcfg = jppo.PPOConfig(horizon=h, mini_epochs=2, cv_mini_epochs=3, units=UNITS,
                          fused_rollout=False, nan_telemetry=True, **CASES["time_sliced_cv"])
    tcfg = port_config(jcfg)
    assert tcfg.nan_telemetry
    table = _recorded(n, h, STATES, seed=11)
    table["pos"] = np.random.default_rng(3).normal(size=(h, n, 3)).astype(np.float32)
    if poison:
        table["obs"][3, 5] = np.nan  # the policy's input of step 4 in env 5
        table["pos"][h - 1, 7, 1] = np.nan  # the env state the epoch ends on

    jts = _jax_train_state(jcfg, static, table, seed=5)
    jts = jts.replace(env_state=JaxStubState(
        t=jnp.zeros((), jnp.int32), reset_buf=jnp.zeros(n, bool), successes=jnp.zeros(n, jnp.int32),
        pos=jnp.zeros((n, 3))))
    monkeypatch.setattr(jppo, "env_step", _jax_stub(table))
    _, jm = jax.jit(lambda ts: jppo.train_iteration(jcfg, static, None, ts))(jts)
    jts, jm = jax.device_get((jts, jm))

    noise, perms = reference_draws(tcfg, jts.key, n, h, True)
    tts = train_state_from_jax(jts, tcfg, static, env_state=TorchStubState(
        0, torch.zeros(n, dtype=torch.bool), torch.zeros(n, dtype=torch.int32),
        torch.zeros(n, 3)))
    monkeypatch.setattr(tppo, "env_step", _torch_stub(table))
    tm = tppo.train_iteration(tcfg, static, None, tts, noise=noise, env_draws=[None] * h,
                              perms=perms)

    keys = sorted(k for k in jm if k.startswith("nan/"))
    assert keys == sorted(k for k in tm if k.startswith("nan/")) and len(keys) == 22
    for k in keys:
        v = tm[k]
        assert torch.is_tensor(v) and v.dim() == 0, k  # no read-back in the epoch
        if k in FLAGS:
            assert float(v) == float(jm[k]), (k, float(v), float(jm[k]))
        else:
            np.testing.assert_allclose(float(v), float(jm[k]), err_msg=k,
                                       rtol=1e-4 if k == "nan/grad_max" else 1e-5)
    flags = {k: float(tm[k]) for k in FLAGS}
    if poison:
        # the NaN reaches the actions, then the first update that samples
        # step 4, whose gradients and KL are the first bad ones
        bad = {k: 0.0 for k in FLAGS if k not in ("nan/states_fin", "nan/rew_fin",
                                                   "nan/val_fin", "nan/adv_fin",
                                                   "nan/kl_first_bad")}
        assert {k: flags[k] for k in bad} == bad
        num_mb, width, _ = tppo.minibatch_layout(True, h, n, tcfg.minibatch_size)
        rows = torch.cat([p.reshape(num_mb, width) for p in perms[:tcfg.mini_epochs]])
        first = int(torch.nonzero((rows == 4).any(1))[0])
        assert flags["nan/kl_first_bad"] == first
    else:
        assert all(v == 1.0 for k, v in flags.items() if k.endswith("_fin"))
        assert flags["nan/kl_first_bad"] == -1.0


def _runner(logdir, **agent):
    cfg = parse_cli([])  # D1, asymmetric
    cfg["args"].update(num_envs=8, seed=0)
    cfg = update_cfg(cfg)
    cfg["gym"]["sim"]["substeps"] = 2
    cfg["gym"]["sim"]["physx"]["num_position_iterations"] = 2
    cfg["rlg"]["params"]["config"].update(steps_num=4, mini_epochs=1, nan_telemetry=True,
                                          host_pipeline_depth=4, **agent)
    cfg["rlg"]["params"]["config"]["central_value_config"]["mini_epochs"] = 1
    return cfg, Runner(cfg["gym"], cfg["rlg"]["params"], logdir=str(logdir), seed=0,
                       device="cpu")


def test_nan_telemetry_dumps_pre_nan_state(tmp_path, capsys):
    """Depth 1 whatever host_pipeline_depth says, the halt at the first
    non-finite KL, and nan_prev_ts.pt = the state before that epoch: both
    learners, the carry and the generator, loadable weights-only."""
    _, r = _runner(tmp_path)
    inner, calls, after = r._train_iter, [], {}

    def train_iter(cfg, static, env_params, ts):
        metrics = inner(cfg, static, env_params, ts)
        calls.append(ts.epoch)
        if ts.epoch == 2:
            after.update(ac={k: v.clone() for k, v in ts.actor_critic.state_dict().items()},
                         obs=ts.carry.obs.clone(), gen=ts.generator.get_state(),
                         q=ts.carry.env_state.physics.q.clone(), lr=ts.lr.clone())
        if ts.epoch == 3:
            metrics["info/kl"] = torch.tensor(float("nan"))
        return metrics

    r._train_iter = train_iter
    r.train(max_epochs=10)
    assert calls == [1, 2, 3]  # depth 4 would have run ahead of the halt
    assert "non-finite kl at epoch 3" in capsys.readouterr().out
    dump = torch.load(os.path.join(r.logdir, "nan_prev_ts.pt"), weights_only=True)
    assert dump["epoch"] == 2 and dump["frame"] == 2 * 4 * 8
    for k, v in after["ac"].items():
        assert torch.equal(dump["ac_state_dict"][k], v), k
    assert torch.equal(dump["carry"]["obs"], after["obs"])
    assert torch.equal(dump["carry"]["env_state"]["physics_q"], after["q"])
    assert torch.equal(dump["generator_state"], after["gen"])
    # 2 epochs x 1 mini-epoch x 4 minibatches (4 rows of 8 envs, minibatch 8)
    assert torch.equal(dump["lr"], after["lr"]) and dump["ac_opt_state"]["count"] == 2 * 4
    assert torch.load(os.path.join(r.nn_dir, "nan_halt"), weights_only=True)["epoch"] == 3


NAN_ENV, LINVEL = 3, 1e30


def _reference_first_bad(jstate, e, torque, static):
    """The reference's substep walk (scripts/nan_microscope.py:95-123) on env
    ``e`` of a JAX env state under ``torque``."""
    cfg = static.solver
    phys = jax.tree.map(lambda x: x[e], jstate.physics)
    scene = jax.tree.map(lambda x: x[e], jstate.scene)
    h = static.dt / cfg.substeps
    sub = jax.jit(lambda p, t: jengine._substep_scalar(p, t, scene, cfg, h))
    for i in range(cfg.substeps * static.control_decimation):
        phys, _, _ = sub(phys, jnp.asarray(torque))
        if not all(bool(jnp.isfinite(getattr(phys, f)).all()) for f in nan_microscope.FIELDS):
            return i
    return None


def test_replay_and_microscope_find_the_injected_env(tmp_path, capsys):
    cfg, r = _runner(tmp_path / "run")
    # the degenerate state, made by the reference env and converted
    je = jenv.TrifingerEnv(config=dict(cfg["gym"], engine="soa"), verbose=False)
    jstate, _ = jax.jit(jenv.env_reset, static_argnums=0)(je.static, je.params,
                                                          jax.random.PRNGKey(4))
    jstate = jstate.replace(physics=jstate.physics.replace(
        cube_linvel=jstate.physics.cube_linvel.at[NAN_ENV].set(LINVEL)))
    jstate = jax.device_get(jstate)
    inner = r._train_iter

    def train_iter(cfg_, static, env_params, ts):
        metrics = inner(cfg_, static, env_params, ts)
        if ts.epoch == 2:
            ts.carry.env_state = env_state_from_jax(jstate)
        return metrics

    r._train_iter = train_iter
    r.train(max_epochs=5)
    assert r.ts.epoch == 3
    npz = str(tmp_path / "micro.npz")
    assert nan_replay.main([r.logdir, "--steps", "4", "--out", npz, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"step 0: 1 envs non-finite (+1 bad rewards); first bad env = {NAN_ENV}" in out
    d = np.load(npz)
    assert int(d["step"]) == 0 and int(d["env_index"]) == NAN_ENV
    np.testing.assert_array_equal(d["pre_physics_cube_linvel"], np.float32(LINVEL))
    assert not np.isfinite(d["post_physics_cube_pos"]).all()

    seen = nan_microscope.microscope(npz, r.logdir, "cpu")
    assert seen is not None and "physics_cube_pos" in seen["nonfinite"]
    ref = _reference_first_bad(jstate, NAN_ENV, d["post_applied_torque"], je.static)
    assert ref is not None and seen["first_bad_substep"] == {"plain": ref}
    assert nan_microscope.main([npz, r.logdir, "--device", "cpu"]) == 0
    assert f"first non-finite substep: plain={ref}" in capsys.readouterr().out
