"""The CUDA kernel on the card (marker ``cuda``; skips without a GPU).

Imports no JAX, so it runs on a machine that has none. tests/conftest.py
imports JAX, so on such a machine run it without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

- ``step_packed_cuda`` against the plain version on the same card, ragged
  N = 1000, TGS and PGS, within chip_smoke.py's tolerances (nvcc contracts
  a*b+c into FMAs, the kernel sums each row in its own order and the device
  sin/cos differ from PyTorch's by an ulp, which the contact solve
  amplifies, most in the cube's angular velocity); more ragged N (37, 4097,
  1000 with another seed), every env resident at once at 8192 envs;
- each launch adds one to ``launch_count``, and a CUDA tensor never reaches
  the plain version;
- the wrapper refuses a wrong dtype, shape, layout or device;
- a state whose solve overflows (one env's cube at 1e30 m/s) goes
  non-finite in the same rows and envs of the kernel's output and impulses
  as of the plain version's (the kernel's max / min propagate NaN);
- one learner step (actor-critic and central value) on the card against the
  same step on the CPU, as chip_smoke.py phase 5 holds it;
- the fingertip kernel (``fingertip_state_cuda``) against
  ``fingertip_components_v2`` in float32 at 8192 envs and a ragged N, within
  TIP_TOL; one fingertip launch per eager env step beside the physics
  kernel's and the tail kernel's, the plain version never on CUDA tensors,
  one fingertip launch in a captured env step; its wrapper refuses a wrong
  dtype, shape, layout or device;
- the tail kernel (``_step_tail_cuda``, ``mdp_tail_cuda``) against the
  env's plain tail (``_step_tail_plain``) on the same card at 8192 envs on
  D1, D4 + DR and the branch-covering spec sets of
  ``torch_tail_cases.py`` within TAIL_CARD_TOL: obs, states, reward, the
  goal pose and history slots, the flags and counters exactly, every info
  key with its dtype; a reset's tail alike; a graphed D4 + DR env step and
  an eager one bitwise equal; its wrapper refuses a wrong dtype, shape,
  layout or device and a missing input.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from leibnizgym_tpu_torch.envs.trifinger import env as tenv
from leibnizgym_tpu_torch.models import trifinger as tf_model
from leibnizgym_tpu_torch.ops import cuda_engine
from leibnizgym_tpu_torch.ops import engine_v2
from leibnizgym_tpu_torch.ops.types import PhysicsState, SceneParams, SolverConfig
from torch_tail_cases import TAIL_CASES, step_inputs, tail_env, with_schedules

pytestmark = pytest.mark.cuda

N = 1000
# |kernel - plain| <= atol + rtol * |plain|, as in chip_smoke.py
TOL = {"q": (1e-4, 0.0), "qd": (1e-3, 1e-3), "cube_pos": (1e-4, 0.0),
       "cube_quat": (1e-4, 0.0), "cube_linvel": (1e-3, 1e-3),
       "cube_angvel": (5e-3, 5e-3)}
ROWS = {"q": (0, 9), "qd": (9, 18), "cube_pos": (18, 21), "cube_quat": (21, 25),
        "cube_linvel": (25, 28), "cube_angvel": (28, 31)}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_engine.build()
    return torch.device("cuda", 0)


def _inputs(dev, seed=0, n=N):
    rng = np.random.default_rng(seed)
    quat = rng.normal(size=(n, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    cols = [np.tile(tf_model.JOINT_POS_DEFAULT, 3) + rng.uniform(-0.4, 0.4, (n, 9)),
            rng.uniform(-2.0, 2.0, (n, 9)),
            np.stack([rng.uniform(-0.12, 0.12, n), rng.uniform(-0.12, 0.12, n),
                      rng.uniform(0.02, 0.08, n)], -1),
            quat, rng.uniform(-0.5, 0.5, (n, 3)), rng.uniform(-3.0, 3.0, (n, 3))]
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    state = PhysicsState(*(t(c) for c in cols))
    tau = t(rng.uniform(-0.36, 0.36, (n, 9)))
    return state, tau, SceneParams.default(device=dev).broadcast(n)


def _check_against_plain(dev, cfg, n, seed=0):
    state, tau, scene = _inputs(dev, seed, n)
    s31 = engine_v2.pack_state(state)
    p40 = engine_v2.pack_params(scene, n)
    t9 = tau.T.contiguous()
    out, imp = cuda_engine.step_packed_cuda(s31, p40, t9, cfg, 0.02)
    ref, ref_imp = engine_v2.step_packed(s31, p40, t9, cfg, 0.02)
    torch.cuda.synchronize()
    for name, (a, b) in ROWS.items():
        atol, rtol = TOL[name]
        err = (out[a:b] - ref[a:b]).abs()
        assert bool((err <= atol + rtol * ref[a:b].abs()).all()), (name, float(err.max()))
    assert bool(((imp - ref_imp).abs() <= 1e-4 + 1e-4 * ref_imp.abs()).all())


@pytest.mark.parametrize("solver_type", [0, 1])
def test_kernel_matches_plain_on_card(dev, solver_type):
    _check_against_plain(dev, SolverConfig(solver_type=solver_type, substeps=4,
                                           solver_iterations=8), N)


@pytest.mark.parametrize("n", [37, 4097, 1000])
def test_kernel_matches_plain_at_ragged_n(dev, n):
    """N that the block's 32 envs do not divide: the last block's spare
    lanes compute on a copy of the last env, reach every barrier and store
    nothing."""
    _check_against_plain(dev, SolverConfig(solver_type=1, substeps=4, solver_iterations=8),
                         n, seed=n)


@pytest.mark.parametrize("solver_type", [0, 1])
def test_kernel_propagates_nan_as_plain_on_card(dev, solver_type):
    n, bad_env = 64, 5
    cfg = SolverConfig(solver_type=solver_type, substeps=4, solver_iterations=8)
    state, tau, scene = _inputs(dev, 3, n)
    state.cube_linvel[bad_env] = 1e30
    s31, p40, t9 = engine_v2.pack_state(state), engine_v2.pack_params(scene, n), tau.T.contiguous()
    out, imp = cuda_engine.step_packed_cuda(s31, p40, t9, cfg, 0.02)
    ref, ref_imp = engine_v2.step_packed(s31, p40, t9, cfg, 0.02)
    torch.cuda.synchronize()
    bad = ~torch.isfinite(ref)
    assert bool(bad[:, bad_env].all()) and int(bad.any(0).sum()) == 1
    assert torch.equal(~torch.isfinite(out), bad)
    assert torch.equal(~torch.isfinite(imp), ~torch.isfinite(ref_imp))


def test_every_env_resident_at_once(dev):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    occ = cuda_engine.occupancy()
    assert occ["blocks_per_sm"] * sms * occ["envs_per_block"] >= 8192, occ


def test_cuda_tensors_never_take_the_plain_version(dev, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(cuda_engine, "physics_step_plain", refuse)
    monkeypatch.setattr(engine_v2, "step_packed", refuse)
    state, tau, scene = _inputs(dev, seed=1)
    before = cuda_engine.launch_count
    new, wrench = cuda_engine.physics_step_cuda(state, tau, scene, SolverConfig(), 0.02)
    torch.cuda.synchronize()
    assert cuda_engine.launch_count == before + 1
    assert new.q.is_cuda and wrench.shape == (N, 3, 6)
    assert bool(torch.isfinite(wrench).all())


def test_wrapper_refuses_bad_inputs(dev):
    state, tau, scene = _inputs(dev, seed=2)
    s31 = engine_v2.pack_state(state)
    p40 = engine_v2.pack_params(scene, N)
    t9 = tau.T.contiguous()
    cfg = SolverConfig()
    before = cuda_engine.launch_count
    with pytest.raises(TypeError):
        cuda_engine.step_packed_cuda(s31.double(), p40, t9, cfg, 0.02)
    with pytest.raises(ValueError):
        cuda_engine.step_packed_cuda(s31[:, :-1], p40, t9, cfg, 0.02)
    with pytest.raises(ValueError):
        cuda_engine.step_packed_cuda(s31, p40, tau.T, cfg, 0.02)
    with pytest.raises(ValueError):
        cuda_engine.step_packed_cuda(s31, p40.cpu(), t9, cfg, 0.02)
    assert cuda_engine.launch_count == before


def test_learner_step_on_card_matches_cpu(dev):
    """One actor-critic and one central-value step at the D1 widths on the
    card against the CPU, TF32 off, within chip_smoke.py's stated bounds
    (losses and KL rtol 1e-4; parameters max 2 lr + 1e-6 and >= 99.9% within
    1e-6; the same next lr)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    rel, worst, within, lr_same, ok = chip_smoke.learner_card_vs_cpu(dev)
    assert ok, (rel, worst, within, lr_same)


# Fingertip kernel against the plain version, both float32 on the card,
# |kernel - plain| <= atol + rtol * |plain|: the same formulas in the same
# order, but nvcc contracts a*b+c into FMAs and the device sinf/cosf differ
# from PyTorch's by an ulp. Each output is a sum of a few dozen products of
# O(1) terms (positions ~0.3 m, velocities a few m/s and rad/s at these
# joint speeds) with no solve to amplify the rounding, so the two differ by
# a few ulps of 1: at most 9.5e-7 (an angular velocity; positions 1.2e-7,
# quaternions 1.8e-7) over ten seeds of 8192 envs on an H100, both spreads
# below, and 1.9e-6 on a D1 state after a rollout (faster joints), where the
# relative term covers it. The seeded states lie off the
# boundaries of the Shepperd selection, where a rounding could make the two
# pick candidates of opposite sign (the same orientation).
TIP_TOL = (2e-6, 2e-6)


def _tip_inputs(dev, n, spread, seed):
    rng = np.random.default_rng(seed)
    if spread == "env":  # around the default pose, as the env's states lie
        q = np.tile(tf_model.JOINT_POS_DEFAULT, 3) + rng.uniform(-0.4, 0.4, (n, 9))
    else:  # a full turn of every joint: every branch of the selection
        q = rng.uniform(-np.pi, np.pi, (n, 9))
    qd = rng.uniform(-3.0, 3.0, (n, 9))
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    return t(q), t(qd)


@pytest.mark.parametrize("n,spread", [(8192, "env"), (8192, "full_turn"), (1000, "full_turn")])
def test_fingertip_kernel_matches_plain_on_card(dev, n, spread):
    """All 39 components; 1000 envs leave the last 64-env block ragged."""
    q, qd = _tip_inputs(dev, n, spread, seed=n)
    out = cuda_engine.fingertip_state_cuda(q.T.contiguous(), qd.T.contiguous())
    plain = engine_v2.fingertip_components_v2(tuple(q[:, i] for i in range(9)),
                                              tuple(qd[:, i] for i in range(9)))
    ref = torch.stack([c for finger in plain for part in finger for c in part])
    torch.cuda.synchronize()
    atol, rtol = TIP_TOL
    err = (out - ref).abs()
    assert out.shape == ref.shape == (cuda_engine.TIP_ROWS, n)
    assert bool((err <= atol + rtol * ref.abs()).all()), float(err.max())


def test_env_step_launches_one_fingertip_kernel(dev, monkeypatch):
    """An eager env step adds three launches (the physics kernel's, the
    fingertip kernel's, one call of its wrapper, and the tail kernel's) and
    never runs the plain fingertip version; the captured env step holds all
    three, one each, and a replay adds them without calling the wrapper."""
    def refuse(*args, **kwargs):
        raise AssertionError("the plain fingertip version ran on CUDA tensors")

    calls = []
    launch = cuda_engine.fingertip_state_cuda

    def counted(*args):
        calls.append(args[0].shape)
        return launch(*args)

    monkeypatch.setattr(engine_v2, "fingertip_components_v2", refuse)
    monkeypatch.setattr(cuda_engine, "fingertip_state_cuda", counted)
    n = 64
    env = tenv.TrifingerEnv(config={"num_instances": n, "command_mode": "torque",
                                    "asymmetric_obs": True}, device=dev, verbose=False)
    st = env.static
    gen = torch.Generator(device=dev).manual_seed(0)
    state, _ = tenv.env_reset(st, env.params, *tenv.draw_init_randoms(st, gen, n, dev))
    for t in range(3):
        action = torch.rand((n, st.action_dim), generator=gen, device=dev) * 2.0 - 1.0
        before, seen = cuda_engine.launch_count, len(calls)
        state = tenv.env_step(st, env.params, state, action,
                              tenv.draw_step_randoms(st, gen, n, dev))[0]
        assert cuda_engine.launch_count - before == 3 and len(calls) - seen == 1, t
    env.reset(tenv.draw_init_randoms(st, gen, n, dev))
    for t in range(3):  # warm-up and capture, then replays
        action = torch.rand((n, st.action_dim), generator=gen, device=dev) * 2.0 - 1.0
        before, seen = cuda_engine.launch_count, len(calls)
        env.step(action, tenv.draw_step_randoms(st, gen, n, dev))
        assert cuda_engine.launch_count - before == 3, t
        assert len(calls) - seen == (2 if t == 0 else 0), t
    torch.cuda.synchronize()
    assert env._graphs["step"].graph.launches == 3
    assert calls == [(9, n)] * len(calls)


def test_fingertip_wrapper_refuses_bad_inputs(dev):
    q = torch.zeros((9, 64), device=dev)
    qd = torch.zeros((9, 64), device=dev)
    before = cuda_engine.launch_count
    with pytest.raises(TypeError):
        cuda_engine.fingertip_state_cuda(q.double(), qd)
    with pytest.raises(ValueError):
        cuda_engine.fingertip_state_cuda(q[:8], qd)
    with pytest.raises(ValueError):
        cuda_engine.fingertip_state_cuda(q, qd[:, :-1])
    with pytest.raises(ValueError):
        cuda_engine.fingertip_state_cuda(torch.zeros((64, 9), device=dev).T, qd)
    with pytest.raises(ValueError):
        cuda_engine.fingertip_state_cuda(q, qd.cpu())
    assert cuda_engine.launch_count == before


# The tail kernel against the plain tail, both float32 on the card,
# |kernel - plain| <= atol + rtol * max |plain| of the quantity: the same
# formulas in the same order, each product that meets a sum rounded on its
# own as PyTorch's separate kernels round it (nvcc would contract the two
# into an FMA), and a division by a Python float taken as PyTorch's CUDA
# kernel takes it, a product with the reciprocal. So the per-env values
# agree to the bit on these cases; the bound holds the info means, whose
# reductions sum in another order, and an ulp of exp, asin or pow, which
# asin near 1 turns into ~1e-4 rad.
TAIL_CARD_TOL = (1e-5, 1e-5)
TAIL_CARD_CASES = ["d1", "d4_dr", "d4_rotating", "branches_p1_inside", "branches_p3_inside",
                   "branches_p1_before", "branches_p3_after"]


def _tail_case(dev, case, n=8192):
    """(static, params, head) of ``case`` at ``n`` envs on the card."""
    preset, changes, level, branches, _ = TAIL_CASES[case]
    env = tail_env(preset, changes, level, n, dev)
    state, action, draws = step_inputs(env, seed=sum(map(ord, case)))
    st = env.static
    if branches is not None:
        st = with_schedules(st, int(state.frames), *branches)
    return st, env.params, tenv._step_head(st, env.params, state, action, draws)


def _within(got, ref, what):
    atol, rtol = TAIL_CARD_TOL
    assert got.shape == ref.shape and got.dtype == ref.dtype, what
    if ref.numel():
        err = float((got.double() - ref.double()).abs().max())
        assert err <= atol + rtol * float(ref.double().abs().max()), (what, err)
        return err
    return 0.0


@pytest.mark.parametrize("case", TAIL_CARD_CASES)
def test_tail_kernel_matches_plain_on_card(dev, case):
    st, params, head = _tail_case(dev, case)
    before = cuda_engine.launch_count
    new, obs, states, reward, dones, info = tenv._step_tail_cuda(st, params, *head)
    assert cuda_engine.launch_count - before == 2  # the fingertip and tail kernels
    ref, ref_obs, ref_states, ref_reward, ref_dones, ref_info = tenv._step_tail_plain(
        st, params, *head)
    torch.cuda.synchronize()
    errs = {name: _within(got, want, name) for name, got, want in (
        ("obs", obs, ref_obs), ("states", states, ref_states), ("reward", reward, ref_reward),
        ("goal_pose", new.goal_pose_cm, ref.goal_pose_cm),
        ("tip_prev", new.tip_pos_prev_cm, ref.tip_pos_prev_cm),
        ("obj_prev", new.obj_posquat_prev_cm, ref.obj_posquat_prev_cm))}
    for name, got, want in (("dones", dones, ref_dones), ("reset_buf", new.reset_buf,
                                                          ref.reset_buf),
                            ("goal_reset_buf", new.goal_reset_buf, ref.goal_reset_buf),
                            ("steps_count", new.steps_count, ref.steps_count),
                            ("successes", new.successes, ref.successes),
                            ("frames", new.frames, ref.frames)):
        assert got.dtype == want.dtype and torch.equal(got, want), (case, name)
    assert list(info) == list(ref_info), case
    for key, want in ref_info.items():
        got = info[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        if want.dtype == torch.int64:
            assert int(got) == int(want), key
        else:
            errs[key] = _within(got, want, key)
    print(f"tail {case} max_abs_err " + " ".join(f"{k}={v:.3e}" for k, v in errs.items()))
    # the step's state: a reset took place and every env stepped
    assert int(new.steps_count[1]) == 1 and bool(new.reset_buf[3])


@pytest.mark.parametrize("case", ["d1", "d4_dr", "branches_p1_inside"])
def test_tail_kernel_reset_matches_plain_on_card(dev, case):
    preset, changes, level, _, _ = TAIL_CASES[case]
    env = tail_env(preset, changes, level, 8192, dev)
    st = env.static
    gen = torch.Generator(device=dev).manual_seed(3)
    u, norm, dr_blocks, noise = tenv.draw_init_randoms(st, gen, st.num_envs, dev)
    state = tenv._reset_head(st, env.params, u, norm, dr_blocks)
    got, obs = tenv._reset_tail_cuda(st, env.params, state, noise)
    ref, ref_obs = tenv._reset_tail_plain(st, env.params, state, noise)
    torch.cuda.synchronize()
    _within(obs, ref_obs, "obs")
    _within(got.tip_pos_prev_cm, ref.tip_pos_prev_cm, "tip_prev")
    _within(got.obj_posquat_prev_cm, ref.obj_posquat_prev_cm, "obj_prev")
    assert torch.equal(got.frames, ref.frames)


def test_tail_graphed_step_matches_eager_bitwise(dev):
    """The D4 + DR env's captured reset and steps against the eager
    functions from the same draws and actions: obs, states, reward, dones,
    every info value and the env state bitwise equal."""
    env = tail_env("trifinger_difficulty_4_curriculum_dr", {}, 0.3, 1024, dev)
    st, n = env.static, env.static.num_envs
    gen = torch.Generator(device=dev).manual_seed(7)
    init = tenv.draw_init_randoms(st, gen, n, dev)
    obs = env.reset(init)
    state, ref_obs = tenv.env_reset(st, env.params, *init)
    assert torch.equal(obs, ref_obs)
    for t in range(6):
        action = torch.rand((n, st.action_dim), generator=gen, device=dev) * 2.0 - 1.0
        draws = tenv.draw_step_randoms(st, gen, n, dev)
        obs, reward, dones, info = env.step(action, draws)
        state, ref_obs, ref_states, ref_reward, ref_dones, ref_info = tenv.env_step(
            st, env.params, state, action, draws)
        assert torch.equal(obs, ref_obs) and torch.equal(env.get_state(), ref_states), t
        assert torch.equal(reward, ref_reward) and torch.equal(dones, ref_dones), t
        assert list(info) == list(ref_info), t
        assert all(torch.equal(info[k], ref_info[k]) for k in info), t
    ours, ref = tenv.env_state_tensors(env.state), tenv.env_state_tensors(state)
    assert all(torch.equal(ours[k], ref[k]) for k in ref)


def test_tail_wrapper_refuses_bad_inputs(dev):
    st, params, head = _tail_case(dev, "d1", n=64)
    state, physics, tau, wrench, action_buf, noise = head
    s31 = engine_v2.packed_view(physics)
    tips = cuda_engine.fingertip_state_cuda(s31[0:9], s31[9:18])
    good = tenv._tail_inputs(params, state, s31, tips, action_buf, noise)
    good.update(torque=tau, wrench=wrench)
    consts = tenv.tail_consts(st)
    before = cuda_engine.launch_count
    for name, bad, error in (("state", s31.double(), TypeError),
                             ("tips", tips[:, :-1], ValueError),
                             ("action", torch.zeros((9, 64), device=dev).T, ValueError),
                             ("reset_buf", state.reset_buf.int(), TypeError),
                             ("torque", tau.cpu(), ValueError),
                             ("wrench", None, ValueError)):
        with pytest.raises(error):
            cuda_engine.mdp_tail_cuda(consts, dict(good, **{name: bad}))
    assert cuda_engine.launch_count == before
    assert s31.data_ptr() == physics.q.data_ptr()  # the physics output, read in place
