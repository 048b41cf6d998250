"""Port parity: the TriFinger env on the flagship recipe's features (domain
randomization, keypoint observations, goal rotation, observation noise, the
frame-ramp and success-gated curricula).

Each case builds one preset at 8 envs, 2 substeps, 2 solver iterations and
a 15-step episode (so full resets, with their DR redraws, happen inside the
run), resets both envs and steps them 40 times with seeded random actions. The port is fed the
reference's draws, rebuilt from its keys: reset, goal, DR and observation
noise. Both sides run in float64 (see test_torch_env.py for why), and obs,
states, reward, dones, goal poses and every info key are compared at 2e-4 at
every step, after the reset too.

The JAX env runs op by op with its physics step jitted: jitting the whole
env step instead compiles for ~40 s per config on the CPU, while the
physics step, the same in every case, compiles once for the file.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leibnizgym_tpu.config.presets import GYM_PRESETS
from leibnizgym_tpu.envs.trifinger import env as jenv
from leibnizgym_tpu_torch.envs.trifinger import env as tenv
from test_torch_common import max_diff
from test_torch_dr import reference_dr_draws

torch.set_num_threads(1)
N, STEPS, EPISODE, TOL = 8, 40, 15, 2e-4
_JIT_PHYSICS = jax.jit(jenv._batched_physics_step_v2, static_argnums=(3, 4))

# case -> (preset, config changes, curriculum level or None)
CASES = {
    "d4_curriculum_dr": ("trifinger_difficulty_4_curriculum_dr", {}, 0.0),
    "d4_curriculum_rotating": ("trifinger_difficulty_4_curriculum_rotating", {}, 0.0),
    "d3_dr_obs_noise": ("trifinger_difficulty_3_dr", {}, None),
    # frame ramps that pass 1 within the run (40 steps x 8 envs = 320
    # env-steps), and noise mapped to raw units with normalize_obs off
    "d4_frame_ramp": ("trifinger_difficulty_4_curriculum", {
        "goal_curriculum": {"success_gated": False, "anneal_frames": 160.0},
        "termination_conditions": {"success": {"tolerance_anneal_frames": 200.0}},
        "normalize_obs": False, "obs_noise_std": 0.02,
    }, None),
    "d4_gated_level_0.3": ("trifinger_difficulty_4_curriculum_dr", {}, 0.3),
    "d4_gated_level_1.0": ("trifinger_difficulty_4_curriculum_dr", {}, 1.0),
}


def case_config(preset: str, changes: dict) -> dict:
    from leibnizgym_tpu.utils.helpers import update_dict

    cfg = copy.deepcopy(GYM_PRESETS[preset])
    cfg.pop("rlg_overrides", None)
    update_dict(cfg, copy.deepcopy(changes))
    cfg.update(num_instances=N, asymmetric_obs=True, episode_length=EPISODE, seed=0)
    cfg["sim"]["substeps"] = 2
    cfg["sim"]["physx"]["num_position_iterations"] = 2
    return cfg


def _reset_draws(static, key, n):
    """The draws of the reference's ``_masked_full_reset(key)``:
    (u, norm, DR blocks or None)."""
    if static.dr_activate:
        key, k_dr = jax.random.split(key)
    u, norm = jenv._draw_reset_randoms(static, key, n)
    dr_blocks = reference_dr_draws(k_dr, n) if static.dr_activate else None
    return np.array(u), None if norm is None else np.array(norm), dr_blocks


def _noise(static, k_obs, n):
    return np.array(jax.random.normal(k_obs, (n, static.obs_dim)))


def reference_reset_draws(static, key, n):
    """``env_reset(key)``'s draws in ``draw_init_randoms``' layout."""
    key, k_init = jax.random.split(key)
    u, norm, dr_blocks = _reset_draws(static, k_init, n)
    noise = _noise(static, jax.random.split(key)[1], n) if static.obs_noise_std > 0 else None
    return u, norm, dr_blocks, noise


def reference_step_draws(static, key, n):
    """``env_step``'s draws for the state key ``key``, in
    ``draw_step_randoms``' layout."""
    if static.obs_noise_std > 0:
        _, k_reset, k_goal, k_obs = jax.random.split(key, 4)
    else:
        _, k_reset, k_goal = jax.random.split(key, 3)
    u_reset, norm_reset, dr_blocks = _reset_draws(static, k_reset, n)
    u_goal, norm_goal = jenv._draw_reset_randoms(static, k_goal, n)
    noise = _noise(static, k_obs, n) if static.obs_noise_std > 0 else None
    return (u_reset, norm_reset, np.array(u_goal),
            None if norm_goal is None else np.array(norm_goal), dr_blocks, noise)


def _torch(x):
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(_torch(v) for v in x)
    return torch.as_tensor(x)


def _compare_info(jinfo, tinfo, where):
    assert set(jinfo) == set(tinfo), f"{where}: {sorted(set(jinfo) ^ set(tinfo))}"
    for k, v in jinfo.items():
        assert max_diff(v, tinfo[k]) < TOL, f"{where} {k}"


@pytest.mark.parametrize("case", list(CASES))
def test_d4_env_matches_reference(case, monkeypatch):
    preset, changes, level = CASES[case]
    monkeypatch.setattr(jenv, "_batched_physics_step_v2", _JIT_PHYSICS)
    cfg = case_config(preset, changes)
    je = jenv.TrifingerEnv(config=dict(cfg, engine="soa"), verbose=False)
    te = tenv.TrifingerEnv(config=cfg, device="cpu", verbose=False, dtype=torch.float64)
    st = te.static
    assert (st.obs_dim, st.state_dim) == (je.static.obs_dim, je.static.state_dim)
    tparams = te.params if level is None else te.params.with_curriculum_level(level)
    rng = np.random.default_rng(7)
    with jax.enable_x64(True):
        jparams = jax.tree.map(
            lambda x: x.astype(jnp.float64) if jnp.issubdtype(x.dtype, jnp.floating) else x,
            je.params)
        if level is not None:
            jparams = jparams.replace(curriculum_level=jnp.asarray(level, jnp.float64))
        key = jax.random.PRNGKey(3)
        jstate, jobs = jenv.env_reset(je.static, jparams, key)
        state, obs = tenv.env_reset(st, tparams, *_torch(reference_reset_draws(je.static, key, N)))
        assert max_diff(jobs, obs) < TOL, "reset obs"
        for name in ("cube_mass", "cube_half_extents", "cube_inertia", "link_masses",
                     "mu_tip_cube", "mu_link_cube", "restitution_tip_cube"):
            assert max_diff(getattr(jstate.scene, name), getattr(state.scene, name)) < 1e-12, name
        assert max_diff(jstate.pd_scale, state.pd_scale) < 1e-12
        assert max_diff(jstate.goal_pose_cm, state.goal_pose_cm) < TOL
        assert max_diff(jstate.goal_angvel_cm, state.goal_angvel_cm) < TOL

        full_resets = 0
        for t in range(STEPS):
            action = rng.uniform(-1.0, 1.0, (N, st.action_dim))
            draws = _torch(reference_step_draws(je.static, jstate.key, N))
            full_resets += int(np.asarray(jstate.reset_buf).sum())
            jstate, jo, js, jr, jd, jinfo = jenv.env_step(je.static, jparams, jstate,
                                                          jnp.asarray(action))
            state, o, s, r, d, info = tenv.env_step(st, tparams, state,
                                                    torch.as_tensor(action), draws)
            for name, a, b in (("obs", jo, o), ("states", js, s), ("reward", jr, r),
                               ("goal_pose", jstate.goal_pose_cm, state.goal_pose_cm),
                               ("pd_scale", jstate.pd_scale, state.pd_scale),
                               ("cube_mass", jstate.scene.cube_mass, state.scene.cube_mass)):
                err = max_diff(a, b)
                assert err < TOL, f"{case} step {t} {name}: {err}"
            assert np.array_equal(np.asarray(jd), d.numpy()), f"{case} step {t} dones"
            assert np.array_equal(np.asarray(jstate.goal_reset_buf), state.goal_reset_buf.numpy())
            assert np.array_equal(np.asarray(jstate.successes), state.successes.numpy())
            _compare_info(jinfo, info, f"{case} step {t}")
    assert full_resets >= 2 * N  # the episode ends twice inside the run
    if st.curriculum_success_gated:
        assert float(info["env/curriculum_level"]) == level
        lerp = st.position_tolerance_init + level * (
            st.position_tolerance - st.position_tolerance_init)
        assert abs(float(info["env/position_tolerance"]) - lerp) < 1e-12
    if st.tolerance_anneal_frames > 0:
        # the ramp ended: final tolerances
        assert abs(float(info["env/orientation_tolerance"]) - st.orientation_tolerance) < 1e-6
