"""Port parity: the TriFinger env (``envs/trifinger``, ``utils/math.py``).

- ``compute_torque``, the draw-injectable samplers and ``compute_rewards_c``
  against the JAX functions on shared seeded float32 inputs (1e-6).
- The slice: the JAX ``env_reset`` state, converted, stepped 50 steps by the
  JAX ``env_step`` and by the port with the golden action stream of
  tests/golden/traj_d1_seed0{,_cone}.npz, the port fed JAX's reset and goal
  draws (the key splits of the reference's env_step and
  ``_draw_reset_randoms``). obs, states, reward and dones are compared at
  every step within 2e-4, the goldens' bound. Both sides run in float64: in
  float32 the frameworks' ulp differences in the physics, amplified by the
  contact solve and by the reward weights (finger_reach_object_rate weighs a
  tip displacement by 750), reach 1e-2 in the reward over 50 steps even
  with identical formulas; float64 isolates the formulas (measured 1e-7).
  The float32 path is held to the golden arrays in test_torch_golden.py.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leibnizgym_tpu.envs.trifinger import env as jenv
from leibnizgym_tpu.envs.trifinger import rewards as jrewards
from leibnizgym_tpu.envs.trifinger import sample as jsample
from leibnizgym_tpu_torch.convert import env_state_from_jax
from leibnizgym_tpu_torch.envs.trifinger import env as tenv
from leibnizgym_tpu_torch.envs.trifinger import rewards as trewards
from leibnizgym_tpu_torch.envs.trifinger import sample as tsample
from test_torch_common import max_diff

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
N = 16


def golden_config(meta: dict) -> dict:
    """The env config the goldens were recorded with, plus asymmetric states."""
    return {
        "num_instances": meta["num_envs"], "task_difficulty": meta["difficulty"],
        "command_mode": "torque", "seed": meta["seed"], "asymmetric_obs": True,
        "arena": {"profile": meta.get("arena", "cylinder")},
        "sim": {"substeps": meta["substeps"],
                "physx": {"num_position_iterations": meta["iterations"],
                          "tpu_solver": meta.get("solver", "pgs")}},
    }


def load_golden(fname):
    data = np.load(os.path.join(GOLDEN_DIR, fname), allow_pickle=True)
    return data, json.loads(str(data["meta"]))


@pytest.mark.parametrize("mode", ["torque", "position", "position_impedance"])
def test_compute_torque(mode):
    adim = 18 if mode == "position_impedance" else 9
    cfg = {"num_instances": N, "command_mode": mode}
    je = jenv.TrifingerEnv(config=dict(cfg, engine="soa"), verbose=False)
    te = tenv.TrifingerEnv(config=cfg, verbose=False)
    rng = np.random.default_rng(1)
    action = rng.uniform(-1.2, 1.2, (N, adim)).astype(np.float32)
    q = rng.uniform(-1, 1, (N, 9)).astype(np.float32)
    qd = rng.uniform(-3, 3, (N, 9)).astype(np.float32)
    pd = rng.uniform(0.9, 1.1, (N, 2)).astype(np.float32)
    ref = jenv.compute_torque(je.static, je.params, jnp.asarray(action), jnp.asarray(q),
                              jnp.asarray(qd), jnp.asarray(pd))
    port = tenv.compute_torque(te.static, te.params, torch.as_tensor(action),
                               torch.as_tensor(q), torch.as_tensor(qd), torch.as_tensor(pd))
    assert max_diff(ref, port) < 1e-6


def test_samplers_from_draws():
    rng = np.random.default_rng(2)
    u = rng.random((N, 4)).astype(np.float32)
    nrm = rng.normal(size=(N, 4)).astype(np.float32)
    ju, tu, jn, tn = jnp.asarray(u), torch.as_tensor(u), jnp.asarray(nrm), torch.as_tensor(nrm)
    for a, b in zip(jsample.random_xy_from_uniform(ju[:, :2], 0.15),
                    tsample.random_xy_from_uniform(tu[:, :2], 0.15)):
        assert max_diff(a, b) < 1e-6
    assert max_diff(jsample.random_z_from_uniform(ju[:, 2], 0.03, 0.1),
                    tsample.random_z_from_uniform(tu[:, 2], 0.03, 0.1)) < 1e-6
    assert max_diff(jsample.random_yaw_orientation_from_uniform(ju[:, 3]),
                    tsample.random_yaw_orientation_from_uniform(tu[:, 3])) < 1e-6
    assert max_diff(jsample.random_orientation_from_normal(jn),
                    tsample.random_orientation_from_normal(tn)) < 1e-6
    assert max_diff(jsample.random_angular_vel_from_normal(jn, 0.5),
                    tsample.random_angular_vel_from_normal(tn, 0.5)) < 1e-6
    assert max_diff(jsample.default_orientation(N), tsample.default_orientation(N)) == 0.0


@pytest.mark.parametrize("preset", ["default", "d4_schedules"])
def test_compute_rewards_c(preset):
    from leibnizgym_tpu.config.presets import GYM_PRESETS
    from leibnizgym_tpu_torch.envs.trifinger.config import TRIFINGER_DEFAULT_CONFIG_DICT

    terms = (TRIFINGER_DEFAULT_CONFIG_DICT["reward_terms"] if preset == "default"
             else GYM_PRESETS["trifinger_difficulty_4"]["reward_terms"])
    rng = np.random.default_rng(3)

    def cols(k, lo=-0.1, hi=0.1):
        return [rng.uniform(lo, hi, N).astype(np.float32) for _ in range(k)]

    def quat():
        q = rng.normal(size=(N, 4)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        return [q[:, i] for i in range(4)]

    tip, tip_prev = [cols(3) for _ in range(3)], [cols(3) for _ in range(3)]
    args = [tip, tip_prev, cols(3), quat(), cols(3), quat(), cols(3), quat()]
    half = [np.full(N, 0.0325, np.float32)] * 3
    for step in (0.0, 2e7):
        jargs = [[tuple(jnp.asarray(c) for c in v) for v in a] if isinstance(a[0], list)
                 else tuple(jnp.asarray(c) for c in a) for a in args]
        targs = [[tuple(torch.as_tensor(c) for c in v) for v in a] if isinstance(a[0], list)
                 else tuple(torch.as_tensor(c) for c in a) for a in args]
        jr, jterms = jrewards.compute_rewards_c(
            jrewards.build_reward_specs(terms), 0.02, jnp.asarray(step, jnp.float32), *jargs,
            half_extents=tuple(jnp.asarray(h) for h in half))
        tr, tterms = trewards.compute_rewards_c(
            trewards.build_reward_specs(terms), 0.02, torch.tensor(step), *targs,
            half_extents=tuple(torch.as_tensor(h) for h in half))
        assert set(jterms) == set(tterms)
        scale = max(1.0, float(np.abs(np.asarray(jr)).max()))
        assert max_diff(jr, tr) < 1e-6 * scale
        for name in jterms:
            assert max_diff(jterms[name], tterms[name]) < 1e-6 * scale, name


def test_quat_diff_rad_c():
    rng = np.random.default_rng(4)
    qa, qb = (rng.normal(size=(N, 4)).astype(np.float32) for _ in range(2))
    qa /= np.linalg.norm(qa, axis=1, keepdims=True)
    qb /= np.linalg.norm(qb, axis=1, keepdims=True)
    ref = jrewards.quat_diff_rad_c(tuple(jnp.asarray(qa.T)), tuple(jnp.asarray(qb.T)))
    port = trewards.quat_diff_rad_c(tuple(torch.as_tensor(qa.T)), tuple(torch.as_tensor(qb.T)))
    assert max_diff(ref, port) < 1e-5  # asin near 1 magnifies an ulp of its argument


@pytest.mark.parametrize("extra", [
    {"domain_randomization": {"activate": True}},
    {"goal_movement": {"rotation": {"activate": True}}},
    {"use_keypoint_obs": True},
    {"use_keypoint_obs": True, "command_mode": "position_impedance"},
    {"obs_noise_std": 0.01, "goal_curriculum": {"success_gated": True}},
], ids=["dr", "goal_rotation", "keypoints", "keypoints_impedance", "noise_curriculum"])
def test_flagship_configs_build_with_reference_widths(extra):
    """The flagship recipe's features build (they raised NotImplementedError
    before the port had them) with the reference's obs and state widths."""
    cfg = dict({"num_instances": 2, "asymmetric_obs": True}, **extra)
    te = tenv.TrifingerEnv(config=cfg, verbose=False)
    je = jenv.TrifingerEnv(config=dict(cfg, engine="soa"), verbose=False)
    assert (te.static.obs_dim, te.static.state_dim) == (je.static.obs_dim, je.static.state_dim)
    assert te.get_obs_dim() == je.get_obs_dim() and te.get_state_dim() == je.get_state_dim()
    assert te.params.obs_scale_low.shape == je.params.obs_scale_low.shape
    assert max_diff(je.params.obs_scale_low, te.params.obs_scale_low) == 0.0
    assert max_diff(je.params.state_scale_high, te.params.state_scale_high) == 0.0
    obs = te.reset()
    assert obs.shape == (2, je.static.obs_dim) and bool(torch.isfinite(obs).all())


def _jax_draws(key, n):
    """The reset and goal draws of the reference env_step for this key."""
    _, k_reset, k_goal = jax.random.split(key, 3)
    return (np.array(jax.random.uniform(k_reset, (n, 25))),
            np.array(jax.random.uniform(k_goal, (n, 25))))


@pytest.mark.parametrize("fname", ["traj_d1_seed0.npz", "traj_d1_seed0_cone.npz"])
def test_slice_matches_reference_over_golden_actions(fname):
    data, meta = load_golden(fname)
    cfg = golden_config(meta)
    je = jenv.TrifingerEnv(config=dict(cfg, engine="soa"), verbose=False)
    te = tenv.TrifingerEnv(config=cfg, verbose=False, dtype=torch.float64)
    with jax.enable_x64(True):
        jparams = jax.tree.map(
            lambda x: x.astype(jnp.float64) if jnp.issubdtype(x.dtype, jnp.floating) else x,
            je.params)
        key = jax.random.split(jax.random.PRNGKey(meta["seed"]))[1]
        jstate, jobs = jax.jit(jenv.env_reset, static_argnums=0)(je.static, jparams, key)
        state = env_state_from_jax(jax.device_get(jstate))
        assert state.physics.q.dtype == torch.float64
        step = jax.jit(jenv.env_step, static_argnums=0)
        for t in range(meta["steps"]):
            action = data["action"][t].astype(np.float64)
            u_reset, u_goal = _jax_draws(jstate.key, N)
            jstate, jo, js, jr, jd, _ = jax.device_get(
                step(je.static, jparams, jstate, jnp.asarray(action)))
            state, obs, states, reward, dones, _ = tenv.env_step(
                te.static, te.params, state, torch.as_tensor(action),
                (torch.as_tensor(u_reset), None, torch.as_tensor(u_goal), None))
            for name, a, b in (("obs", jo, obs), ("states", js, states),
                               ("reward", jr, reward)):
                err = max_diff(a, b)
                assert err < 2e-4, f"step {t} {name}: {err}"
            assert np.array_equal(np.asarray(jd), dones.numpy()), f"step {t} dones"
            assert np.array_equal(np.asarray(jstate.goal_reset_buf),
                                  state.goal_reset_buf.numpy())
            assert max_diff(jstate.goal_pose_cm, state.goal_pose_cm) < 2e-4
