"""Port parity: the stacked reward terms (``envs/trifinger/rewards.py``), the
samplers that take a generator (``envs/trifinger/sample.py``) and
``dr.sample_scene_params``.

- The seven term functions and ``compute_rewards`` against the JAX
  package's on shared seeded float32 states (object (N, 13), fingertips
  (N, 3, 13), goal (N, 7)), within 1e-6 of the largest value; and
  ``compute_rewards`` held to the port's component form
  ``compute_rewards_c`` (what the env calls) on the same states in float64
  (1e-9). Reward
  configs: the env default, D4's scheduled terms, and every term active
  with windows and an L1 reach norm.
- The samplers: with a generator they equal their ``*_from_uniform`` /
  ``*_from_normal`` halves on that generator's draws; those halves fed the
  JAX key samplers' own draws equal the JAX samplers; the values lie in
  their ranges (the disc, the heights, unit quaternions, yaw-only).
- ``dr.sample_scene_params`` likewise: its generator's scene block through
  ``sample_scene_params_from_uniform``; the JAX sampler's draws through the
  port's mapping equal the JAX sampler's SceneParams.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leibnizgym_tpu import dr as jdr
from leibnizgym_tpu.envs.trifinger import rewards as jrewards
from leibnizgym_tpu.envs.trifinger import sample as jsample
from leibnizgym_tpu.ops import types as jtypes
from leibnizgym_tpu_torch import dr as tdr
from leibnizgym_tpu_torch.envs.trifinger import rewards as trewards
from leibnizgym_tpu_torch.envs.trifinger import sample as tsample
from leibnizgym_tpu_torch.envs.trifinger.config import TRIFINGER_DEFAULT_CONFIG_DICT
from leibnizgym_tpu_torch.ops import types as ttypes
from test_torch_common import max_diff

torch.set_num_threads(1)

N = 32
DT = 0.02

ALL_ACTIVE = {
    "finger_reach_object_rate": {"activate": True, "weight": -750, "norm_p": 1,
                                 "thresh_sched_start": 10, "thresh_sched_end": 5e6},
    "finger_move_penalty": {"activate": True, "weight": -0.1},
    "object_dist": {"activate": True, "weight": 2000, "thresh_sched_start": 0,
                    "thresh_sched_end": 1e3},
    "object_rot": {"activate": True, "weight": 300, "scale": 0.5},
    "object_rot_delta": {"activate": True, "weight": -250, "linear_schedule_start": 0,
                         "linear_schedule_end": 2e6},
    "object_move": {"activate": True, "weight": -750},
    "keypoint_dist": {"activate": True, "weight": 2000, "scale": 30.0},
}


def _terms(name):
    if name == "default":
        return TRIFINGER_DEFAULT_CONFIG_DICT["reward_terms"]
    if name == "d4":
        from leibnizgym_tpu_torch.config.presets import GYM_PRESETS
        return GYM_PRESETS["trifinger_difficulty_4"]["reward_terms"]
    return ALL_ACTIVE


def _states(seed):
    rng = np.random.default_rng(seed)

    def quat(*shape):
        q = rng.normal(size=shape + (4,))
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    def body(*shape):
        return np.concatenate([rng.uniform(-0.1, 0.1, shape + (3,)), quat(*shape),
                               rng.uniform(-1, 1, shape + (6,))], -1)

    arrays = {
        "fingertip_state": body(N, 3), "last_fingertip_state": body(N, 3),
        "object_state": body(N), "last_object_state": body(N),
        "goal_pose": np.concatenate([rng.uniform(-0.1, 0.1, (N, 3)), quat(N)], -1),
        "half_extents": np.full((N, 3), 0.0325) * rng.uniform(0.97, 1.03, (N, 1)),
    }
    return {k: v.astype(np.float32) for k, v in arrays.items()}


def _check(ref, port):
    scale = max(1.0, float(np.abs(np.asarray(ref)).max()))
    assert max_diff(ref, port) < 1e-6 * scale


@pytest.mark.parametrize("terms", ["default", "d4", "all_active"])
@pytest.mark.parametrize("step", [0.0, 100.0, 3e6])
def test_reward_terms_match_reference(terms, step):
    a = _states(int(step) % 97 + len(terms))
    j = {k: jnp.asarray(v) for k, v in a.items()}
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    jspecs = jrewards.build_reward_specs(_terms(terms))
    tspecs = trewards.build_reward_specs(_terms(terms))
    js, ts = jnp.asarray(step, jnp.float32), torch.tensor(step)
    calls = {
        "object_dist": lambda m, s, x: m.object_dist(s["object_dist"], DT, x["step"],
                                                     x["object_state"], x["goal_pose"]),
        "object_move": lambda m, s, x: m.object_move(s["object_move"], x["object_state"],
                                                     x["last_object_state"], x["goal_pose"]),
        "object_rot": lambda m, s, x: m.object_rot(s["object_rot"], DT, x["step"],
                                                   x["object_state"], x["goal_pose"]),
        "object_rot_delta": lambda m, s, x: m.object_rot_delta(
            s["object_rot_delta"], DT, x["step"], x["object_state"], x["last_object_state"],
            x["goal_pose"]),
        "finger_reach_object_rate": lambda m, s, x: m.finger_reach_object_rate(
            s["finger_reach_object_rate"], x["step"], x["fingertip_state"],
            x["last_fingertip_state"], x["object_state"], x["last_object_state"]),
        "finger_move_penalty": lambda m, s, x: m.finger_move_penalty(
            s["finger_move_penalty"], DT, x["fingertip_state"], x["last_fingertip_state"]),
        "keypoint_dist": lambda m, s, x: m.keypoint_dist(
            s["keypoint_dist"], DT, x["step"], x["object_state"], x["goal_pose"],
            x["half_extents"]),
    }
    for name, call in calls.items():
        _check(call(jrewards, jspecs, dict(j, step=js)), call(trewards, tspecs, dict(t, step=ts)))

    args = ("fingertip_state", "last_fingertip_state", "object_state", "last_object_state",
            "goal_pose")
    jr, jterms = jrewards.compute_rewards(jspecs, DT, js, *(j[k] for k in args),
                                          half_extents=j["half_extents"])
    tr, tterms = trewards.compute_rewards(tspecs, DT, ts, *(t[k] for k in args),
                                          half_extents=t["half_extents"])
    assert set(jterms) == set(tterms)
    _check(jr, tr)
    for name in jterms:
        _check(jterms[name], tterms[name])

    # the stacked form against the component form the env calls, in float64
    # (in float32 the two orders of the same sums round apart, and asin near
    # a half turn amplifies that to ~1e-3 of the rotation-delta term)
    def cols(x):
        return tuple(x[..., i] for i in range(x.shape[-1]))

    d = {k: v.double() for k, v in t.items()}
    sr, sterms = trewards.compute_rewards(tspecs, DT, ts, *(d[k] for k in args),
                                          half_extents=d["half_extents"])
    tip = [cols(d["fingertip_state"][:, f, 0:3]) for f in range(3)]
    tip_prev = [cols(d["last_fingertip_state"][:, f, 0:3]) for f in range(3)]
    o, lo, g = d["object_state"], d["last_object_state"], d["goal_pose"]
    cr, cterms = trewards.compute_rewards_c(
        tspecs, DT, ts, tip, tip_prev, cols(o[:, 0:3]), cols(o[:, 3:7]), cols(lo[:, 0:3]),
        cols(lo[:, 3:7]), cols(g[:, 0:3]), cols(g[:, 3:7]), half_extents=cols(d["half_extents"]))
    assert set(cterms) == set(sterms) == set(tterms)
    assert float((sr - cr).abs().max()) < 1e-9 * max(1.0, float(sr.abs().max()))


def _key_draws(seed):
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    return key, k1, k2


def test_keyed_samplers_from_reference_draws():
    """The JAX key samplers' own draws through the port's pure halves give
    the JAX samplers' values."""
    key, k_r, k_t = _key_draws(1)
    u2 = torch.as_tensor(np.stack([np.asarray(jax.random.uniform(k_r, (N,))),
                                   np.asarray(jax.random.uniform(k_t, (N,)))], -1))
    for a, b in zip(jsample.random_xy(key, N, 0.15), tsample.random_xy_from_uniform(u2, 0.15)):
        assert max_diff(a, b) < 1e-6
    u1 = torch.as_tensor(np.array(jax.random.uniform(key, (N,))))
    assert max_diff(jsample.random_z(key, N, 0.03, 0.1),
                    tsample.random_z_from_uniform(u1, 0.03, 0.1)) < 1e-6
    assert max_diff(jsample.random_yaw_orientation(key, N),
                    tsample.random_yaw_orientation_from_uniform(u1)) < 1e-6
    n4 = torch.as_tensor(np.array(jax.random.normal(key, (N, 4))))
    assert max_diff(jsample.random_orientation(key, N),
                    tsample.random_orientation_from_normal(n4)) < 1e-6
    k_axis, k_mag = jax.random.split(key)
    n4 = torch.as_tensor(np.concatenate([np.asarray(jax.random.normal(k_axis, (N, 3))),
                                         np.asarray(jax.random.normal(k_mag, (N, 1)))], -1))
    assert max_diff(jsample.random_angular_vel(key, N, 0.5),
                    tsample.random_angular_vel_from_normal(n4, 0.5)) < 1e-6


def test_generator_samplers():
    def gen():
        return torch.Generator().manual_seed(11)

    g = gen()
    xy = tsample.random_xy(gen(), N, 0.15)
    u2 = torch.rand((N, 2), generator=g)
    ref = tsample.random_xy_from_uniform(u2, 0.15)
    assert all(torch.equal(a, b) for a, b in zip(xy, ref))
    assert float(torch.sqrt(xy[0] ** 2 + xy[1] ** 2).max()) <= 0.15 + 1e-7
    z = tsample.random_z(gen(), N, 0.03, 0.1)
    assert torch.equal(z, tsample.random_z_from_uniform(torch.rand(N, generator=gen()), 0.03,
                                                        0.1))
    assert float(z.min()) >= 0.03 and float(z.max()) <= 0.1
    q = tsample.random_orientation(gen(), N)
    assert torch.equal(q, tsample.random_orientation_from_normal(
        torch.randn((N, 4), generator=gen())))
    assert float((torch.linalg.vector_norm(q, dim=-1) - 1).abs().max()) < 1e-6
    w = tsample.random_angular_vel(gen(), N, 0.5)
    assert torch.equal(w, tsample.random_angular_vel_from_normal(
        torch.randn((N, 4), generator=gen()), 0.5))
    yaw = tsample.random_yaw_orientation(gen(), N)
    assert torch.equal(yaw, tsample.random_yaw_orientation_from_uniform(
        torch.rand(N, generator=gen())))
    assert float(yaw[:, :2].abs().max()) < 1e-7
    assert float((torch.linalg.vector_norm(yaw, dim=-1) - 1).abs().max()) < 1e-6


@pytest.mark.parametrize("shape", ["box", "sphere"])
def test_sample_scene_params(shape):
    ranges = {"cube_mass_scale": (0.5, 1.5), "friction_scale": (0.9, 1.1)}
    jbase = jtypes.SceneParams.default(object_shape=shape)
    tbase = ttypes.SceneParams.default(object_shape=shape)
    key = jax.random.PRNGKey(3)
    ref = jdr.sample_scene_params(key, N, jbase, ranges)
    k_cm, k_cs, k_lm, k_fr, k_re = jax.random.split(key, 5)
    u = np.concatenate([np.asarray(jax.random.uniform(k, (N,) + s)).reshape(N, -1)
                        for k, s in ((k_cm, ()), (k_cs, ()), (k_lm, (3,)), (k_fr, ()),
                                     (k_re, ()))], -1)
    port = tdr.sample_scene_params_from_uniform(torch.as_tensor(u), tbase, ranges)
    for name, value in port.fields().items():
        assert max_diff(getattr(ref, name), value) < 1e-6 * max(
            1.0, float(np.abs(np.asarray(getattr(ref, name))).max())), name
    # the generator form is its scene block through the same mapping
    drawn = tdr.sample_scene_params(torch.Generator().manual_seed(5), N, tbase, ranges)
    block, _ = tdr.draw_uniforms(torch.Generator().manual_seed(5), N, "cpu")
    again = tdr.sample_scene_params_from_uniform(block, tbase, ranges)
    for name, value in drawn.fields().items():
        assert torch.equal(value, getattr(again, name)), name
    scale = drawn.cube_mass / tbase.cube_mass
    assert float(scale.min()) >= 0.5 and float(scale.max()) <= 1.5
