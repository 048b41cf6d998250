"""Port parity: the batch-first reference engine (``ops/engine.py``).

- ``ops.engine.physics_step`` against the JAX package's
  ``jit(vmap(ops.engine.physics_step))`` at n = 8 over PGS (2 substeps x 4
  iterations), TGS (4 x 8) with per-env params on both arenas, and the
  sphere with per-env params; both sides in float64 (``jax.enable_x64``:
  in float32 the frameworks' sin/cos differ by an ulp and the contact solve
  amplifies it), tolerance 1e-5. The gate sweep is in
  test_torch_engine_reference_gates.py.
- In float32, against the port's own ``physics_step_plain`` (the SoA
  formulation the CUDA kernel computes) at the JAX package's engine
  equivalence bounds, states 1e-4 and wrench 1e-2
  (tests/test_physics.py:544-605), on that test's kind of states.
- The ports of ``TestSingularContacts`` and ``TestDegenerateTipContact``
  (tests/test_physics.py:370-450) for this engine: finite after 60 / 20
  steps, the velocity clamp holding ``|qd| <= 10 + 1e-5``.
- One function serves N = 1 and N envs: each env stepped alone equals its
  row of the batched step.
- NaN in an input goes non-finite in the same fields as in the JAX engine.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leibnizgym_tpu.ops import types as jtypes
from leibnizgym_tpu_torch import ops as tops
from leibnizgym_tpu_torch.models import trifinger as tf_model
from leibnizgym_tpu_torch.ops import cuda_engine
from leibnizgym_tpu_torch.ops import engine as tengine
from leibnizgym_tpu_torch.ops import kinematics as tkin
from leibnizgym_tpu_torch.ops import types as ttypes
from test_torch_common import (
    STATE_FIELDS,
    jax_inputs,
    max_diff,
    random_physics,
    scene_arrays,
    torch_inputs,
)

torch.set_num_threads(1)

N = 8
TOL = 1e-5

CASES = {
    # name: (SolverConfig kwargs, object shape, per-env params)
    "pgs_s2_i4": (dict(solver_type=0, substeps=2, solver_iterations=4), "box", False),
    "tgs_s4_i8_per_env_cone_cyl": (dict(solver_type=1, substeps=4, solver_iterations=8),
                                   "box", True),
    "tgs_s2_i4_sphere_per_env": (dict(solver_type=1, substeps=2, solver_iterations=4,
                                      object_shape=1), "sphere", True),
}


@functools.lru_cache(maxsize=None)
def jax_reference_step(cfg, dt=0.02):
    """The JAX package's reference engine: jit(vmap(physics_step)), one
    compiled function per configuration."""
    from leibnizgym_tpu.ops.engine import physics_step

    step = jax.vmap(physics_step, in_axes=(0, 0, 0, None, None))
    return jax.jit(lambda s, t, p: step(s, t, p, cfg, dt))


def check_against_jax(kw, shape, per_env, seed, label):
    phys = random_physics(N, seed)
    scene = scene_arrays(N, seed + 1, shape=shape, per_env=per_env)
    with jax.enable_x64(True):
        ref_state, ref_wrench = jax.device_get(
            jax_reference_step(jtypes.SolverConfig(**kw))(*jax_inputs(phys, scene, jnp.float64)))
    state, wrench = tengine.physics_step(*torch_inputs(phys, scene, torch.float64),
                                         ttypes.SolverConfig(**kw), 0.02)
    for name in STATE_FIELDS:
        err = max_diff(getattr(ref_state, name), getattr(state, name))
        assert err < TOL, f"{label} {name}: {err}"
    assert max_diff(ref_wrench, wrench) < TOL, label
    # not vacuous: contacts pushed the fingers or the object
    assert float(np.abs(np.asarray(ref_wrench)).max()) > 1e-2


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_engine_matches_jax(case):
    kw, shape, per_env = CASES[case]
    check_against_jax(kw, shape, per_env, 21, case)


def test_nan_propagates_as_reference():
    """NaN in one env's cube velocity and another's joint velocity: the same
    fields go non-finite as in the JAX engine (torch.maximum / clamp keep
    NaN as jnp.maximum / clip do), and the other envs stay equal."""
    kw, shape, per_env = CASES["pgs_s2_i4"]
    phys = random_physics(N, 51)
    phys["cube_angvel"][2, 1] = np.nan
    phys["qd"][5, 3] = np.nan
    scene = scene_arrays(N, 52, shape=shape, per_env=per_env)
    with jax.enable_x64(True):
        ref_state, ref_wrench = jax.device_get(
            jax_reference_step(jtypes.SolverConfig(**kw))(*jax_inputs(phys, scene, jnp.float64)))
    state, wrench = tengine.physics_step(*torch_inputs(phys, scene, torch.float64),
                                         ttypes.SolverConfig(**kw), 0.02)
    for name, a, b in [(k, getattr(ref_state, k), getattr(state, k)) for k in STATE_FIELDS] + [
            ("wrench", ref_wrench, wrench)]:
        a, b = np.asarray(a), b.numpy()
        assert np.array_equal(np.isfinite(a), np.isfinite(b)), name
        live = np.isfinite(a)
        assert float(np.abs(a[live] - b[live]).max()) < TOL, name
    assert not np.isfinite(np.asarray(ref_state.cube_angvel)[2]).all()
    assert np.isfinite(np.asarray(ref_state.q)[[0, 1, 3, 4, 6, 7]]).all()


def _equivalence_states(n: int, seed: int):
    """tests/test_physics.py TestEngineEquivalence's states: default pose +-
    0.3, identity cube orientation, the cube above the floor."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))  # noqa: E731
    state = ttypes.PhysicsState.default(n)
    state = state.replace(
        q=f32(np.tile(tf_model.JOINT_POS_DEFAULT, 3) + rng.uniform(-0.3, 0.3, (n, 9))),
        qd=f32(rng.uniform(-2, 2, (n, 9))),
        cube_pos=f32(np.stack([rng.uniform(-0.1, 0.1, n), rng.uniform(-0.1, 0.1, n),
                               rng.uniform(0.03, 0.08, n)], -1)),
        cube_linvel=f32(rng.uniform(-0.5, 0.5, (n, 3))),
        cube_angvel=f32(rng.uniform(-2, 2, (n, 3))),
    )
    return state, f32(rng.uniform(-0.36, 0.36, (n, 9)))


@pytest.mark.parametrize("solver_type", [0, 1])
def test_float32_matches_plain_soa_engine(solver_type):
    cfg = ttypes.SolverConfig(substeps=2, solver_iterations=4, solver_type=solver_type)
    params = ttypes.SceneParams.default()
    state, tau = _equivalence_states(16, 0)
    s1, w1 = tengine.physics_step(state, tau, params, cfg, 0.02)
    s2, w2 = cuda_engine.physics_step_plain(state, tau, params, cfg, 0.02)
    assert s1.q.dtype == torch.float32
    for name in STATE_FIELDS:
        err = float((getattr(s1, name) - getattr(s2, name)).abs().max())
        assert err < 1e-4, f"{name}: {err}"
    assert float((w1 - w2).abs().max()) < 1e-2


def test_extended_finger_at_wall_stays_finite():
    """A fully extended finger pressing the wall (the finger-only effective
    mass floored at w_min), three configurations straddling the q2 limit as
    three envs, 60 steps of outward torque."""
    cfg = ttypes.SolverConfig()
    params = ttypes.SceneParams.default()
    q2 = torch.tensor([1.40, 1.55, 1.57])
    q = torch.tensor([-0.0636, 0.0, -0.02, 0.0, 0.9, -1.7, 0.0, 0.9, -1.7]).repeat(3, 1)
    q[:, 1] = q2
    state = ttypes.PhysicsState.default(3).replace(
        q=q, cube_pos=torch.tensor([0.0, 0.0, 0.0325]).repeat(3, 1))
    tau = torch.tensor([0.0, 0.36, 0.36, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]).repeat(3, 1)
    for _ in range(60):
        state, _ = tops.physics_step(state, tau, params, cfg, 0.02)
    for name, x in state.fields().items():
        assert bool(torch.isfinite(x).all()), name
    assert float(state.qd.abs().max()) <= 10.0 + 1e-5


def test_tip_buried_in_cube_stays_finite():
    """The cube centered exactly on finger 0's tip: the closest-point delta
    is zero (the historical 0/0 torsion trigger)."""
    cfg = ttypes.SolverConfig()
    params = ttypes.SceneParams.default()
    q9 = torch.as_tensor(np.tile(tf_model.JOINT_POS_DEFAULT, 3).astype(np.float32))[None]
    tips, _, _ = tkin.all_tips_world(q9)
    state = ttypes.PhysicsState.default(1).replace(q=q9, cube_pos=tips[:, 0])
    for _ in range(20):
        state, wrench = tops.physics_step(state, torch.zeros(1, 9), params, cfg, 0.02)
    for name, x in state.fields().items():
        assert bool(torch.isfinite(x).all()), name
    assert bool(torch.isfinite(wrench).all())


def test_one_env_equals_its_row():
    phys = random_physics(4, 31)
    scene = scene_arrays(4, 32, per_env=True)
    cfg = ttypes.SolverConfig(solver_type=1, substeps=2, solver_iterations=4)
    state, tau, params = torch_inputs(phys, scene, torch.float64)
    batched, wrench = tengine.physics_step(state, tau, params, cfg, 0.02)
    for e in range(4):
        one, w1 = tengine.physics_step(state.map(lambda x: x[e:e + 1]), tau[e:e + 1],  # noqa: B023
                                       params.map(lambda x: x[e:e + 1]), cfg, 0.02)  # noqa: B023
        for name in STATE_FIELDS:
            assert max_diff(getattr(batched, name)[e:e + 1].numpy(), getattr(one, name)) < 1e-12
        assert max_diff(wrench[e:e + 1].numpy(), w1) < 1e-12
    # unbatched params broadcast over the envs
    default = ttypes.SceneParams.default(dtype=torch.float64)
    a, _ = tengine.physics_step(state, tau, default, cfg, 0.02)
    b, _ = tengine.physics_step(state, tau, default.broadcast(4), cfg, 0.02)
    for name in STATE_FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name))
