"""Port parity: the quaternion helpers (``utils/math.py``), the kinematics
world helpers (``ops/kinematics.py``), the dynamics oracle
(``ops/dynamics.py``) and ``engine_v2.fingertip_states_v2``.

Each against the JAX package's function on shared seeded float32 inputs
(the JAX dynamics and fingertip functions written for one finger or env run
under ``jax.vmap``), within 1e-6 (1e-5 relative where the values are
O(10)). ``bias_forces_lagrangian`` (``torch.func`` autodiff of the mass
matrix and potential) is also held to the port's own recursive
Newton-Euler ``bias_forces`` in float64, within 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leibnizgym_tpu.ops import dynamics as jdyn
from leibnizgym_tpu.ops import engine_v2 as jev2
from leibnizgym_tpu.ops import kinematics as jkin
from leibnizgym_tpu.utils import math as jmath
from leibnizgym_tpu_torch.models import trifinger as tf_model
from leibnizgym_tpu_torch.ops import dynamics as tdyn
from leibnizgym_tpu_torch.ops import engine_v2 as tev2
from leibnizgym_tpu_torch.ops import kinematics as tkin
from leibnizgym_tpu_torch.utils import math as tmath
from test_torch_common import max_diff, random_physics

torch.set_num_threads(1)

N = 32
TOL = 1e-6
GRAV = np.array([0.0, 0.0, -9.81], np.float32)


def _quats(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _vec(n, seed, scale=1.0):
    return (np.random.default_rng(seed).uniform(-1, 1, (n, 3)) * scale).astype(np.float32)


def _both(fn_j, fn_t, *arrays):
    return fn_j(*map(jnp.asarray, arrays)), fn_t(*map(torch.as_tensor, arrays))


def test_quaternion_helpers():
    q, v = _quats(N, 0), _vec(N, 1)
    pairs = [
        _both(jmath.quat_rotate_inverse, tmath.quat_rotate_inverse, q, v),
        _both(jmath.quat_to_matrix, tmath.quat_to_matrix, q),
        _both(lambda a, b: jmath.quat_integrate(a, b, 0.005),
              lambda a, b: tmath.quat_integrate(a, b, 0.005), q, _vec(N, 2, 5.0)),
        _both(jmath.quat_from_axis_angle, tmath.quat_from_axis_angle,
              np.asarray(tmath.quat_normalize(torch.as_tensor(_vec(N, 3)))[..., :3]),
              np.random.default_rng(4).uniform(-3, 3, N).astype(np.float32)),
    ]
    for a, b in pairs:
        assert max_diff(a, b) < TOL
    # inverse rotation undoes the rotation
    back = tmath.quat_rotate(torch.as_tensor(q), tmath.quat_rotate_inverse(
        torch.as_tensor(q), torch.as_tensor(v)))
    assert max_diff(v, back) < TOL


def test_matrix_to_quat_all_branches():
    """Rotations whose dominant component is w, x, y and z in turn (every
    branch of the Shepperd selection)."""
    quats = _quats(N, 5)
    for axis in range(4):
        quats[axis, axis] = 10.0
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    mats = np.array(jmath.quat_to_matrix(jnp.asarray(quats)))
    ref, port = _both(jmath.matrix_to_quat, tmath.matrix_to_quat, mats)
    assert max_diff(ref, port) < TOL
    # the same rotation up to sign
    dots = np.abs((port.numpy() * quats).sum(-1))
    assert float(np.abs(dots - 1).max()) < 1e-5


def test_kinematics_helpers():
    phys = random_physics(N, 6)
    q9, qd9 = phys["q"], phys["qd"]
    q3, qd3 = q9.reshape(N, 3, 3), qd9.reshape(N, 3, 3)
    theta = np.random.default_rng(7).uniform(-3, 3, N).astype(np.float32)
    assert max_diff(jkin.rot_z(jnp.asarray(theta)), tkin.rot_z(torch.as_tensor(theta))) < TOL
    np.testing.assert_array_equal(np.asarray(jkin.MOUNT_ROTS), tkin.MOUNT_ROTS)
    np.testing.assert_array_equal(np.asarray(jkin.MOUNT_POS), tkin.MOUNT_POS)
    jfk, tfk = jkin.finger_fk(jnp.asarray(q3)), tkin.finger_fk(torch.as_tensor(q3))
    assert max_diff(jkin.tip_jacobian(jfk), tkin.tip_jacobian(tfk)) < TOL
    assert max_diff(jkin.tip_velocity(jfk, jnp.asarray(qd3)),
                    tkin.tip_velocity(tfk, torch.as_tensor(qd3))) < TOL
    assert max_diff(jkin.tip_angular_velocity(jfk, jnp.asarray(qd3)),
                    tkin.tip_angular_velocity(tfk, torch.as_tensor(qd3))) < TOL
    rot = np.broadcast_to(tkin.MOUNT_ROTS[1], (N, 3, 3)).copy()
    x = _vec(N, 8, 0.2)
    assert max_diff(jkin.finger_to_world(jnp.asarray(x), jnp.asarray(rot)),
                    tkin.finger_to_world(torch.as_tensor(x), torch.as_tensor(rot))) < TOL
    ref = jkin.all_tips_world(jnp.asarray(q9))
    port = tkin.all_tips_world(torch.as_tensor(q9))
    assert max_diff(ref[0], port[0]) < TOL and max_diff(ref[1], port[1]) < TOL
    assert max_diff(ref[2].tip_pos, port[2].tip_pos) < TOL


@pytest.mark.parametrize("per_env_masses", [False, True])
def test_potential_and_lagrangian_bias(per_env_masses):
    rng = np.random.default_rng(9)
    q = (np.asarray(tf_model.JOINT_POS_DEFAULT) + rng.uniform(-0.5, 0.5, (N, 3))).astype(
        np.float32)
    qd = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    masses = (np.asarray(tf_model.LINK_MASSES) * rng.uniform(0.9, 1.1, (N, 3))).astype(
        np.float32) if per_env_masses else None
    in_axes = (0, 0, None, 0 if per_env_masses else None)
    jpot = jax.vmap(lambda a, g, m: jdyn.potential_energy(a, g, m),
                    in_axes=(0, None, 0 if per_env_masses else None))(
        jnp.asarray(q), jnp.asarray(GRAV), None if masses is None else jnp.asarray(masses))
    t = lambda x: None if x is None else torch.as_tensor(x)  # noqa: E731
    tpot = tdyn.potential_energy(t(q), t(GRAV), t(masses))
    assert max_diff(jpot, tpot) < TOL
    jb = jax.vmap(lambda a, b, g, m: jdyn.bias_forces_lagrangian(a, b, g, m),
                  in_axes=in_axes)(jnp.asarray(q), jnp.asarray(qd), jnp.asarray(GRAV),
                                   None if masses is None else jnp.asarray(masses))
    tb = tdyn.bias_forces_lagrangian(t(q), t(qd), t(GRAV), t(masses))
    assert max_diff(jb, tb) < 1e-5 * max(1.0, float(np.abs(np.asarray(jb)).max()))
    # the autodiff oracle against the port's recursive Newton-Euler, float64
    d = lambda x: None if x is None else torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    oracle = tdyn.bias_forces_lagrangian(d(q), d(qd), d(GRAV), d(masses))
    rnea = tdyn.bias_forces(d(q), d(qd), d(GRAV), d(masses))
    assert float((oracle - rnea).abs().max()) < 1e-10


def test_fingertip_states_v2():
    phys = random_physics(N, 10)
    ref = jax.vmap(jev2.fingertip_states_v2)(jnp.asarray(phys["q"]), jnp.asarray(phys["qd"]))
    port = tev2.fingertip_states_v2(torch.as_tensor(phys["q"]), torch.as_tensor(phys["qd"]))
    assert tuple(port.shape) == (N, 3, 13)
    assert max_diff(ref, port) < TOL * 10  # velocities O(1-10)
