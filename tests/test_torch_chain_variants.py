"""Port parity: the robot-variant path (``models/chain.py``,
``ops/kinematics.py``, ``ops/dynamics.py``, ``ops/generic_chain.py``)
against the JAX package, on every robot URDF under
``resources/assets/robots/`` (the twin of tests/test_chain_variants.py).

Both sides run in float64 (``jax.enable_x64``) on the same seeded numpy
inputs and the same chain tables (each side's ``chain_from_urdf``, cast to
float64, so no side rounds a table product in float32). Tolerance 1e-10:
the two frameworks sum the same products in different orders (einsum,
matmul), differences of a few float64 ulps that the 3x3 solve and five
4-substep steps grow to ~1e-13 (measured); the bound leaves ~1000x.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leibnizgym_tpu.models import chain as jchain
from leibnizgym_tpu.ops import dynamics as jdyn
from leibnizgym_tpu.ops import generic_chain as jgc
from leibnizgym_tpu.ops import kinematics as jkin
from leibnizgym_tpu_torch.models import chain as tchain
from leibnizgym_tpu_torch.ops import dynamics as tdyn
from leibnizgym_tpu_torch.ops import generic_chain as tgc
from leibnizgym_tpu_torch.ops import kinematics as tkin

torch.set_num_threads(1)

TOL = 1e-10
ROBOTS = os.path.join(os.path.dirname(__file__), "..", "resources", "assets", "robots")
VARIANTS = sorted(os.listdir(ROBOTS))
G = np.array([0.0, 0.0, -9.81])


def _f64(chain):
    return dataclasses.replace(chain, **{
        f.name: np.asarray(getattr(chain, f.name), np.float64)
        for f in dataclasses.fields(chain) if f.name not in ("name", "num_fingers")})


def _chains(rel):
    path = os.path.join(ROBOTS, rel)
    return _f64(jchain.chain_from_urdf(path)), _f64(tchain.chain_from_urdf(path))


def _q(chain, n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(chain.joint_lower, chain.joint_upper, (n, 3))


def _close(ref, ours, what):
    err = float(np.abs(np.asarray(ref) - ours.numpy()).max())
    assert err < TOL, f"{what}: {err}"


def test_there_are_ten_robot_variants():
    assert len(VARIANTS) == 10 and all(v.endswith(".urdf") for v in VARIANTS)


def test_trifingerpro_fk_and_dynamics_match_reference():
    """The specialized trifingerpro chain (ops/kinematics.finger_fk, the
    default tables of ops/dynamics) on a batch."""
    rng = np.random.default_rng(0)
    q, qd = rng.uniform(-1.0, 0.5, (16, 3)), rng.uniform(-2, 2, (16, 3))
    tau, scale = rng.uniform(-0.3, 0.3, (16, 3)), rng.uniform(0.9, 1.1, (16, 3))
    with jax.enable_x64(True):
        jfk = jkin.finger_fk(jnp.asarray(q))
        jm = jax.vmap(jdyn.mass_matrix)(jnp.asarray(q), jnp.asarray(scale),
                                       jnp.full((16, 3), 0.003))
        jb = jax.vmap(jdyn.bias_forces, in_axes=(0, 0, None, 0))(
            jnp.asarray(q), jnp.asarray(qd), jnp.asarray(G), jnp.asarray(scale))
        jqdd = jax.vmap(jdyn.forward_dynamics, in_axes=(0, 0, 0, None, 0, None, None))(
            jnp.asarray(q), jnp.asarray(qd), jnp.asarray(tau), jnp.asarray(G),
            jnp.asarray(scale), jnp.full(3, 0.05), jnp.full(3, 0.003))
        jv, jw = jax.vmap(jdyn.link_jacobians)(jfk)
    t = torch.as_tensor
    tfk = tkin.finger_fk(t(q))
    for name in jfk._fields:
        _close(getattr(jfk, name), getattr(tfk, name), name)
    tv, tw = tdyn.link_jacobians(tfk)
    _close(jv, tv, "jv")
    _close(jw, tw, "jw")
    _close(jm, tdyn.mass_matrix(t(q), t(scale), torch.full((16, 3), 0.003,
                                                           dtype=torch.float64)), "M")
    _close(jb, tdyn.bias_forces(t(q), t(qd), G, t(scale)), "bias")
    _close(jqdd, tdyn.forward_dynamics(t(q), t(qd), t(tau), G, t(scale), np.full(3, 0.05),
                                       np.full(3, 0.003)), "qdd")


@pytest.mark.parametrize("rel", VARIANTS)
def test_chain_fk_and_dynamics_match_reference(rel):
    jc, tc = _chains(rel)
    q = _q(jc, 16, 1)
    rng = np.random.default_rng(2)
    qd, tau = rng.uniform(-2, 2, (16, 3)), rng.uniform(-0.3, 0.3, (16, 3))
    qall = np.concatenate([_q(jc, 16, 3 + f) for f in range(jc.num_fingers)], -1)
    g_local = jc.mount_rot[0].T @ G
    with jax.enable_x64(True):
        jfk = jgc.finger_fk_chain(jnp.asarray(q), jc)
        jtips = jgc.tips_world_chain(jnp.asarray(qall), jc)
        jqdd = jax.vmap(lambda q3, qd3, t3, fk3: jdyn.forward_dynamics(
            q3, qd3, t3, jnp.asarray(g_local), link_masses=jnp.asarray(jc.link_masses),
            joint_damping=jnp.full(3, 0.05), armature=jnp.full(3, 0.003), fk=fk3,
            base_masses=jnp.asarray(jc.link_masses),
            base_inertias=jnp.asarray(jc.link_inertias)))(
            jnp.asarray(q), jnp.asarray(qd), jnp.asarray(tau), jfk)
    t = torch.as_tensor
    tfk = tgc.finger_fk_chain(t(q), tc)
    for name in jfk._fields:
        _close(getattr(jfk, name), getattr(tfk, name), f"{rel} {name}")
    _close(jtips, tgc.tips_world_chain(t(qall), tc), f"{rel} tips")
    tqdd = tdyn.forward_dynamics(
        t(q), t(qd), t(tau), g_local, link_masses=tc.link_masses,
        joint_damping=np.full(3, 0.05), armature=np.full(3, 0.003), fk=tfk,
        base_masses=tc.link_masses, base_inertias=tc.link_inertias)
    _close(jqdd, tqdd, f"{rel} qdd")


@pytest.mark.parametrize("rel", VARIANTS)
def test_chain_physics_steps_match_reference(rel):
    """Five steps of 4 substeps from a seeded state under seeded torques of
    the robot's range (0.36 N m), with damping and armature; env 0 starts
    just inside its upper limits moving outward, so the clamp acts."""
    jc, tc = _chains(rel)
    n, f = 8, jc.num_fingers
    rng = np.random.default_rng(4)
    q0 = np.concatenate([_q(jc, n, 5 + i) for i in range(f)], -1)
    qd0 = rng.uniform(-3, 3, (n, 3 * f))
    q0[0], qd0[0] = np.tile(jc.joint_upper, f) - 1e-3, 3.0
    taus = rng.uniform(-0.4, 0.4, (5, n, 3 * f))
    kw = dict(joint_damping=0.05, armature=0.003)
    with jax.enable_x64(True):
        step = jax.jit(lambda s, tau: jgc.chain_physics_step(s, tau, jc, **kw))
        js = jgc.ChainState(q=jnp.asarray(q0), qd=jnp.asarray(qd0))
        ts = tgc.ChainState(q=torch.as_tensor(q0), qd=torch.as_tensor(qd0))
        hit = False
        for k in range(5):
            js = jax.device_get(step(js, jnp.asarray(taus[k])))
            ts = tgc.chain_physics_step(ts, torch.as_tensor(taus[k]), tc, **kw)
            _close(js.q, ts.q, f"{rel} step {k} q")
            _close(js.qd, ts.qd, f"{rel} step {k} qd")
            lo, hi = np.tile(jc.joint_lower, f), np.tile(jc.joint_upper, f)
            hit |= bool(((js.q == lo) | (js.q == hi)).any())
    assert hit, "no joint reached a limit: the clamp went untested"


@pytest.mark.parametrize("rel", ["trifingeredu.urdf", "fingerpro.urdf"])
def test_default_state_matches_reference(rel):
    jc, tc = _chains(rel)
    js = jgc.chain_default_state(jc, 4)
    ts = tgc.chain_default_state(tc, 4, device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(np.asarray(js.q), ts.q.numpy())
    np.testing.assert_array_equal(np.asarray(js.qd), ts.qd.numpy())
