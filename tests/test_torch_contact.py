"""Port parity: the contact queries and impulse updates (``ops/contact.py``).

Each function against the JAX package's (``jax.vmap`` over the batch, the
port batch-first) on shared seeded float32 inputs, within 1e-6; plus the
four degenerate ``closest_point_on_box`` probes of
tests/test_physics.py:392-414 (on a face, on a corner, at the center,
epsilon outside), each a finite unit normal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leibnizgym_tpu.ops import contact as jc
from leibnizgym_tpu.ops import types as jtypes
from leibnizgym_tpu_torch.ops import contact as tc
from leibnizgym_tpu_torch.ops import types as ttypes
from test_torch_common import max_diff

torch.set_num_threads(1)

N = 64
TOL = 1e-6


def _rng(seed):
    return np.random.default_rng(seed)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def test_tangent_basis():
    n = _unit(_rng(0), N)
    n[:4] = [[1, 0, 0], [0, 1, 0], [0, 0, 1], [-1, 0, 0]]  # both branches of the axis pick
    ref = jax.vmap(jc._tangent_basis)(jnp.asarray(n))
    port = tc._tangent_basis(_t(n))
    for a, b in zip(ref, port):
        assert max_diff(a, b) < TOL
    # orthonormal frames
    t1, t2 = port
    assert float((t1 * _t(n)).sum(-1).abs().max()) < 1e-6
    assert float((torch.linalg.vector_norm(t2, dim=-1) - 1).abs().max()) < 1e-6


def test_cube_body():
    rng = _rng(1)
    pos = rng.uniform(-0.1, 0.1, (N, 3)).astype(np.float32)
    quat = rng.normal(size=(N, 4))
    quat = (quat / np.linalg.norm(quat, axis=1, keepdims=True)).astype(np.float32)
    mass = rng.uniform(0.05, 0.15, N).astype(np.float32)
    inertia = rng.uniform(3e-5, 8e-5, (N, 3)).astype(np.float32)
    ref = jax.vmap(jc.cube_body)(*map(jnp.asarray, (pos, quat, mass, inertia)))
    port = tc.cube_body(*map(_t, (pos, quat, mass, inertia)))
    for name in tc.CubeBody._fields:
        a, b = getattr(ref, name), getattr(port, name)
        scale = max(1.0, float(np.abs(np.asarray(a)).max()))
        assert max_diff(a, b) < TOL * scale, name


PROBES = [[0.0325, 0.0, 0.0], [0.0325, 0.0325, 0.0325], [0.0, 0.0, 0.0],
          [0.0325 + 1e-10, 0.0, 0.0]]


def test_closest_point_on_box():
    rng = _rng(2)
    half = np.full((N, 3), 0.0325, np.float32) * rng.uniform(0.8, 1.2, (N, 1)).astype(np.float32)
    center = rng.uniform(-0.06, 0.06, (N, 3)).astype(np.float32)  # inside and outside
    center[:4] = PROBES
    half[:4] = 0.0325
    ref = jax.vmap(jc.closest_point_on_box)(jnp.asarray(center), jnp.asarray(half))
    port = tc.closest_point_on_box(_t(center), _t(half))
    for a, b in zip(ref, port):
        assert max_diff(a, b) < TOL
    # both inside and outside centers were drawn
    assert (np.asarray(ref[1]) < 0).any() and (np.asarray(ref[1]) > 0).any()


@pytest.mark.parametrize("probe", range(len(PROBES)))
def test_closest_point_on_box_degenerate(probe):
    normal, sdist, surf = tc.closest_point_on_box(torch.tensor(PROBES[probe]),
                                                  torch.full((3,), 0.0325))
    assert bool(torch.isfinite(normal).all())
    assert abs(float(torch.linalg.vector_norm(normal)) - 1.0) < 1e-5
    assert bool(torch.isfinite(sdist)) and bool(torch.isfinite(surf).all())


def test_solve_contact_normal_and_friction():
    rng = _rng(3)
    u, tgt, lam = (rng.uniform(-1, 1, N).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.05, 2.0, N).astype(np.float32)
    mu = rng.uniform(0.0, 0.5, N).astype(np.float32)
    lam_n = np.abs(lam)
    for ref, port in ((jc.solve_contact_normal(*map(jnp.asarray, (u, tgt, w, lam_n))),
                       tc.solve_contact_normal(*map(_t, (u, tgt, w, lam_n)))),
                      (jc.solve_contact_friction(*map(jnp.asarray, (u, w, lam, mu))),
                       tc.solve_contact_friction(*map(_t, (u, w, lam, mu))))):
        for a, b in zip(ref, port):
            assert max_diff(a, b) < TOL


@pytest.mark.parametrize("bias_cap", [None, 2.0])
def test_contact_and_restitution_targets(bias_cap):
    rng = _rng(4)
    depth = rng.uniform(-0.01, 0.01, N).astype(np.float32)
    vn0 = rng.uniform(-2, 2, N).astype(np.float32)
    e = rng.uniform(0, 0.8, N).astype(np.float32)
    bounce = np.float32(0.5)
    cfg_j, cfg_t = jtypes.SolverConfig(), ttypes.SolverConfig()
    h = 0.005
    ref = jc.contact_target(jnp.asarray(depth), jnp.asarray(vn0), jnp.asarray(e),
                            jnp.asarray(bounce), h, cfg_j, bias_cap=bias_cap)
    port = tc.contact_target(_t(depth), _t(vn0), _t(e), torch.tensor(bounce), h, cfg_t,
                             bias_cap=bias_cap)
    assert max_diff(ref, port) < TOL
    ref_r = np.asarray(jc.restitution_target(jnp.asarray(depth), jnp.asarray(vn0),
                                             jnp.asarray(e), jnp.asarray(bounce), h))
    port_r = tc.restitution_target(_t(depth), _t(vn0), _t(e), torch.tensor(bounce), h).numpy()
    assert np.array_equal(np.isinf(ref_r), np.isinf(port_r))
    live = ~np.isinf(ref_r)
    assert live.any() and (~live).any()
    assert float(np.abs(ref_r[live] - port_r[live]).max()) < TOL
