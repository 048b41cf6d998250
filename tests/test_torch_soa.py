"""Port parity: the scalar-component helpers of ``ops/soa.py``.

Every helper of the JAX package's soa module against its PyTorch
counterpart on the same seeded float32 columns. Both sides evaluate the same
elementwise float32 expression in the same order; the tolerance 1e-6
covers the ulp-level differences of sqrt-based normalisation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leibnizgym_tpu.ops import soa as jsoa
from leibnizgym_tpu_torch.ops import soa as tsoa

torch.set_num_threads(1)

TOL = 1e-6
N = 64


def _cols(seed, k, lo=-2.0, hi=2.0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo, hi, N).astype(np.float32) for _ in range(k)]


def _both(cols):
    return tuple(jnp.asarray(c) for c in cols), tuple(torch.as_tensor(c) for c in cols)


def _flatten(x):
    if isinstance(x, (tuple, list)):
        return [y for item in x for y in _flatten(item)]
    return [x]


def _assert_same(jx, tx):
    jl, tl = _flatten(jx), _flatten(tx)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=TOL)


def _m3(flat):
    return tuple(tuple(flat[3 * i + j] for j in range(3)) for i in range(3))


def _spd(seed):
    """Column-wise SPD mat3s: A A^T + I."""
    a = _cols(seed, 9)
    m = np.stack(a, -1).reshape(N, 3, 3)
    spd = m @ np.transpose(m, (0, 2, 1)) + np.eye(3)
    return [spd[:, i, j].astype(np.float32) for i in range(3) for j in range(3)]


V3_BINARY = ["v3_add", "v3_sub", "v3_dot", "v3_cross"]


@pytest.mark.parametrize("name", V3_BINARY)
def test_v3_binary(name):
    (ja, ta), (jb, tb) = _both(_cols(1, 3)), _both(_cols(2, 3))
    _assert_same(getattr(jsoa, name)(ja, jb), getattr(tsoa, name)(ta, tb))


def test_v3_scale_axpy_norm_where():
    (ja, ta), (jb, tb) = _both(_cols(3, 3)), _both(_cols(4, 3))
    (js,), (ts,) = _both(_cols(5, 1))
    _assert_same(jsoa.v3_scale(ja, js), tsoa.v3_scale(ta, ts))
    _assert_same(jsoa.v3_axpy(js, ja, jb), tsoa.v3_axpy(ts, ta, tb))
    _assert_same(jsoa.v3_norm_sq(ja), tsoa.v3_norm_sq(ta))
    _assert_same(jsoa.v3_norm(ja), tsoa.v3_norm(ta))
    mask = _cols(6, 1)[0] > 0
    _assert_same(jsoa.v3_where(jnp.asarray(mask), ja, jb),
                 tsoa.v3_where(torch.as_tensor(mask), ta, tb))
    _assert_same(jsoa.v3(*ja), tsoa.v3(*ta))


def test_m3_products():
    (ja, ta), (jb, tb) = _both(_cols(7, 9)), _both(_cols(8, 9))
    (jv, tv) = _both(_cols(9, 3))
    ma, mb, ta3, tb3 = _m3(ja), _m3(jb), _m3(ta), _m3(tb)
    _assert_same(jsoa.m3_matvec(ma, jv), tsoa.m3_matvec(ta3, tv))
    _assert_same(jsoa.m3_T_matvec(ma, jv), tsoa.m3_T_matvec(ta3, tv))
    _assert_same(jsoa.m3_mul(ma, mb), tsoa.m3_mul(ta3, tb3))
    _assert_same(jsoa.m3_T(ma), tsoa.m3_T(ta3))
    _assert_same(jsoa.m3(ma), tsoa.m3(ta3))


@pytest.mark.parametrize("name", ["m3_rot_x", "m3_rot_y", "m3_rot_z"])
def test_m3_rotations(name):
    (jang,), (tang,) = _both(_cols(10, 1))
    _assert_same(getattr(jsoa, name)(jnp.cos(jang), jnp.sin(jang)),
                 getattr(tsoa, name)(torch.as_tensor(np.cos(np.asarray(jang))),
                                     torch.as_tensor(np.sin(np.asarray(jang)))))


def test_constants():
    _assert_same(jsoa.v3_zero(), tsoa.v3_zero())
    _assert_same(jsoa.m3_identity(), tsoa.m3_identity())


def test_quaternions():
    (jq, tq), (jp, tp) = _both(_cols(11, 4)), _both(_cols(12, 4))
    (jw, tw) = _both(_cols(13, 3))
    _assert_same(jsoa.quat_to_m3(jq), tsoa.quat_to_m3(tq))
    _assert_same(jsoa.quat_mul4(jq, jp), tsoa.quat_mul4(tq, tp))
    _assert_same(jsoa.quat_normalize4(jq), tsoa.quat_normalize4(tq))
    _assert_same(jsoa.quat_integrate4(jq, jw, 0.005), tsoa.quat_integrate4(tq, tw, 0.005))


def test_cholesky():
    (jm, tm), (jb, tb) = _both(_spd(14)), _both(_cols(15, 3))
    jm3, tm3 = _m3(jm), _m3(tm)
    jf, tf = jsoa.chol3_factor(jm3), tsoa.chol3_factor(tm3)
    _assert_same(jf, tf)
    _assert_same(jsoa.chol3_solve_factored(jf, jb), tsoa.chol3_solve_factored(tf, tb))
    _assert_same(jsoa.chol3_solve(jm3, jb), tsoa.chol3_solve(tm3, tb))
