"""The CUDA kernel's own arithmetic, compiled for the host.

csrc/physics_step.cu compiles as plain C++ (``g++ -x c++``), where
``leibniz_physics_step_host`` runs the kernel's phases (row build, sweep,
tip impulses) for one env after another. Built in float64
(``-DLG_REAL=double``) it is held to the plain PyTorch step
(``engine_v2.step_packed``) in float64 at 1e-11. The kernel sweeps stored
rows in mass-normalised velocities, stores 1/w where the plain version
divides by w, and sums each row's products in its own order, so the two
differ by float64 rounding that the contact solve amplifies: measured
9.8e-14 at most over these cases (a formula-for-formula version of the
kernel differed by 1.8e-15); the bound leaves 100x. This covers every branch the
card runs (both solvers, both object shapes, each gate off, per-env params
on both arena profiles, an N that is not a multiple of the card's 32-env
blocks); the card itself compares the float32 kernel with the plain version
in chip_smoke.py.

The kernel's NaN handling is held to the plain version's too: its max and
min propagate NaN as torch.maximum / jnp.maximum do, so a state the solve
blows up goes non-finite in the same fields in both, in float32 and float64,
and the plain version's fields are held to the JAX reference's.

The same build holds the fingertip kernel's per-env body
(``leibniz_fingertip_state_host``): in float64 it is held to
``fingertip_components_v2`` at TIP_TOL on all 39 components, over joint
states whose tip orientations reach each branch of the Shepperd selection,
and at q = 0.

The library is built once into build/leibnizgym_tpu_torch/host-<hash>/
under a file lock, so parallel test workers share one build. It is a test
tool: the port's CPU path never loads it.
"""

import ctypes
import fcntl
import hashlib
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leibnizgym_tpu_torch.models import trifinger as tf_model
from leibnizgym_tpu_torch.ops import cuda_engine
from leibnizgym_tpu_torch.ops.engine_v2 import pack_params, pack_state, step_packed
from leibnizgym_tpu_torch.ops.types import SolverConfig
from test_torch_common import (
    STATE_FIELDS, jax_inputs, jax_physics_step, random_physics, scene_arrays, torch_inputs)

torch.set_num_threads(1)

N = 16
TOL = 1e-11
FLAGS = ("-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC")
Consts64 = cuda_engine._consts_struct(ctypes.c_double)
Consts32 = cuda_engine._consts_struct(ctypes.c_float)
# the working type of a host build: its C name, ctypes struct of constants
REALS = {torch.float64: ("double", Consts64), torch.float32: ("float", Consts32)}


def _host_library(dtype=torch.float64) -> ctypes.CDLL:
    real, consts = REALS[dtype]
    flags = (*FLAGS, f"-DLG_REAL={real}")
    with open(cuda_engine.SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
    out_dir = os.path.join(cuda_engine.BUILD_ROOT, f"host-{digest}")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, f"libphysics_step_host_{real}.so")
    with open(os.path.join(out_dir, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(lib_path):
            tmp = f"{lib_path}.tmp{os.getpid()}"
            proc = subprocess.run(["g++", *flags, "-o", tmp, cuda_engine.SOURCE],
                                  capture_output=True, text=True, timeout=300)
            assert proc.returncode == 0, proc.stderr[-4000:]
            os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    ptr = ctypes.c_void_p
    lib.leibniz_physics_step_host.argtypes = [ptr] * 5 + [ctypes.c_int,
                                                          ctypes.POINTER(consts)]
    lib.leibniz_fingertip_state_host.argtypes = [ptr] * 3 + [ctypes.c_int,
                                                             ctypes.POINTER(consts)]
    assert lib.leibniz_consts_size() == ctypes.sizeof(consts)
    return lib


@pytest.fixture(scope="module")
def host_lib():
    return _host_library()


SOLVERS = {
    "pgs_s2_i4": dict(solver_type=0, substeps=2, solver_iterations=4),
    "tgs_s4_i8": dict(solver_type=1, substeps=4, solver_iterations=8),
    **{f"tgs_no_{g}": dict(solver_type=1, substeps=2, solver_iterations=4,
                           **{f"enable_{g}": False})
       for g in ("cube_wall", "tip_ground", "tip_wall", "link_cube", "torsion")},
}


@pytest.mark.parametrize("shape", ["box", "sphere"])
@pytest.mark.parametrize("case", sorted(SOLVERS))
def test_host_kernel_matches_plain(host_lib, case, shape):
    cfg = SolverConfig(object_shape=int(shape == "sphere"), **SOLVERS[case])
    state, tau, scene = torch_inputs(random_physics(N, 21),
                                     scene_arrays(N, 22, shape=shape, per_env=True),
                                     torch.float64)
    s31, p40, t9 = pack_state(state), pack_params(scene, N), tau.T.contiguous()
    ref, ref_imp = step_packed(s31, p40, t9, cfg, 0.02)
    out = torch.empty_like(s31)
    imp = torch.empty_like(ref_imp)
    host_lib.leibniz_physics_step_host(
        s31.data_ptr(), p40.data_ptr(), t9.data_ptr(), out.data_ptr(), imp.data_ptr(), N,
        ctypes.byref(cuda_engine.kernel_consts(cfg, 0.02, Consts64)))
    assert float((out - ref).abs().max()) < TOL
    assert float((imp - ref_imp).abs().max()) < TOL
    # the case is not vacuous: contacts moved the state away from free flight
    assert np.isfinite(out.numpy()).all() and float(imp.abs().max()) > 0.0


@pytest.mark.parametrize("shape", ["box", "sphere"])
@pytest.mark.parametrize("case", ["pgs_s2_i4", "tgs_s4_i8"])
def test_host_kernel_matches_plain_on_dr_scenes(host_lib, case, shape):
    """Full domain randomization as the env draws it: per-env cube size
    (half extents) with inertia scaled by mass * size^2, link masses, one
    friction scale on every pair, restitution up to 0.8; cone arena on even
    envs."""
    from leibnizgym_tpu_torch import dr as tdr
    from leibnizgym_tpu_torch.ops.types import SceneParams

    cfg = SolverConfig(object_shape=int(shape == "sphere"), **SOLVERS[case])
    state, tau, _ = torch_inputs(random_physics(N, 31), scene_arrays(N, 32, shape=shape),
                                 torch.float64)
    base = SceneParams.default(object_shape=shape, dtype=torch.float64)
    u = torch.as_tensor(np.random.default_rng(33).random((N, 7)))
    scene = tdr.sample_scene_params_from_uniform(u, base)
    scene = scene.replace(**{k: v.clone() for k, v in scene.fields().items()})
    scene.wall_radius[::2] = tf_model.WALL_CONE_BASE_RADIUS
    scene.wall_slope[::2] = tf_model.WALL_CONE_SLOPE
    scene.wall_knee_z[::2] = tf_model.WALL_CONE_KNEE_Z
    assert float(scene.cube_half_extents[:, 0].std()) > 0
    s31, p40, t9 = pack_state(state), pack_params(scene, N), tau.T.contiguous()
    ref, ref_imp = step_packed(s31, p40, t9, cfg, 0.02)
    out = torch.empty_like(s31)
    imp = torch.empty_like(ref_imp)
    host_lib.leibniz_physics_step_host(
        s31.data_ptr(), p40.data_ptr(), t9.data_ptr(), out.data_ptr(), imp.data_ptr(), N,
        ctypes.byref(cuda_engine.kernel_consts(cfg, 0.02, Consts64)))
    assert float((out - ref).abs().max()) < TOL
    assert float((imp - ref_imp).abs().max()) < TOL
    assert float(imp.abs().max()) > 0.0


@pytest.mark.parametrize("case", ["pgs_s2_i4", "tgs_s4_i8"])
def test_host_kernel_matches_plain_at_a_ragged_n(host_lib, case):
    """37 envs: one full block of 32 and a ragged one of 5 on the card; on
    the host every env runs the same phases."""
    n = 37
    cfg = SolverConfig(**SOLVERS[case])
    state, tau, scene = torch_inputs(random_physics(n, 41),
                                     scene_arrays(n, 42, per_env=True), torch.float64)
    s31, p40, t9 = pack_state(state), pack_params(scene, n), tau.T.contiguous()
    ref, ref_imp = step_packed(s31, p40, t9, cfg, 0.02)
    out = torch.empty_like(s31)
    imp = torch.empty_like(ref_imp)
    host_lib.leibniz_physics_step_host(
        s31.data_ptr(), p40.data_ptr(), t9.data_ptr(), out.data_ptr(), imp.data_ptr(), n,
        ctypes.byref(cuda_engine.kernel_consts(cfg, 0.02, Consts64)))
    assert float((out - ref).abs().max()) < TOL
    assert float((imp - ref_imp).abs().max()) < TOL
    assert float(imp.abs().max()) > 0.0


def test_kernel_consts_follow_the_robot_tables():
    cfg = SolverConfig(substeps=4, solver_iterations=8, solver_type=1)
    k = cuda_engine.kernel_consts(cfg, 0.02, Consts64)
    assert list(k.jlow) == [float(x) for x in cfg.joint_limit_lower]
    assert list(k.jhigh) == [float(x) for x in cfg.joint_limit_upper]
    assert k.h == 0.02 / 4 and k.h_it == 0.02 / 4 / 8
    assert k.baum_over_h == cfg.baumgarte / (0.02 / 4)
    assert list(k.sample_frac) == [float(f) for f, _ in tf_model.LOWER_LINK_SAMPLES]
    assert (k.substeps, k.solver_iterations, k.solver_type, k.object_shape) == (4, 8, 1, 0)


NAN_ENV = 3
# a cube velocity whose square overflows the working type
POISON = {torch.float32: 1e30, torch.float64: 1e200}


def _poisoned(case, dtype, n=8):
    """Seeded inputs (numpy, then torch) with env NAN_ENV's cube flung at a
    velocity whose square overflows ``dtype``."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    phys = {k: v.astype(np_dtype) for k, v in random_physics(n, 21).items()}
    phys["cube_linvel"][NAN_ENV] = POISON[dtype]
    scene = scene_arrays(n, 22, per_env=True)
    state, tau, params = torch_inputs(phys, scene, dtype)
    packed = pack_state(state), pack_params(params, n), tau.T.contiguous()
    return phys, scene, packed, step_packed(*packed, SolverConfig(**SOLVERS[case]), 0.02)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["pgs_s2_i4", "tgs_s4_i8"])
def test_host_kernel_propagates_nan_as_plain(case, dtype):
    """The solve of the poisoned env goes to inf and NaN. The kernel's output
    and impulses go non-finite in exactly the rows and envs where the plain
    version's do: a kernel whose max / min dropped NaN (fmaxf / fminf) kept
    the finger rows 0-17 finite where the plain version's are NaN."""
    n = 8
    _, _, (s31, p40, t9), (ref, ref_imp) = _poisoned(case, dtype, n)
    out = torch.empty_like(s31)
    imp = torch.empty_like(ref_imp)
    _host_library(dtype).leibniz_physics_step_host(
        s31.data_ptr(), p40.data_ptr(), t9.data_ptr(), out.data_ptr(), imp.data_ptr(), n,
        ctypes.byref(cuda_engine.kernel_consts(SolverConfig(**SOLVERS[case]), 0.02,
                                               REALS[dtype][1])))
    bad = ~torch.isfinite(ref)
    ok = np.arange(n) != NAN_ENV
    # the case bites: the poisoned env blows up in every state row, no other does
    assert bad[:, NAN_ENV].all() and not bad[:, ok].any()
    assert torch.equal(~torch.isfinite(out), bad)
    assert torch.equal(~torch.isfinite(imp), ~torch.isfinite(ref_imp))
    # the healthy envs still agree with the plain version (float32: the
    # contact solve amplifies rounding, as chip_smoke.KERNEL_TOL allows)
    tol = TOL if dtype == torch.float64 else 1e-3
    assert float((out[:, ok] - ref[:, ok]).abs().max()) < tol
    assert float((imp[:, ok] - ref_imp[:, ok]).abs().max()) < tol


def test_plain_nan_fields_match_reference():
    """The plain version's non-finite elements are the JAX reference's
    (ops/engine_v2.py, vmapped physics_step_v2), field by field and env by
    env, on the poisoned state at the training setting in float32, the
    card's working type. (One JIT compile of the reference costs ~30 s, so
    one setting; the float64 and PGS masks are tied to the plain version by
    the test above.)"""
    from leibnizgym_tpu.ops import types as jtypes
    from leibnizgym_tpu_torch.ops.engine_v2 import unpack_state, wrench_from_impulses

    case = "tgs_s4_i8"
    phys, scene, _, (ref, ref_imp) = _poisoned(case, torch.float32)
    jstate, jwrench = jax.device_get(jax_physics_step(jtypes.SolverConfig(**SOLVERS[case]))(
        *jax_inputs(phys, scene, jnp.float32)))
    plain = unpack_state(ref)
    for name in STATE_FIELDS:
        jbad = ~np.isfinite(np.asarray(getattr(jstate, name)))
        assert jbad[NAN_ENV].all(), name
        np.testing.assert_array_equal(jbad, ~torch.isfinite(getattr(plain, name)).numpy(),
                                      err_msg=name)
    np.testing.assert_array_equal(~np.isfinite(np.asarray(jwrench)),
                                  ~torch.isfinite(wrench_from_impulses(ref_imp, 0.02)).numpy())


# The fingertip kernel and the plain version evaluate the same formulas in
# the same order; in float64 they differ by rounding alone (g++ may contract
# or reorder nothing here: no -ffast-math).
TIP_TOL = 1e-12
# Shepperd's selection in fingertip_components_v2 (engine_v2._quat_from_m3):
# 0 where the trace is positive, else 1, 2 or 3 where m00, m11 or m22 is the
# largest diagonal element
TIP_CASES = ["trace", "m00", "m11", "m22", "q_zero"]


def _tip_branches(q: torch.Tensor) -> torch.Tensor:
    """(N, 3) the selection each finger's world orientation takes, from the
    plain version's own matrices."""
    from leibnizgym_tpu_torch.ops.engine_v2 import _MOUNT_CS
    from leibnizgym_tpu_torch.ops.soa import m3_mul, m3_rot_x, m3_rot_y

    out = []
    for f in range(3):
        c = [torch.cos(q[:, 3 * f + j]) for j in range(3)]
        s = [torch.sin(q[:, 3 * f + j]) for j in range(3)]
        r3 = m3_mul(m3_mul(m3_rot_y(c[0], s[0]), m3_rot_x(c[1], s[1])), m3_rot_x(c[2], s[2]))
        mc, ms = _MOUNT_CS[f]
        m = m3_mul(((mc, -ms, 0.0), (ms, mc, 0.0), (0.0, 0.0, 1.0)), r3)
        d0, d1, d2 = m[0][0], m[1][1], m[2][2]
        out.append(torch.where(d0 + d1 + d2 > 0.0, 0, torch.where(
            (d0 > d1) & (d0 > d2), 1, torch.where(d1 > d2, 2, 3))))
    return torch.stack(out, 1)


def _tip_inputs(case: str, n: int = 16):
    """(n, 9) float64 joint positions and velocities: q = 0, or envs drawn
    over a full turn of every joint of which each has a finger in the
    case's branch."""
    rng = np.random.default_rng(51)
    qd = torch.as_tensor(rng.uniform(-3.0, 3.0, (n, 9)))
    if case == "q_zero":
        return torch.zeros((n, 9), dtype=torch.float64), qd
    pool = torch.as_tensor(rng.uniform(-np.pi, np.pi, (4096, 9)))
    hit = (_tip_branches(pool) == TIP_CASES.index(case)).any(1)
    assert int(hit.sum()) >= n, (case, int(hit.sum()))
    return pool[hit][:n], qd


@pytest.mark.parametrize("case", TIP_CASES)
def test_host_fingertip_matches_plain(host_lib, case):
    """All 39 components (per finger position, quaternion, linear and
    angular velocity) of the kernel's per-env body against
    ``fingertip_components_v2`` in float64."""
    from leibnizgym_tpu_torch.ops.engine_v2 import fingertip_components_v2

    q, qd = _tip_inputs(case)
    n = q.shape[0]
    if case != "q_zero":
        assert (_tip_branches(q) == TIP_CASES.index(case)).any(1).all()
    plain = fingertip_components_v2(tuple(q[:, i] for i in range(9)),
                                    tuple(qd[:, i] for i in range(9)))
    ref = torch.stack([c for finger in plain for part in finger for c in part])
    q9, qd9 = q.T.contiguous(), qd.T.contiguous()
    out = torch.empty((cuda_engine.TIP_ROWS, n), dtype=torch.float64)
    host_lib.leibniz_fingertip_state_host(
        q9.data_ptr(), qd9.data_ptr(), out.data_ptr(), n,
        ctypes.byref(cuda_engine.kernel_consts(SolverConfig(), 0.02, Consts64)))
    assert ref.shape == out.shape
    assert float((out - ref).abs().max()) < TIP_TOL
    # unit quaternions, tips off the origin, velocities not all zero
    quat = torch.stack([out[13 * f + 3: 13 * f + 7] for f in range(3)])
    assert float((quat.norm(dim=1) - 1.0).abs().max()) < 1e-12
    assert float(out[7:13].abs().max()) > 0.1
