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

The library is built once into build/leibnizgym_tpu_torch/host-<hash>/
under a file lock, so parallel test workers share one build. It is a test
tool: the port's CPU path never loads it.
"""

import ctypes
import fcntl
import hashlib
import os
import subprocess

import numpy as np
import pytest
import torch

from leibnizgym_tpu_torch.models import trifinger as tf_model
from leibnizgym_tpu_torch.ops import cuda_engine
from leibnizgym_tpu_torch.ops.engine_v2 import pack_params, pack_state, step_packed
from leibnizgym_tpu_torch.ops.types import SolverConfig
from test_torch_common import random_physics, scene_arrays, torch_inputs

torch.set_num_threads(1)

N = 16
TOL = 1e-11
FLAGS = ("-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-DLG_REAL=double")
Consts64 = cuda_engine._consts_struct(ctypes.c_double)


def _host_library() -> ctypes.CDLL:
    with open(cuda_engine.SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode()).hexdigest()[:16]
    out_dir = os.path.join(cuda_engine.BUILD_ROOT, f"host-{digest}")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libphysics_step_host64.so")
    with open(os.path.join(out_dir, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(lib_path):
            tmp = f"{lib_path}.tmp{os.getpid()}"
            proc = subprocess.run(["g++", *FLAGS, "-o", tmp, cuda_engine.SOURCE],
                                  capture_output=True, text=True, timeout=300)
            assert proc.returncode == 0, proc.stderr[-4000:]
            os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    ptr = ctypes.c_void_p
    lib.leibniz_physics_step_host.argtypes = [ptr] * 5 + [ctypes.c_int,
                                                          ctypes.POINTER(Consts64)]
    assert lib.leibniz_consts_size() == ctypes.sizeof(Consts64)
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
