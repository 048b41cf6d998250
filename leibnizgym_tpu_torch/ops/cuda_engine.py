"""The physics step, the fingertip kinematics and the env step's MDP tail
as hand-written CUDA kernels (the first the counterpart of
``ops/pallas_engine.py``).

``csrc/physics_step.cu`` advances every env through one control step on the
component-major (C, N) layout, 32 envs per block (4 warps: the solver rows
are built once per substep by the team and swept by one lane per env):
state (31, N), params (40, N), tau (9, N) in; state (31, N) and tip impulse
sums (18, N) out. Its second kernel, ``fingertip_state_kernel``, computes
``engine_v2.fingertip_components_v2`` in one launch, one thread per env:
joint positions and velocities (9, N) each in (rows 0-8 and 9-17 of the
packed state, read in place), (39, N) out. Its third, ``mdp_tail_kernel``
(``mdp_tail_cuda``), computes what the env step computes after those two,
one thread per env: the goal's rotation, the rewards, the termination, the
counters, the observation, the asymmetric states, the history slots and
each env's column of the info means (``TAIL_INPUTS`` in, ``TAIL_OUTPUTS``
out), its constants a ``TailConsts`` the env builds once from its
``EnvStatic``. All three are built with nvcc at first use into
``build/leibnizgym_tpu_torch/<hash>/`` (the hash covers the source and the
flags), one library, loaded with ctypes.

Dispatch is by the tensors' device and nothing else: ``physics_step_cuda``
and ``fingertip_components_cuda`` on CUDA tensors launch their kernel (or
raise), on CPU tensors they run the plain PyTorch versions
``physics_step_plain`` and ``fingertip_components_v2``
(``ops/engine_v2.py``); the env calls ``mdp_tail_cuda`` on CUDA tensors
alone and keeps its plain tail for the CPU. ``launch_count`` counts the
launches of the three kernels, those inside CUDA graphs too: a graph captured through
``ops/capture.py``'s ``CountedGraph`` remembers how many launches it
captured, and each replay adds that many. The physics kernel's first
launch on a device raises its shared-memory cap there, so it must not fall
inside a capture (every capture warms up eagerly first); the constants
struct, which a graph keeps by value, is built once per ``(cfg, dt)``.

The physics kernel's bound is computed here the same way whatever
implements it: ``step_flops(cfg)`` counts the elementwise operations of one
control step of the plain version, which follows the reference's
``_substep_fields`` formula by formula (``tests/test_torch_cuda_bound.py``
holds it to a walk of the reference's jaxpr); ``step_bytes(n)`` counts each
input read once and each output written once; ``bound_ms`` is the larger of
the two over the card's published float32 and memory rates. The fingertip
and tail kernels are bound by their bytes, ``tip_bytes(n)`` and
``tail_bytes(n, consts)``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import functools
import hashlib
import math
import os
import re
import shutil
import subprocess
import time

import torch
from torch.overrides import TorchFunctionMode

from leibnizgym_tpu_torch.models import trifinger as tf_model
from leibnizgym_tpu_torch.ops import engine_v2 as ev2
from leibnizgym_tpu_torch.ops.engine_v2 import (
    PARAM_ROWS,
    STATE_ROWS,
    WRENCH_ROWS,
    pack_params,
    pack_state,
    unpack_state,
    wrench_from_impulses,
)
from leibnizgym_tpu_torch.ops.types import PhysicsState, SceneParams, SolverConfig

__all__ = [
    "pack_state", "pack_params", "physics_step_cuda", "physics_step_plain",
    "step_packed_cuda", "launch_count", "build", "build_info", "kernel_consts",
    "occupancy", "step_flops", "step_chain", "step_bytes",
    "bound_ms", "ENVS_PER_BLOCK", "fingertip_state_cuda", "fingertip_components_cuda",
    "TIP_ROWS", "tip_bytes", "mdp_tail_cuda", "tail_io", "TailTerm", "TailConsts",
    "TailIO", "TAIL_INPUTS", "TAIL_OUTPUTS", "TAIL_INFO_NAMES", "tail_bytes",
]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "physics_step.cu")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "leibnizgym_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# envs per block (LG_EPB in the source): one warp of envs; at 8192 envs that
# is 256 blocks, two per SM on 128 of the 132 SMs, all resident at once (see
# the source note)
ENVS_PER_BLOCK = 32
# the fingertip kernel's output rows: per finger position 3, quaternion 4,
# linear velocity 3, angular velocity 3 (fingertip_components_v2's order)
TIP_ROWS = 39

# NVIDIA H100 SXM, published: float32 outside the tensor cores, HBM3 rate,
# and dense bfloat16 on the tensor cores (bench.py's PPO matmul MFU)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

launch_count = 0

_lib = None
build_info: dict = {}


def _consts_struct(real):
    """Mirror of ``struct LgConsts`` in csrc/physics_step.cu, whose working
    type ``real`` is float on the GPU (a host test build may use double)."""
    r3 = real * 3
    i32 = ctypes.c_int32

    class LgConsts(ctypes.Structure):
        _fields_ = [
            ("o2", r3), ("o3", r3), ("tip", r3),
            ("mount_z", real), ("tip_off_z", real),
            ("base_masses", r3),
            ("coms", r3 * 3),
            ("inertias", (r3 * 3) * 3),
            ("mount_c", r3), ("mount_s", r3),
            ("sample_frac", real * 2), ("sample_radius", real * 2),
            ("jlow", real * 9), ("jhigh", real * 9),
            ("contact_slop", real), ("w_min", real),
            ("finger_bias_cap", real), ("max_cube_angvel", real),
            ("h", real), ("h_it", real), ("half_h", real), ("half_h_it", real),
            ("baum_over_h", real), ("tgs_over_h_it", real),
            ("substeps", i32), ("solver_iterations", i32),
            ("solver_type", i32), ("object_shape", i32),
            ("enable_cube_wall", i32), ("enable_tip_ground", i32),
            ("enable_tip_wall", i32), ("enable_link_cube", i32),
            ("enable_torsion", i32),
        ]

    return LgConsts


_KernelConsts = _consts_struct(ctypes.c_float)


def kernel_consts(cfg: SolverConfig, dt: float, struct=_KernelConsts):
    """The kernel's constants: robot tables (models/trifinger.py, through
    ops/engine_v2.py) and the SolverConfig fields. Python-double expressions
    of the reference (cfg.baumgarte / h, 0.5 * h, ...) are evaluated in
    double and rounded once, as JAX's weakly typed Python floats are."""
    samples = tf_model.LOWER_LINK_SAMPLES
    if len(samples) != 2:
        raise ValueError("physics_step.cu is built for 2 lower-link samples")
    h = dt / cfg.substeps
    h_it = h / cfg.solver_iterations
    k = struct()
    k.o2[:] = ev2._O2
    k.o3[:] = ev2._O3
    k.tip[:] = ev2._TIP
    k.mount_z = ev2._MOUNT_Z
    k.tip_off_z = ev2._TIP_OFF_Z
    k.base_masses[:] = ev2._BASE_MASSES
    for l in range(3):
        k.coms[l][:] = ev2._COMS[l]
        for i in range(3):
            k.inertias[l][i][:] = ev2._INERTIAS[l][i]
    k.mount_c[:] = [c for c, _ in ev2._MOUNT_CS]
    k.mount_s[:] = [s for _, s in ev2._MOUNT_CS]
    k.sample_frac[:] = [float(fr) for fr, _ in samples]
    k.sample_radius[:] = [float(r) for _, r in samples]
    k.jlow[:] = [float(x) for x in cfg.joint_limit_lower]
    k.jhigh[:] = [float(x) for x in cfg.joint_limit_upper]
    k.contact_slop = cfg.contact_slop
    k.w_min = cfg.w_min
    k.finger_bias_cap = cfg.finger_bias_cap
    k.max_cube_angvel = ev2._MAX_CUBE_ANGVEL
    k.h = h
    k.h_it = h_it
    k.half_h = 0.5 * h
    k.half_h_it = 0.5 * h_it
    k.baum_over_h = cfg.baumgarte / h
    k.tgs_over_h_it = cfg.tgs_bias / h_it
    k.substeps = cfg.substeps
    k.solver_iterations = cfg.solver_iterations
    k.solver_type = cfg.solver_type
    k.object_shape = cfg.object_shape
    k.enable_cube_wall = int(cfg.enable_cube_wall)
    k.enable_tip_ground = int(cfg.enable_tip_ground)
    k.enable_tip_wall = int(cfg.enable_tip_wall)
    k.enable_link_cube = int(cfg.enable_link_cube)
    k.enable_torsion = int(cfg.enable_torsion)
    return k


@functools.lru_cache(maxsize=64)
def _consts_for(cfg: SolverConfig, dt: float):
    """``kernel_consts(cfg, dt)``, built once per ``(cfg, dt)``; the launch
    reads it and does not write it."""
    return kernel_consts(cfg, dt)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")
    return path


def _parse_ptxas(log: str, kernel: str = "physics_step_kernel") -> dict:
    """Registers, spills and static shared memory of ``kernel`` from
    `-Xptxas -v` (the whole log where no entry function of that name is
    in it)."""
    entries = log.split("Compiling entry function '")[1:]
    log = next((e for e in entries if kernel in e.split("'", 1)[0]), log)
    info = {}
    m = re.search(r"Used (\d+) registers", log)
    if m:
        info["registers"] = int(m.group(1))
    m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                  r"(\d+) bytes spill loads", log)
    if m:
        info["stack_frame_bytes"] = int(m.group(1))
        info["spill_store_bytes"] = int(m.group(2))
        info["spill_load_bytes"] = int(m.group(3))
    m = re.search(r"(\d+) bytes smem", log)
    info["static_smem_bytes"] = int(m.group(1)) if m else 0
    return info


def build() -> ctypes.CDLL:
    """Build (once per source/flags hash) and load the kernel library of
    this checkout; its build record is ``build_info``."""
    global _lib, build_info
    if _lib is not None:
        return _lib
    with open(SOURCE, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = os.path.join(BUILD_ROOT, digest)
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libphysics_step.so")
    log_path = os.path.join(out_dir, "build.log")
    t0 = time.perf_counter()
    with open(os.path.join(out_dir, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(lib_path):
            tmp = lib_path + f".tmp{os.getpid()}"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            with open(log_path, "w") as f:
                f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
                )
            os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    ptr = ctypes.c_void_p
    lib.leibniz_physics_step.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ctypes.c_int, ctypes.POINTER(_KernelConsts), ptr,
    ]
    lib.leibniz_physics_step.restype = ctypes.c_int
    lib.leibniz_fingertip_state.argtypes = [
        ptr, ptr, ptr, ctypes.c_int, ctypes.POINTER(_KernelConsts), ptr,
    ]
    lib.leibniz_fingertip_state.restype = ctypes.c_int
    lib.leibniz_mdp_tail.argtypes = [ptr, ptr, ctypes.c_int, ctypes.c_int, ptr]
    lib.leibniz_mdp_tail.restype = ctypes.c_int
    lib.leibniz_consts_size.restype = ctypes.c_int
    if lib.leibniz_consts_size() != ctypes.sizeof(_KernelConsts):
        raise RuntimeError("LgConsts layout differs between physics_step.cu and Python")
    for which, struct in enumerate((TailTerm, TailConsts, TailIO)):
        if struct_layout(lib, which) != ctypes_layout(struct):
            raise RuntimeError(f"{struct.__name__} layout differs between physics_step.cu "
                               "and Python")
    with open(log_path) as f:
        log = f.read()
    build_info = dict(_parse_ptxas(log), seconds=time.perf_counter() - t0,
                      library=lib_path, log=log_path,
                      fingertip=_parse_ptxas(log, "fingertip_state_kernel"),
                      tail=_parse_ptxas(log, "mdp_tail_kernel"))
    _lib = lib
    return lib


def struct_layout(lib: ctypes.CDLL, which: int) -> tuple:
    """(size, ((name, offset, size), ...)) of struct ``which`` of the tail
    (0 ``LgTerm``, 1 ``LgTailConsts``, 2 ``LgTailIO``) as ``lib``'s build
    of csrc/physics_step.cu lays it out."""
    name, offset, size = ctypes.c_char_p(), ctypes.c_int(), ctypes.c_int()
    lib.leibniz_struct_field.argtypes = [ctypes.c_int, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_char_p),
                                         ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_int)]
    lib.leibniz_struct_field(which, -1, None, None, ctypes.byref(size))
    total, fields, i = size.value, [], 0
    while lib.leibniz_struct_field(which, i, ctypes.byref(name), ctypes.byref(offset),
                                   ctypes.byref(size)) == 0:
        fields.append((name.value.decode(), offset.value, size.value))
        i += 1
    return total, tuple(fields)


def ctypes_layout(struct) -> tuple:
    """``struct_layout``'s form of a ctypes mirror."""
    return ctypes.sizeof(struct), tuple(
        (name, getattr(struct, name).offset, getattr(struct, name).size)
        for name, *_ in struct._fields_)


def occupancy() -> dict:
    """Resident blocks per SM and dynamic shared memory per block of the
    kernel's launch (cudaOccupancyMaxActiveBlocksPerMultiprocessor, from the
    C entry ``leibniz_physics_step_occupancy``)."""
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = build().leibniz_physics_step_occupancy(ctypes.byref(blocks), ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"physics_step occupancy query failed: CUDA error {rc}")
    return {"blocks_per_sm": blocks.value, "dynamic_smem_bytes": smem.value,
            "envs_per_block": ENVS_PER_BLOCK}


def _check_tensor(name: str, t: torch.Tensor, dtype, shape: tuple, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def _check(name: str, t: torch.Tensor, rows: int, n: int, device):
    _check_tensor(name, t, torch.float32, (rows, n), device)


def step_packed_cuda(state31: torch.Tensor, params40: torch.Tensor,
                     tau9: torch.Tensor, cfg: SolverConfig, dt: float):
    """Launch the kernel on packed CUDA tensors; returns (state' (31, N),
    impulse sums (18, N)). Raises on anything the kernel does not take."""
    global launch_count
    device = state31.device
    if device.type != "cuda":
        raise ValueError(f"step_packed_cuda needs CUDA tensors, got {device}")
    n = state31.shape[1]
    _check("state", state31, STATE_ROWS, n, device)
    _check("params", params40, PARAM_ROWS, n, device)
    _check("tau", tau9, 9, n, device)
    lib = build()
    out = torch.empty_like(state31)
    wrench = torch.empty((WRENCH_ROWS, n), dtype=torch.float32, device=device)
    consts = _consts_for(cfg, dt)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.leibniz_physics_step(
            state31.data_ptr(), params40.data_ptr(), tau9.data_ptr(),
            out.data_ptr(), wrench.data_ptr(), n, ctypes.byref(consts), stream,
        )
    if rc != 0:
        raise RuntimeError(f"physics_step kernel launch failed: CUDA error {rc}")
    launch_count += 1
    return out, wrench


def physics_step_cuda(state: PhysicsState, tau: torch.Tensor, params: SceneParams,
                      cfg: SolverConfig, dt: float = 0.02):
    """Batched physics step through the CUDA kernel: state (N,)-batched, tau
    (N, 9), params batched or broadcastable. Returns (new_state, tip_wrench
    (N, 3, 6)). CPU tensors take the plain version instead."""
    if not state.q.is_cuda:
        return physics_step_plain(state, tau, params, cfg, dt)
    n = state.q.shape[0]
    out, imp = step_packed_cuda(pack_state(state), pack_params(params, n),
                                tau.T.contiguous(), cfg, dt)
    return unpack_state(out), wrench_from_impulses(imp, dt)


def physics_step_plain(state: PhysicsState, tau: torch.Tensor, params: SceneParams,
                       cfg: SolverConfig, dt: float = 0.02):
    """The same step as ``physics_step_cuda`` in plain PyTorch, on any device."""
    return ev2.physics_step_v2(state, tau, params, cfg, dt)


@functools.lru_cache(maxsize=1)
def _tip_consts():
    """The fingertip kernel's constants. It reads the robot tables alone
    (``o2``, ``o3``, ``tip``, ``mount_z``, ``mount_c``, ``mount_s``); the
    solver fields are the default config's, unread."""
    return kernel_consts(SolverConfig(), 0.02)


def fingertip_state_cuda(q9: torch.Tensor, qd9: torch.Tensor) -> torch.Tensor:
    """Launch the fingertip kernel on (9, N) rows of joint positions and
    velocities (CUDA, float32, contiguous); returns (TIP_ROWS, N): finger by
    finger position 3, quaternion 4, linear velocity 3, angular velocity 3.
    Raises on anything the kernel does not take."""
    global launch_count
    device = q9.device
    if device.type != "cuda":
        raise ValueError(f"fingertip_state_cuda needs CUDA tensors, got {device}")
    n = q9.shape[-1]
    _check("q", q9, 9, n, device)
    _check("qd", qd9, 9, n, device)
    lib = build()
    out = torch.empty((TIP_ROWS, n), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.leibniz_fingertip_state(q9.data_ptr(), qd9.data_ptr(), out.data_ptr(), n,
                                         ctypes.byref(_tip_consts()), stream)
    if rc != 0:
        raise RuntimeError(f"fingertip_state kernel launch failed: CUDA error {rc}")
    launch_count += 1
    return out


def fingertip_components_cuda(q: torch.Tensor, qd: torch.Tensor):
    """The fingertips' components from (N, 9) joint positions and
    velocities, as ``fingertip_components_v2`` returns them: a 3-tuple (one
    per finger) of (pos3, quat4, linvel3, angvel3) tuples of (N,) columns.
    CUDA tensors take one launch of the kernel, whose output rows are the
    columns (``q.T`` of the packed state's views is read in place); CPU
    tensors take ``fingertip_components_v2``."""
    if not q.is_cuda:
        return ev2.fingertip_components_v2(tuple(q[:, i] for i in range(9)),
                                           tuple(qd[:, i] for i in range(9)))
    out = fingertip_state_cuda(q.T.contiguous(), qd.T.contiguous())
    rows = TIP_ROWS // 3
    return tuple(
        tuple(tuple(out[rows * f + a + i] for i in range(k))
              for a, k in ((0, 3), (3, 4), (7, 3), (10, 3)))
        for f in range(3)
    )


# ---------------------------------------------------------------------------
# The MDP tail: rewards, termination, observation and states of a step
# ---------------------------------------------------------------------------

# reward terms in the kernel's struct (rewards.REWARD_TERM_NAMES' count)
TAIL_TERMS = 7
# the info block's rows past the reward terms' (the .cu's LG_INFO_* rows):
# each env's column of an info mean or count
TAIL_INFO_NAMES = ("pos_dist", "ori_dist", "strict", "successes", "pos_count", "ori_count")
TAIL_INFO_ROWS = TAIL_TERMS + len(TAIL_INFO_NAMES)


def _tail_structs(real):
    """Mirrors of ``struct LgTerm`` and ``struct LgTailConsts`` in
    csrc/physics_step.cu, whose working type ``real`` is float on the GPU
    (a host test build may use double)."""
    i32 = ctypes.c_int32

    class LgTerm(ctypes.Structure):
        _fields_ = [(name, real) for name in (
            "weight", "epsilon", "scale", "sched_start", "sched_end", "weight_dt",
            "sched_span", "inv_p", "kernel_scale")] + [
            (name, i32) for name in ("activate", "norm_p", "sched_enabled")]

    class LgTailConsts(ctypes.Structure):
        _fields_ = [("terms", LgTerm * TAIL_TERMS)] + [(name, real) for name in (
            "dt", "goal_half_h", "obs_noise_std", "termination_bonus",
            "position_tolerance", "orientation_tolerance", "position_tolerance_init",
            "orientation_tolerance_init", "position_tolerance_span",
            "orientation_tolerance_span", "tolerance_anneal_frames")] + [
            (name, i32) for name in (
                "envs_counted", "control_decimation", "episode_length", "task_difficulty",
                "termination_activate", "curriculum_success_gated", "dones_and",
                "normalize_obs", "asymmetric_obs", "use_keypoint_obs", "goal_rotation_active",
                "action_dim", "obs_dim", "state_dim")]

    return LgTerm, LgTailConsts


TailTerm, TailConsts = _tail_structs(ctypes.c_float)

_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
# The tail's tensors in the order of ``struct LgTailIO``: name, dtype,
# shape ("n" envs; "obs", "state", "act": the widths of the constants),
# and whether a reset reads or writes it. "noise" may be None.
TAIL_INPUTS = (
    ("state", _F32, (STATE_ROWS, "n"), True),
    ("tips", _F32, (TIP_ROWS, "n"), True),
    ("goal_pose", _F32, (7, "n"), True),
    ("goal_angvel", _F32, (3, "n"), False),
    ("tip_prev", _F32, (9, "n"), False),
    ("obj_prev", _F32, (7, "n"), False),
    ("half_extents", _F32, ("n", 3), True),
    ("action", _F32, ("n", "act"), True),
    ("torque", _F32, ("n", 9), False),
    ("wrench", _F32, ("n", 18), False),
    ("noise", _F32, ("n", "obs"), True),
    ("obs_low", _F32, ("obs",), True),
    ("obs_high", _F32, ("obs",), True),
    ("state_low", _F32, ("state",), False),
    ("state_high", _F32, ("state",), False),
    ("level", _F32, (), False),
    ("frames", _I32, (), True),
    ("reset_buf", _BOOL, ("n",), False),
    ("goal_reset_buf", _BOOL, ("n",), False),
    ("steps_count", _I32, ("n",), False),
    ("successes", _I32, ("n",), False),
)
TAIL_OUTPUTS = (
    ("obs", _F32, ("n", "obs"), True),
    ("states", _F32, ("n", "state"), False),
    ("reward", _F32, ("n",), False),
    ("dones", _BOOL, ("n",), False),
    ("reset_buf", _BOOL, ("n",), False),
    ("goal_reset_buf", _BOOL, ("n",), False),
    ("steps_count", _I32, ("n",), False),
    ("successes", _I32, ("n",), False),
    ("tip_prev", _F32, (9, "n"), True),
    ("obj_prev", _F32, (7, "n"), True),
    ("goal_pose", _F32, (7, "n"), False),
    ("frames", _I32, (), True),
    ("info", _F32, (TAIL_INFO_ROWS, "n"), False),
    ("scalars", _F32, (3,), False),
)


class TailIO(ctypes.Structure):
    """Mirror of ``struct LgTailIO``: the inputs' pointers, then the
    outputs' as ``out_<name>``."""
    _fields_ = ([(name, ctypes.c_void_p) for name, *_ in TAIL_INPUTS]
                + [(f"out_{name}", ctypes.c_void_p) for name, *_ in TAIL_OUTPUTS])


def _tail_shape(shape: tuple, consts, n: int) -> tuple:
    """A ``TAIL_INPUTS`` / ``TAIL_OUTPUTS`` shape at ``n`` envs and the
    constants' widths."""
    dims = {"n": n, "obs": consts.obs_dim, "state": consts.state_dim,
            "act": consts.action_dim}
    return tuple(dims.get(d, d) for d in shape)


def tail_io(consts, inputs: dict, reset: bool = False, real=torch.float32):
    """(``TailIO``, outputs by name) of one tail launch: each input of
    ``TAIL_INPUTS`` that the launch reads (a reset those it reads; "noise"
    where the env adds observation noise) checked and its pointer set, each
    output allocated with ``torch.empty`` on the inputs' device. ``real``
    is the working type of the build (float32 on the card)."""
    device, n = inputs["state"].device, inputs["state"].shape[-1]

    def spec(dtype, shape):
        return real if dtype == _F32 else dtype, _tail_shape(shape, consts, n)

    io = TailIO()
    for name, dtype, shape, in_reset in TAIL_INPUTS:
        if (reset and not in_reset) or (name == "noise" and consts.obs_noise_std <= 0.0):
            continue
        t = inputs.get(name)
        if t is None:
            raise ValueError(f"mdp_tail: missing input {name!r}")
        _check_tensor(name, t, *spec(dtype, shape), device)
        setattr(io, name, t.data_ptr())
    out = {}
    for name, dtype, shape, in_reset in TAIL_OUTPUTS:
        if in_reset or not reset:
            dtype, shape = spec(dtype, shape)
            out[name] = torch.empty(shape, dtype=dtype, device=device)
            setattr(io, f"out_{name}", out[name].data_ptr())
    return io, out


def mdp_tail_cuda(consts, inputs: dict, reset: bool = False) -> dict:
    """Launch the MDP tail kernel: ``consts`` a ``TailConsts`` (the env's,
    ``env.tail_consts``), ``inputs`` the CUDA tensors of ``TAIL_INPUTS``
    by name (``tail_io``). Returns the ``TAIL_OUTPUTS`` tensors by name (a
    reset's alone). Raises on anything the kernel does not take."""
    global launch_count
    device = inputs["state"].device
    if device.type != "cuda":
        raise ValueError(f"mdp_tail_cuda needs CUDA tensors, got {device}")
    io, out = tail_io(consts, inputs, reset)
    lib = build()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.leibniz_mdp_tail(ctypes.byref(consts), ctypes.byref(io),
                                  inputs["state"].shape[-1], int(reset), stream)
    if rc != 0:
        raise RuntimeError(f"mdp_tail kernel launch failed: CUDA error {rc}")
    launch_count += 1
    return out


def tail_bytes(n: int, consts) -> int:
    """Bytes one tail launch of a step must move for n envs, each input
    read once and each output written once (``TAIL_INPUTS``,
    ``TAIL_OUTPUTS`` at the constants' widths, the noise where it is on,
    the scales and scalars once; ~1.7 KB an env at D4 + DR): they bound it,
    its ~1,500 elementwise operations an env at D4 + DR (the plain tail's,
    ``_OpCounter``'s count; ~300 at D1) taking a twentieth of their time at
    the card's float32 rate."""
    return sum(math.prod(_tail_shape(shape, consts, n)) * (1 if dtype == _BOOL else 4)
               for name, dtype, shape, _ in TAIL_INPUTS + TAIL_OUTPUTS
               if name != "noise" or consts.obs_noise_std > 0.0)


# ---------------------------------------------------------------------------
# The bound: operations and bytes of one control step
# ---------------------------------------------------------------------------

# One elementwise operation each, whatever the operand types (the jaxpr
# primitives add, sub, mul, div, neg, max, min, select_n, comparisons,
# and/or, sqrt, sin, cos, abs, sign of the reference).
_ELEMENTWISE = frozenset({
    "__add__", "__radd__", "__sub__", "__rsub__", "__mul__", "__rmul__",
    "__truediv__", "__rtruediv__", "__rdiv__", "__neg__", "__abs__", "gt", "lt",
    "ge", "le", "eq", "ne", "__and__", "__or__", "__invert__",
    "add", "sub", "mul", "div", "neg", "sqrt", "sin", "cos", "abs", "sign",
    "maximum", "minimum", "clamp_min", "clamp_max", "where", "reciprocal",
})


class _OpCounter(TorchFunctionMode):
    """Counts elementwise operations and the longest chain of dependent ones
    (each output one deeper than its deepest tensor input)."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.depth = {}
        self.keep = []

    def _in_depth(self, args) -> int:
        d = 0
        for a in args:
            if isinstance(a, torch.Tensor):
                d = max(d, self.depth.get(id(a), 0))
            elif isinstance(a, (tuple, list)):
                d = max(d, self._in_depth(a))
        return d

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", "")
        if isinstance(out, torch.Tensor):
            d = self._in_depth(args)
            if name in _ELEMENTWISE:
                self.ops += 1
                d += 1
            self.depth[id(out)] = d
            self.keep.append(out)
        return out


@functools.lru_cache(maxsize=64)
def _substep_counts(cfg: SolverConfig) -> tuple:
    """(operations, longest dependent chain) of one ``_substep_fields`` call
    of the plain version, traced on one env."""
    g = torch.Generator().manual_seed(0)
    state = torch.rand((STATE_ROWS, 1), generator=g)
    params = pack_params(SceneParams.default(
        object_shape="sphere" if cfg.object_shape == 1 else "box"), 1)
    tau = torch.rand((9, 1), generator=g)
    rows, prm = ev2.rows_namespace(state, params)
    with _OpCounter() as counter:
        out = ev2._substep_fields(rows, tuple(tau[i] for i in range(9)), prm, cfg,
                                  0.02 / cfg.substeps)
    flat = [t for part in out for t in (part if isinstance(part[0], torch.Tensor)
                                        else [x for v in part for x in v])]
    return counter.ops, max(counter.depth.get(id(t), 0) for t in flat)


def step_flops(cfg: SolverConfig) -> int:
    """Elementwise operations per env of one control step: ``substeps`` times
    one ``_substep_fields`` (its sweep ``solver_iterations`` times), each
    primitive 1 op (divides, square roots, sin/cos, max/min, selects and
    comparisons included). Data-independent: the step has no early exit."""
    return cfg.substeps * _substep_counts(dataclasses.replace(cfg))[0]


def step_chain(cfg: SolverConfig) -> int:
    """Dependent operations on one env's longest chain through one control
    step, as the plain version (and the reference) associate them."""
    return cfg.substeps * _substep_counts(dataclasses.replace(cfg))[1]


def step_bytes(n: int) -> int:
    """Bytes one control step must move for n envs: state (31), params (40)
    and tau (9) read once, state (31) and impulse sums (18) written once,
    float32."""
    return 4 * n * (STATE_ROWS + PARAM_ROWS + 9 + STATE_ROWS + WRENCH_ROWS)


def tip_bytes(n: int) -> int:
    """Bytes one fingertip launch must move for n envs: joint positions and
    velocities (9 + 9) read once, TIP_ROWS written once, float32 (228 an
    env). They bound it: its ~1,150 operations an env take a quarter of
    their time at the card's float32 rate."""
    return 4 * n * (9 + 9 + TIP_ROWS)


def bound_ms(cfg: SolverConfig, n: int) -> tuple:
    """(least time in ms, "operations" or "bytes"): the larger of the ops
    over the published float32 rate and the bytes over the memory rate of an
    H100 SXM at its full 700 W."""
    t_ops = step_flops(cfg) * n / PEAK_FP32_FLOPS * 1e3
    t_bytes = step_bytes(n) / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
