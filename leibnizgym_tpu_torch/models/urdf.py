"""Python bindings for the URDF parser + kinematic-chain assembly
(counterpart of ``leibnizgym_tpu/models/urdf.py``).

Parses any URDF in the robot_properties_fingers family into flat model
tables. The C++ parser is the port's own copy,
``leibnizgym_tpu_torch/csrc/urdf_parser.cpp`` (held byte-equal to the JAX
package's ``native/urdf_parser.cpp`` by ``tests/test_torch_copies.py``). It
is built with g++ at first use into
``build/leibnizgym_tpu_torch/urdf-<hash>/`` of this checkout, under a file
lock so parallel processes share one build, and loaded with ctypes; the
built-in trifingerpro constants in ``models.trifinger`` remain the
validated defaults (tests cross-check the parser against them).
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import hashlib
import os
import subprocess
from typing import Dict, List

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "urdf_parser.cpp")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "leibnizgym_tpu_torch")
# the flags of native/Makefile
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-Wall")


class _UrdfLink(ctypes.Structure):
    _fields_ = [
        ("name", ctypes.c_char * 128),
        ("mass", ctypes.c_double),
        ("com", ctypes.c_double * 3),
        ("com_rpy", ctypes.c_double * 3),
        ("inertia", ctypes.c_double * 6),
        ("density", ctypes.c_double),
        ("geom_type", ctypes.c_int),
        ("geom_size", ctypes.c_double * 3),
        ("num_collisions", ctypes.c_int),
    ]


class _UrdfJoint(ctypes.Structure):
    _fields_ = [
        ("name", ctypes.c_char * 128),
        ("parent", ctypes.c_char * 128),
        ("child", ctypes.c_char * 128),
        ("type", ctypes.c_int),
        ("origin_xyz", ctypes.c_double * 3),
        ("origin_rpy", ctypes.c_double * 3),
        ("axis", ctypes.c_double * 3),
        ("limit_lower", ctypes.c_double),
        ("limit_upper", ctypes.c_double),
        ("limit_effort", ctypes.c_double),
        ("limit_velocity", ctypes.c_double),
    ]


class _UrdfModel(ctypes.Structure):
    _fields_ = [
        ("robot_name", ctypes.c_char * 128),
        ("num_links", ctypes.c_int),
        ("num_joints", ctypes.c_int),
        ("links", ctypes.POINTER(_UrdfLink)),
        ("joints", ctypes.POINTER(_UrdfJoint)),
    ]


_lib = None


def _build() -> str:
    """Compile the parser once per source/flags hash; returns the library path."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out_dir = os.path.join(BUILD_ROOT, f"urdf-{digest}")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libleibniz_urdf.so")
    with open(os.path.join(out_dir, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(lib_path):
            tmp = f"{lib_path}.tmp{os.getpid()}"
            proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
            os.replace(tmp, lib_path)
    return lib_path


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_build())
    lib.urdf_parse_file.restype = ctypes.POINTER(_UrdfModel)
    lib.urdf_parse_file.argtypes = [ctypes.c_char_p]
    lib.urdf_free.argtypes = [ctypes.POINTER(_UrdfModel)]
    lib.urdf_free.restype = None
    _lib = lib
    return lib


@dataclasses.dataclass
class Link:
    name: str
    mass: float
    com: np.ndarray
    com_rpy: np.ndarray
    inertia_diag: np.ndarray  # (ixx, iyy, izz)
    inertia_off: np.ndarray  # (ixy, ixz, iyz)
    density: float
    geom_type: int  # 0 none, 1 box, 2 sphere, 3 cylinder, 4 mesh
    geom_size: np.ndarray
    num_collisions: int


@dataclasses.dataclass
class Joint:
    name: str
    parent: str
    child: str
    type: str  # fixed | revolute | continuous | prismatic | other
    origin_xyz: np.ndarray
    origin_rpy: np.ndarray
    axis: np.ndarray
    lower: float
    upper: float
    effort: float
    velocity: float


_JOINT_TYPES = {0: "fixed", 1: "revolute", 2: "continuous", 3: "prismatic", 4: "other"}


@dataclasses.dataclass
class UrdfModel:
    name: str
    links: Dict[str, Link]
    joints: List[Joint]

    def child_joints(self, link_name: str) -> List[Joint]:
        return [j for j in self.joints if j.parent == link_name]

    def chain_to(self, tip_link: str) -> List[Joint]:
        """Joint path from the root to ``tip_link``."""
        by_child = {j.child: j for j in self.joints}
        path: List[Joint] = []
        cur = tip_link
        while cur in by_child:
            j = by_child[cur]
            path.append(j)
            cur = j.parent
        return list(reversed(path))


def parse_urdf(path: str) -> UrdfModel:
    """Parse a URDF file via the native library."""
    lib = _load_lib()
    ptr = lib.urdf_parse_file(os.fsencode(os.path.abspath(path)))
    if not ptr:
        raise FileNotFoundError(f"failed to parse URDF: {path}")
    try:
        m = ptr.contents
        links: Dict[str, Link] = {}
        for i in range(m.num_links):
            l = m.links[i]
            name = l.name.decode()
            links[name] = Link(
                name=name,
                mass=float(l.mass),
                com=np.array(l.com[:]),
                com_rpy=np.array(l.com_rpy[:]),
                inertia_diag=np.array(l.inertia[0:3]),
                inertia_off=np.array(l.inertia[3:6]),
                density=float(l.density),
                geom_type=int(l.geom_type),
                geom_size=np.array(l.geom_size[:]),
                num_collisions=int(l.num_collisions),
            )
        joints: List[Joint] = []
        for i in range(m.num_joints):
            j = m.joints[i]
            joints.append(
                Joint(
                    name=j.name.decode(),
                    parent=j.parent.decode(),
                    child=j.child.decode(),
                    type=_JOINT_TYPES.get(int(j.type), "other"),
                    origin_xyz=np.array(j.origin_xyz[:]),
                    origin_rpy=np.array(j.origin_rpy[:]),
                    axis=np.array(j.axis[:]),
                    lower=float(j.limit_lower),
                    upper=float(j.limit_upper),
                    effort=float(j.limit_effort),
                    velocity=float(j.limit_velocity),
                )
            )
        return UrdfModel(name=m.robot_name.decode(), links=links, joints=joints)
    finally:
        lib.urdf_free(ptr)


def export_trifinger_urdf(path: str):
    """Write a clean-room TriFinger URDF generated from the built-in model
    tables (models.trifinger) — the framework's own asset, also used as a
    parser round-trip fixture. Collision geometry uses the analytic
    primitives of the TPU engine (tip spheres), not meshes."""
    from leibnizgym_tpu_torch.models import trifinger as tf

    def fmt(v):
        return " ".join(f"{float(x):.10g}" for x in v)

    lines = ['<?xml version="1.0"?>', '<robot name="trifinger_tpu">']
    lines += [
        '  <link name="base_link"/>',
        '  <link name="upper_holder_link"/>',
        '  <joint name="base_to_upper_holder_joint" type="fixed">',
        '    <parent link="base_link"/>',
        '    <child link="upper_holder_link"/>',
        f'    <origin xyz="0 0 {tf.MOUNT_HEIGHT}"/>',
        "  </joint>",
    ]
    link_names = ["upper", "middle", "lower"]
    for f, yaw in enumerate(tf.FINGER_MOUNT_YAWS):
        suffix = ["0", "120", "240"][f]
        lines += [
            f'  <link name="finger_base_link_{suffix}"/>',
            f'  <joint name="holder_to_finger_{suffix}" type="fixed">',
            '    <parent link="upper_holder_link"/>',
            f'    <child link="finger_base_link_{suffix}"/>',
            f'    <origin rpy="0 0 {float(yaw):.11g}" xyz="0 0 0"/>',
            "  </joint>",
        ]
        parent = f"finger_base_link_{suffix}"
        for j in range(3):
            child = f"finger_{link_names[j]}_link_{suffix}"
            inertia = tf.LINK_INERTIAS[j]
            lines += [
                f'  <link name="{child}">',
                "    <inertial>",
                f'      <origin xyz="{fmt(tf.LINK_COMS[j])}"/>',
                f'      <mass value="{float(tf.LINK_MASSES[j]):.10g}"/>',
                f'      <inertia ixx="{inertia[0][0]:.10g}" iyy="{inertia[1][1]:.10g}"'
                f' izz="{inertia[2][2]:.10g}" ixy="{inertia[0][1]:.10g}"'
                f' ixz="{inertia[0][2]:.10g}" iyz="{inertia[1][2]:.10g}"/>',
                "    </inertial>",
                "  </link>",
                f'  <joint name="finger_{["base_to_upper", "upper_to_middle", "middle_to_lower"][j]}_joint_{suffix}" type="revolute">',
                f'    <parent link="{parent}"/>',
                f'    <child link="{child}"/>',
                f'    <origin xyz="{fmt(tf.JOINT_OFFSETS[j])}"/>',
                f'    <axis xyz="{fmt(tf.JOINT_AXES[j])}"/>',
                f'    <limit lower="{float(tf.URDF_JOINT_LOWER[j]):.10g}"'
                f' upper="{float(tf.URDF_JOINT_UPPER[j]):.10g}"'
                f' effort="{tf.MAX_TORQUE_NM}" velocity="{tf.MAX_VELOCITY_RADPS}"/>',
                "  </joint>",
            ]
            parent = child
        lines += [
            f'  <link name="finger_tip_link_{suffix}">',
            "    <collision>",
            f'      <origin xyz="{fmt(tf.TIP_SPHERE_OFFSET)}"/>',
            f'      <geometry><sphere radius="{tf.TIP_SPHERE_RADIUS}"/></geometry>',
            "    </collision>",
            "  </link>",
            f'  <joint name="finger_lower_to_tip_joint_{suffix}" type="fixed">',
            f'    <parent link="{parent}"/>',
            f'    <child link="finger_tip_link_{suffix}"/>',
            f'    <origin xyz="{fmt(tf.TIP_OFFSET)}"/>',
            "  </joint>",
        ]
    lines.append("</robot>")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _matrix_to_rpy(r: np.ndarray) -> np.ndarray:
    """Rotation matrix -> URDF fixed-axis rpy (R = Rz(y) @ Ry(p) @ Rx(r))."""
    r = np.asarray(r, dtype=np.float64)
    sp = -r[2, 0]
    if abs(sp) > 1.0 - 1e-12:
        # gimbal: pitch at +-pi/2; fold roll into yaw
        pitch = np.pi / 2 * np.sign(sp)
        roll = 0.0
        yaw = np.arctan2(-r[0, 1], r[1, 1])
    else:
        pitch = np.arcsin(sp)
        roll = np.arctan2(r[2, 1], r[2, 2])
        yaw = np.arctan2(r[1, 0], r[0, 0])
    return np.array([roll, pitch, yaw])


def export_chain_urdf(chain, path: str, tip_radius: float | None = None):
    """Write a URDF for any :class:`~leibnizgym_tpu_torch.models.chain.ChainModel`
    such that ``chain_from_urdf(exported)`` rebuilds the same tables.

    This is the generic form of :func:`export_trifinger_urdf`: it serializes
    the framework's own model tables (mount transforms, per-joint origins/
    axes/limits, merged link inertials) — a clean-room asset, not a copy of
    any reference file. The tip link is emitted massless (its inertia is
    already merged into the lower link, matching the ChainModel convention)
    with an optional analytic sphere collision.
    """
    from leibnizgym_tpu_torch.models import trifinger as tf

    if tip_radius is None:
        tip_radius = float(tf.TIP_SPHERE_RADIUS)

    def fmt(v):
        return " ".join(f"{float(x):.10g}" for x in np.asarray(v).ravel())

    link_names = ["upper", "middle", "lower"]
    lines = ['<?xml version="1.0"?>', f'<robot name="{chain.name}">',
             '  <link name="base_link"/>']
    for f in range(chain.num_fingers):
        # trifinger convention for the 3-finger family; unique per-index
        # suffixes otherwise (duplicate names would corrupt the round-trip)
        suffix = ["0", "120", "240"][f] if chain.num_fingers == 3 else str(f)
        m_rpy = _matrix_to_rpy(chain.mount_rot[f])
        lines += [
            f'  <link name="finger_base_link_{suffix}"/>',
            f'  <joint name="base_to_finger_{suffix}" type="fixed">',
            '    <parent link="base_link"/>',
            f'    <child link="finger_base_link_{suffix}"/>',
            f'    <origin xyz="{fmt(chain.mount_pos[f])}" rpy="{fmt(m_rpy)}"/>',
            "  </joint>",
        ]
        parent = f"finger_base_link_{suffix}"
        for j in range(3):
            child = f"finger_{link_names[j]}_link_{suffix}"
            inertia = np.asarray(chain.link_inertias[j], dtype=np.float64)
            j_rpy = _matrix_to_rpy(chain.joint_rot[j])
            lines += [
                f'  <link name="{child}">',
                "    <inertial>",
                f'      <origin xyz="{fmt(chain.link_coms[j])}"/>',
                f'      <mass value="{float(chain.link_masses[j]):.10g}"/>',
                f'      <inertia ixx="{inertia[0, 0]:.10g}" iyy="{inertia[1, 1]:.10g}"'
                f' izz="{inertia[2, 2]:.10g}" ixy="{inertia[0, 1]:.10g}"'
                f' ixz="{inertia[0, 2]:.10g}" iyz="{inertia[1, 2]:.10g}"/>',
                "    </inertial>",
                "  </link>",
                f'  <joint name="finger_joint_{j}_{suffix}" type="revolute">',
                f'    <parent link="{parent}"/>',
                f'    <child link="{child}"/>',
                f'    <origin xyz="{fmt(chain.joint_xyz[j])}" rpy="{fmt(j_rpy)}"/>',
                f'    <axis xyz="{fmt(chain.joint_axis[j])}"/>',
                f'    <limit lower="{float(chain.joint_lower[j]):.10g}"'
                f' upper="{float(chain.joint_upper[j]):.10g}"'
                f' effort="{float(chain.effort_limit[j]):.10g}"'
                f' velocity="{float(chain.velocity_limit[j]):.10g}"/>',
                "  </joint>",
            ]
            parent = child
        lines += [
            f'  <link name="finger_tip_link_{suffix}">',
            "    <collision>",
            f'      <geometry><sphere radius="{tip_radius:.10g}"/></geometry>',
            "    </collision>",
            "  </link>",
            f'  <joint name="finger_lower_to_tip_joint_{suffix}" type="fixed">',
            f'    <parent link="{parent}"/>',
            f'    <child link="finger_tip_link_{suffix}"/>',
            f'    <origin xyz="{fmt(chain.tip_xyz)}"/>',
            "  </joint>",
        ]
    lines.append("</robot>")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def finger_chain_tables(model: UrdfModel, finger_suffix: str = "0") -> dict:
    """Extract the per-finger chain tables (joint offsets, axes, tip offset,
    limits) for a trifinger-family URDF — the data that feeds
    ``ops.kinematics``. Returns a dict of numpy arrays."""
    tip_link = f"finger_tip_link_{finger_suffix}"
    chain = model.chain_to(tip_link)
    revolute = [j for j in chain if j.type == "revolute"]
    fixed_tip = [j for j in chain if j.type == "fixed" and j.child == tip_link]
    if len(revolute) != 3 or not fixed_tip:
        raise ValueError(
            f"not a 3-DoF finger chain to {tip_link}: "
            f"{[j.name for j in chain]}"
        )
    return {
        "joint_offsets": np.stack([j.origin_xyz for j in revolute]),
        "joint_axes": np.stack([j.axis for j in revolute]),
        "tip_offset": fixed_tip[0].origin_xyz,
        "joint_lower": np.array([j.lower for j in revolute]),
        "joint_upper": np.array([j.upper for j in revolute]),
        "mount_joints": [
            j for j in model.joints if j.type == "fixed" and "holder_to_finger" in j.name
        ],
    }
