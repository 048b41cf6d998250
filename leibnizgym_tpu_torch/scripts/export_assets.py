"""Write the framework's self-contained asset set (counterpart of the repo's
``scripts/export_assets.py``) into a directory of the caller's choosing.

    python -m leibnizgym_tpu_torch.scripts.export_assets --out /tmp/assets
    python -m leibnizgym_tpu_torch.scripts.export_assets --out /tmp/assets \
        --reference-urdf-dir <robot_properties_fingers/urdf>

The engine consumes model tables, not meshes, so the asset set is a
collection of clean-room URDFs serialized from those tables:

- robots/: every robot variant of the trifinger family, exported through
  ``models.urdf.export_chain_urdf`` from the ChainModel tables, parsed from
  the reference's URDF directory when ``--reference-urdf-dir`` is given
  (otherwise robots/ is left out);
- objects/: the task objects (cube variants, ball) written from their spec
  constants (box size / density / mass);
- stage/: the arena as the analytic geometry the engine simulates (table
  plane + boundary cylinder of ARENA_RADIUS), and the analytic equivalents
  of the reference's stage-only URDFs;
- trifinger_tpu.urdf: the env's robot from the baked tables.

The repo's ``resources/assets/`` holds the files the JAX package's script
wrote; ``tests/test_torch_tool_scripts.py`` holds this one's to them.
"""

from __future__ import annotations

import argparse
import os
import sys

from leibnizgym_tpu_torch.envs.trifinger.dims import ARENA_RADIUS
from leibnizgym_tpu_torch.models.chain import chain_from_urdf
from leibnizgym_tpu_torch.models.urdf import export_chain_urdf, export_trifinger_urdf

# (reference variant path, shipped name)
ROBOT_VARIANTS = [
    ("pro/trifingerpro.urdf", "trifingerpro.urdf"),
    ("pro/fingerpro.urdf", "fingerpro.urdf"),
    ("pro/trifingerpro_with_stage.urdf", "trifingerpro_with_stage.urdf"),
    ("edu/trifingeredu.urdf", "trifingeredu.urdf"),
    ("edu/fingeredu.urdf", "fingeredu.urdf"),
    ("edu/trifingeredu_with_stage.urdf", "trifingeredu_with_stage.urdf"),
    ("trifinger.urdf", "trifinger.urdf"),
    ("trifinger_with_stage.urdf", "trifinger_with_stage.urdf"),
    ("finger.urdf", "finger.urdf"),
    ("finger_with_stage.urdf", "finger_with_stage.urdf"),
]

# Task objects: (filename, kind, size, mass_or_density)
# Spec constants from the reference's objects/urdf/ (SURVEY.md §2.2); these
# numbers ARE the task spec (object dims drive reward/obs scales).
OBJECTS = [
    ("cube_multicolor_rrc.urdf", "box", 0.065, ("density", 291.3)),
    ("cube_goal_multicolor.urdf", "box", 0.05, ("density", 567.0)),
    ("cube_multicolor.urdf", "box", 0.065, ("density", 291.3)),
    ("ball.urdf", "sphere", 0.0375, ("mass", 0.25)),
    # RRC phase-3 cuboid: 2x8x2 cm box, density 500
    # (reference objects/urdf/cube_multicolor_rrc_phase3.urdf:1-20)
    ("cube_multicolor_rrc_phase3.urdf", "box", (0.02, 0.08, 0.02),
     ("density", 500.0)),
]


def write_object_urdf(path: str, kind: str, size, massing) -> None:
    """``size``: box edge (scalar) / per-axis (sx, sy, sz) tuple / sphere
    radius."""
    name = os.path.splitext(os.path.basename(path))[0]
    if kind == "box":
        sx, sy, sz = size if isinstance(size, (tuple, list)) else (size,) * 3
        geom = f'<box size="{sx} {sy} {sz}"/>'
        volume = sx * sy * sz
    else:
        geom = f'<sphere radius="{size}"/>'
        volume = 4.0 / 3.0 * 3.141592653589793 * size ** 3
    how, value = massing
    mass = value if how == "mass" else value * volume
    # solid uniform body inertia about COM
    if kind == "box":
        ixx = mass * (sy ** 2 + sz ** 2) / 12.0
        iyy = mass * (sx ** 2 + sz ** 2) / 12.0
        izz = mass * (sx ** 2 + sy ** 2) / 12.0
    else:
        ixx = iyy = izz = 2.0 / 5.0 * mass * size ** 2
    density_el = (
        f"\n      <density value=\"{value}\"/>" if how == "density" else ""
    )
    body = f"""<?xml version="1.0"?>
<robot name="{name}">
  <link name="object">
    <inertial>{density_el}
      <mass value="{mass:.10g}"/>
      <inertia ixx="{ixx:.10g}" iyy="{iyy:.10g}" izz="{izz:.10g}"
               ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision>
      <geometry>{geom}</geometry>
    </collision>
  </link>
</robot>
"""
    with open(path, "w") as f:
        f.write(body)


# Measured reference boundary profile (asset_tools.py deviation; PARITY.md): vertical cylinder r=0.1945 below z=0.034, flaring at
# dr/dz=0.577 up to z=0.176. Approximated in URDF primitives as a base
# cylinder + stacked cylinder bands at the band-mid inner radius.
_CONE_R0, _CONE_KNEE, _CONE_SLOPE, _CONE_TOP = 0.1945, 0.034, 0.577, 0.176
# edu arena (edu/frame_wall.stl): cylindrical shell, inner r=0.242, h=0.25
_EDU_WALL_R, _EDU_WALL_H = 0.242, 0.25
# table slab (trifinger_table_without_border.stl): 0.71 x 0.76 x 0.01, top z=0
_TABLE = (0.71, 0.76, 0.01)


def _table_collision() -> str:
    sx, sy, sz = _TABLE
    return (f'    <collision>\n      <origin xyz="0 0 {-sz / 2}"/>\n'
            f'      <geometry><box size="{sx} {sy} {sz}"/></geometry>\n'
            "    </collision>")


def _cone_boundary_collisions(bands: int = 4) -> str:
    """The flared boundary as URDF cylinder elements (radius = inner arena
    radius at each band, the quantity the engine's SceneParams carry)."""
    out = [(f'    <collision>\n      <origin xyz="0 0 {_CONE_KNEE / 2}"/>\n'
            f'      <geometry><cylinder radius="{_CONE_R0}" '
            f'length="{_CONE_KNEE}"/></geometry>\n    </collision>')]
    h = (_CONE_TOP - _CONE_KNEE) / bands
    for b in range(bands):
        z_mid = _CONE_KNEE + (b + 0.5) * h
        r = _CONE_R0 + _CONE_SLOPE * (z_mid - _CONE_KNEE)
        out.append(
            f'    <collision>\n      <origin xyz="0 0 {z_mid:.5g}"/>\n'
            f'      <geometry><cylinder radius="{r:.5g}" '
            f'length="{h:.5g}"/></geometry>\n    </collision>')
    return "\n".join(out)


def _inertial(mass: float, i: float) -> str:
    return (f'    <inertial>\n      <mass value="{mass}"/>\n'
            f'      <inertia ixx="{i}" ixy="0" ixz="0" iyy="{i}" iyz="0" '
            f'izz="{i}"/>\n    </inertial>')


def write_stage_variant_urdfs(stage_dir: str) -> list:
    """Analytic equivalents of the reference's stage-only URDF variants:
    stage.urdf, stage_composite.urdf,
    trifinger_stage.urdf, trifingeredu_stage.urdf, high_table_boundary.urdf
    — reference robot_properties_fingers/urdf/. Geometry is the MEASURED
    arena surfaces (table slab + boundary profile); the engine itself
    consumes SceneParams (wall_radius/wall_slope/wall_knee_z), these files
    are the asset-surface equivalents. The old stage's decorative
    superstructure (trifinger_stage_vhacd2.obj frame) is not reproduced."""
    cone = _cone_boundary_collisions()
    table = _table_collision()
    written = []

    def write(name, body):
        path = os.path.join(stage_dir, name)
        with open(path, "w") as f:
            f.write(body)
        written.append(path)

    two_link = """<?xml version="1.0"?>
<robot name="{name}">
  <!-- analytic equivalent of the reference {ref} (measured arena surfaces;
       see scripts/export_assets.py + PARITY.md collision-deviation table) -->
  <link name="base_link"/>
  <link name="table_link">
{table}
{inertial_t}
  </link>
  <link name="boundary_link">
{boundary}
{inertial_b}
  </link>
  <joint name="base_to_table" type="fixed">
    <parent link="base_link"/>
    <child link="table_link"/>
    <origin xyz="0 0 0"/>
  </joint>
  <joint name="table_to_boundary" type="fixed">
    <parent link="table_link"/>
    <child link="boundary_link"/>
    <origin xyz="0 0 0"/>
  </joint>
</robot>
"""
    write("trifinger_stage.urdf", two_link.format(
        name="trifinger_stage", ref="urdf/trifinger_stage.urdf",
        table=table, boundary=cone,
        inertial_t=_inertial(2, 0.0963), inertial_b=_inertial(2, 0.0571)))
    edu_wall = (
        f'    <collision>\n      <origin xyz="0 0 {_EDU_WALL_H / 2}"/>\n'
        f'      <geometry><cylinder radius="{_EDU_WALL_R}" '
        f'length="{_EDU_WALL_H}"/></geometry>\n    </collision>')
    write("trifingeredu_stage.urdf", two_link.format(
        name="trifingeredu_stage", ref="urdf/edu/trifingeredu_stage.urdf",
        table=table, boundary=edu_wall,
        inertial_t=_inertial(2, 0.0963), inertial_b=_inertial(2, 0.0571)))

    one_link = """<?xml version="1.0"?>
<robot name="{name}">
  <!-- analytic equivalent of the reference {ref}: the measured arena
       surfaces (table slab + flared boundary). The reference file is
       {note}. -->
  <link name="{link}">
{body}
{inertial}
  </link>
</robot>
"""
    write("high_table_boundary.urdf", one_link.format(
        name="high_table_boundary", ref="urdf/high_table_boundary.urdf",
        link="high_table_boundary_link", body=cone,
        note="40 V-HACD convex pieces of high_table_boundary.stl "
             "(the stage the env loads)",
        inertial=_inertial(1, 0.0077)))
    write("stage.urdf", one_link.format(
        name="stage", ref="urdf/stage.urdf", link="stage_link",
        body=table + "\n" + cone,
        note="the monolithic trifinger_stage_vhacd2.obj mesh",
        inertial=_inertial(1, 0.0077)))
    write("stage_composite.urdf", one_link.format(
        name="stage_composite", ref="urdf/stage_composite.urdf",
        link="stage_link", body=table + "\n" + cone,
        note="the same stage as a 36-piece convex decomposition — the "
             "mesh-vs-decomposition distinction collapses for analytic "
             "primitives",
        inertial=_inertial(1, 0.0077)))
    return written


def write_stage_urdf(path: str) -> None:
    body = f"""<?xml version="1.0"?>
<robot name="trifinger_stage_tpu">
  <!-- analytic arena the TPU engine simulates: table plane at z=0 plus a
       boundary cylinder wall of ARENA_RADIUS (reference utils.py:54);
       replaces high_table_boundary.urdf's 40 V-HACD convex pieces -->
  <link name="table">
    <collision>
      <origin xyz="0 0 -0.005"/>
      <geometry><box size="1.0 1.0 0.01"/></geometry>
    </collision>
  </link>
  <link name="boundary">
    <collision>
      <origin xyz="0 0 0.15"/>
      <geometry><cylinder radius="{ARENA_RADIUS}" length="0.3"/></geometry>
    </collision>
  </link>
  <joint name="table_to_boundary" type="fixed">
    <parent link="table"/>
    <child link="boundary"/>
    <origin xyz="0 0 0"/>
  </joint>
</robot>
"""
    with open(path, "w") as f:
        f.write(body)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="directory to write the asset set into")
    ap.add_argument("--reference-urdf-dir", default=None,
                    help="the reference's robot_properties_fingers/urdf directory; "
                         "robots/ is exported from it (left out without it)")
    args = ap.parse_args(argv)
    out = os.path.abspath(args.out)
    for sub in ("robots", "objects", "stage"):
        os.makedirs(os.path.join(out, sub), exist_ok=True)

    for fname, kind, size, massing in OBJECTS:
        path = os.path.join(out, "objects", fname)
        write_object_urdf(path, kind, size, massing)
        print(f"wrote {path}")

    path = os.path.join(out, "stage", "trifinger_stage_tpu.urdf")
    write_stage_urdf(path)
    print(f"wrote {path}")

    for p in write_stage_variant_urdfs(os.path.join(out, "stage")):
        print(f"wrote {p}")

    # canonical env robot (from baked tables; no reference needed)
    print(f"wrote {export_trifinger_urdf(os.path.join(out, 'trifinger_tpu.urdf'))}")

    if args.reference_urdf_dir is None:
        print("no --reference-urdf-dir: robots/ not exported")
        return 0
    for ref_rel, out_name in ROBOT_VARIANTS:
        chain = chain_from_urdf(os.path.join(args.reference_urdf_dir, ref_rel))
        path = os.path.join(out, "robots", out_name)
        export_chain_urdf(chain, path)
        print(f"wrote {path} ({chain.num_fingers} finger(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
