"""Asset tooling: derive analytic collision primitives from mesh files
(counterpart of the repo's ``scripts/asset_tools.py``).

The engine uses analytic primitives instead of convex meshes, so this
tooling derives those primitives from the meshes: bounding spheres
(fingertips), bounding cylinders (arena wall) and bounding boxes, and
reports how far the shipped primitives (``models/trifinger.py``:
TIP_SPHERE_RADIUS, WALL_INNER_RADIUS, the WALL_CONE_* profile) deviate from
a mesh.

    python -m leibnizgym_tpu_torch.scripts.asset_tools sphere path/to/tip.obj
    python -m leibnizgym_tpu_torch.scripts.asset_tools cylinder path/to/boundary_dir/
    python -m leibnizgym_tpu_torch.scripts.asset_tools box path/to/cube.obj
    python -m leibnizgym_tpu_torch.scripts.asset_tools deviation \
        <robot_properties_fingers dir>
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import struct
import sys

import numpy as np

from leibnizgym_tpu_torch.models import trifinger as tf


def load_obj_vertices(path: str) -> np.ndarray:
    """Vertices of an OBJ file (or all OBJ files in a directory)."""
    paths = (
        sorted(glob.glob(os.path.join(path, "*.obj")))
        if os.path.isdir(path)
        else [path]
    )
    verts = []
    for p in paths:
        with open(p) as f:
            for line in f:
                if line.startswith("v "):
                    verts.append([float(x) for x in line.split()[1:4]])
    if not verts:
        raise ValueError(f"no vertices found under {path}")
    return np.asarray(verts)


def load_stl_vertices(path: str) -> np.ndarray:
    """Vertices of a binary STL file."""
    with open(path, "rb") as f:
        header = f.read(80)
        # "solid" header alone does NOT mean ASCII (binary exporters write it
        # too, e.g. the reference's edu meshes): require an actual "facet"
        # keyword in the first text chunk
        f.seek(0)
        probe = f.read(512)
        if header[:5] == b"solid" and b"facet" in probe:
            # ASCII STL
            f.seek(0)
            verts = []
            for line in f.read().decode(errors="ignore").splitlines():
                parts = line.split()
                if parts[:1] == ["vertex"]:
                    verts.append([float(x) for x in parts[1:4]])
            return np.asarray(verts)
        f.seek(80)
        (n_tri,) = struct.unpack("<I", f.read(4))
        data = np.frombuffer(f.read(n_tri * 50), dtype=np.uint8)
        tri = data.reshape(n_tri, 50)
        floats = tri[:, :48].copy().view("<f4").reshape(n_tri, 12)
        return floats[:, 3:12].reshape(-1, 3).astype(np.float64)


def load_vertices(path: str) -> np.ndarray:
    if os.path.isfile(path) and path.lower().endswith(".stl"):
        return load_stl_vertices(path)
    return load_obj_vertices(path)


def fit_sphere(verts: np.ndarray):
    center = (verts.min(0) + verts.max(0)) / 2
    radii = np.linalg.norm(verts - center, axis=1)
    return center, float(radii.max()), float(radii.mean())


def fit_cylinder(verts: np.ndarray, z_floor: float = 0.005):
    """Inner/outer radius + height of a z-aligned annular wall."""
    above = verts[verts[:, 2] > z_floor]
    rho = np.hypot(above[:, 0], above[:, 1])
    return float(rho.min()), float(rho.max()), float(above[:, 2].max())


def fit_box(verts: np.ndarray):
    lo, hi = verts.min(0), verts.max(0)
    return lo, hi, hi - lo


# ---------------------------------------------------------------------------
# Analytic-vs-mesh deviation report: how far the shipped primitives sit from
# the reference's meshes
# ---------------------------------------------------------------------------


def load_obj_mesh(path: str):
    """(verts, faces) of an OBJ file or of all OBJ files in a directory
    (faces re-indexed into the concatenated vertex array)."""
    paths = (
        sorted(glob.glob(os.path.join(path, "*.obj")))
        if os.path.isdir(path)
        else [path]
    )
    verts, faces = [], []
    base = 0
    for p in paths:
        nv = 0
        with open(p) as f:
            for line in f:
                if line.startswith("v "):
                    verts.append([float(x) for x in line.split()[1:4]])
                    nv += 1
                elif line.startswith("f "):
                    idx = [int(t.split("/")[0]) - 1 + base
                           for t in line.split()[1:]]
                    for k in range(1, len(idx) - 1):  # fan-triangulate
                        faces.append([idx[0], idx[k], idx[k + 1]])
        base += nv
    if not faces:
        raise ValueError(f"no faces found under {path}")
    return np.asarray(verts), np.asarray(faces, dtype=np.int64)


def sample_surface(verts: np.ndarray, faces: np.ndarray, n: int = 200_000,
                   seed: int = 0) -> np.ndarray:
    """Area-weighted uniform samples on the triangle surface (vertex-only
    stats under-sample large flat faces — exactly the wall panels we care
    about)."""
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    if areas.sum() == 0:
        raise ValueError("degenerate mesh (zero surface area)")
    rng = np.random.default_rng(seed)
    tri = rng.choice(len(faces), size=n, p=areas / areas.sum())
    u, v = rng.random(n), rng.random(n)
    swap = u + v > 1
    u[swap], v[swap] = 1 - u[swap], 1 - v[swap]
    return a[tri] + u[:, None] * (b[tri] - a[tri]) + v[:, None] * (c[tri] - a[tri])


def tip_sphere_deviation(mesh_path: str, n: int = 200_000) -> dict:
    """Deviation of the shipped analytic fingertip sphere from the reference
    tip collision geometry. The reference env loads trifingerpro.urdf
    (trifinger_env.py:135); its tip link collision is
    SIM__BL-Finger_Tip_actual_tip.obj at origin rpy='pi/2 0 0'
    xyz='-0.0185 0 0.1626' in the tip-link frame — the frame our analytic
    sphere lives in (center TIP_SPHERE_OFFSET, radius TIP_SPHERE_RADIUS).

    Reports signed radial deviation (point-to-center distance minus radius)
    over the CONTACT CAP — the lower hemisphere around the analytic center,
    the only region that ever touches cube/ground — plus whole-mesh stats."""
    verts, faces = load_obj_mesh(mesh_path)
    rx = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], dtype=float)
    pts = sample_surface(verts, faces, n) @ rx.T + np.array(
        [-0.0185, 0, 0.1626]
    )
    center = tf.TIP_SPHERE_OFFSET.astype(float)
    r = float(tf.TIP_SPHERE_RADIUS)
    d = np.linalg.norm(pts - center, axis=1) - r
    cap = pts[:, 2] <= center[2]  # lower hemisphere = contact-bearing region
    return {
        "analytic_radius_m": r,
        "contact_cap_mean_abs_dev_m": float(np.abs(d[cap]).mean()),
        "contact_cap_max_abs_dev_m": float(np.abs(d[cap]).max()),
        "contact_cap_signed_dev_m": [float(d[cap].min()), float(d[cap].max())],
        "whole_mesh_signed_dev_m": [float(d.min()), float(d.max())],
        "samples": int(cap.sum()),
    }


def wall_deviation(mesh_path: str, n: int = 400_000) -> dict:
    """Deviation of the analytic arena wall models from the reference
    boundary geometry (high_table_boundary: the stage the reference env
    loads, trifinger_env.py:137).

    The inner envelope is what cube/tips can touch: bin the sampled surface
    by angle x height, take the innermost radius per bin, and compare to
    (a) the shipped straight cylinder (WALL_INNER_RADIUS, the default) and
    (b) the fitted cylinder+cone profile (WALL_CONE_* constants, selected
    by gym config arena.profile='cone')."""
    verts, faces = load_obj_mesh(mesh_path)
    pts = sample_surface(verts, faces, n)
    z, rho = pts[:, 2], np.hypot(pts[:, 0], pts[:, 1])
    # the wall's radial band is z-dependent (the boundary flares): start
    # from the per-z-band innermost samples, no radial prefilter needed
    # because the boundary mesh has no interior structure inside the wall
    zmax = float(z.max())
    n_zb, n_tb = 16, 360
    band = (z > 0.005) & (z < zmax - 0.005)
    theta = np.arctan2(pts[band, 1], pts[band, 0])
    zb = ((z[band] - 0.005) / (zmax - 0.01) * n_zb).astype(int).clip(0, n_zb - 1)
    tb = ((theta + np.pi) / (2 * np.pi) * n_tb).astype(int).clip(0, n_tb - 1)
    bin_id = zb * n_tb + tb
    inner = np.full(n_zb * n_tb, np.inf)
    np.minimum.at(inner, bin_id, rho[band])
    valid = np.isfinite(inner)
    z_mid = (np.arange(n_zb) + 0.5) / n_zb * (zmax - 0.01) + 0.005
    z_of_bin = np.repeat(z_mid, n_tb)[valid]
    inner = inner[valid]

    def stats(r_of_z):
        dev = inner - r_of_z  # + = mesh wall sits outside the analytic one
        return {
            "mean_abs_dev_m": float(np.abs(dev).mean()),
            "max_abs_dev_m": float(np.abs(dev).max()),
            "signed_dev_m": [float(dev.min()), float(dev.max())],
        }

    cyl = stats(float(tf.WALL_INNER_RADIUS))
    cone = stats(
        tf.WALL_CONE_BASE_RADIUS
        + tf.WALL_CONE_SLOPE * np.maximum(z_of_bin - tf.WALL_CONE_KNEE_Z, 0.0)
    )
    # the band the object can actually reach while on/near the floor
    # (cube half-diagonal ~0.056): errors here matter most for learning
    low = z_of_bin < 0.07
    cyl_object_band = float(np.abs(inner[low] - tf.WALL_INNER_RADIUS).max())
    return {
        "cylinder_default": {**cyl, "radius_m": float(tf.WALL_INNER_RADIUS),
                             "object_band_max_abs_dev_m": cyl_object_band},
        "cone_profile": {**cone,
                         "base_radius_m": tf.WALL_CONE_BASE_RADIUS,
                         "slope": tf.WALL_CONE_SLOPE,
                         "knee_z_m": tf.WALL_CONE_KNEE_Z},
        "bins_covered": int(valid.sum()),
        "bins_total": n_zb * n_tb,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kind", choices=["sphere", "cylinder", "box", "deviation"])
    ap.add_argument("path", help="mesh path, or for 'deviation' the reference's "
                                 "robot_properties_fingers directory")
    args = ap.parse_args(argv)
    if args.kind == "deviation":
        root = args.path
        if not os.path.isdir(root):
            print(f"reference mesh dir not found: {root}", file=sys.stderr)
            return 1
        report = {
            "tip_sphere_vs_pro_actual_tip": tip_sphere_deviation(
                os.path.join(
                    root, "meshes/stl/pro/SIM__BL-Finger_Tip_actual_tip.obj"
                )
            ),
            "wall_vs_high_table_boundary": wall_deviation(
                os.path.join(root, "meshes/stl/high_table_boundary.obj")
            ),
        }
        print(json.dumps(report, indent=2))
        return 0
    verts = load_vertices(args.path)
    print(f"{len(verts)} vertices from {args.path}")
    if args.kind == "sphere":
        center, r_max, r_mean = fit_sphere(verts)
        print(f"bounding sphere: center {np.round(center, 5).tolist()} "
              f"r_max {r_max:.5f} r_mean {r_mean:.5f}")
    elif args.kind == "cylinder":
        r_in, r_out, height = fit_cylinder(verts)
        print(f"wall cylinder: inner_radius {r_in:.4f} outer_radius {r_out:.4f} "
              f"height {height:.4f}")
    else:
        lo, hi, size = fit_box(verts)
        print(f"bounding box: min {np.round(lo, 5).tolist()} "
              f"max {np.round(hi, 5).tolist()} size {np.round(size, 5).tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
