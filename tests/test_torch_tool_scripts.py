"""Port parity: the tool scripts of ``leibnizgym_tpu_torch/scripts/``
(``benchmark``, ``asset_tools``, ``export_assets``,
``trifinger_random_action``, the ``nan_replay`` help) against the repo's
JAX scripts under ``scripts/``, on the CPU at small sizes.

- ``benchmark.bench_one`` at 8 envs x 3 steps gives a positive rate, and
  the YAML of ``main`` has the keys and value types of the JAX script's
  (whose env sweep is stubbed: only its output format is compared).
- The asset tools' fits and mesh-deviation reports are numpy in both, on
  seeded synthetic meshes (an OBJ sphere, a binary STL box, an OBJ wall):
  equal exactly, and both ``main``s print the same lines, the ``deviation``
  report included (on a directory laid out as the reference's
  robot_properties_fingers).
- ``export_assets``' writers write files byte-equal to the JAX script's and
  to the shipped ``resources/assets/``; its ``main`` writes the whole set
  into a temporary directory, never into ``resources/``.
"""

import filecmp
import importlib.util
import json
import os
import shutil
import struct
import sys

import numpy as np
import pytest
import torch
import yaml

from leibnizgym_tpu_torch.scripts import asset_tools as tat
from leibnizgym_tpu_torch.scripts import benchmark as tbench
from leibnizgym_tpu_torch.scripts import export_assets as tea
from leibnizgym_tpu_torch.scripts import nan_replay
from leibnizgym_tpu_torch.scripts import trifinger_random_action as trand

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "resources", "assets")


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# benchmark
# ---------------------------------------------------------------------------


def test_bench_one_on_the_cpu():
    sps = tbench.bench_one(8, 3, 1, True, device="cpu")
    assert np.isfinite(sps) and sps > 0


def test_benchmark_yaml_has_the_reference_keys(tmp_path, monkeypatch):
    ref = _jax_script("benchmark")
    monkeypatch.setattr(ref, "bench_one", lambda n, *a: 100.0 * n)
    monkeypatch.setattr(sys, "argv", ["benchmark.py", "--num_envs_sweep", "8", "16",
                                      "--bench_len", "3", "--bench_file",
                                      str(tmp_path / "ref.yaml")])
    ref.main()
    out = tmp_path / "ours.yaml"
    payload = tbench.main(["--num_envs_sweep", "8", "--bench_len", "3", "--substeps", "1",
                           "--device", "cpu", "--bench_file", str(out)])
    with open(tmp_path / "ref.yaml") as f:
        theirs = yaml.safe_load(f)
    with open(out) as f:
        ours = yaml.safe_load(f)
    assert ours == payload and sorted(ours) == sorted(theirs) == [
        "bench_len", "device", "env_steps_per_sec", "substeps"]
    for k in theirs:
        assert type(ours[k]) is type(theirs[k]), k
    assert ours["device"] == "cpu" and ours["bench_len"] == 3 and ours["substeps"] == 1
    assert list(ours["env_steps_per_sec"]) == [8] and ours["env_steps_per_sec"][8] > 0


def test_random_action_chunk_on_the_cpu():
    env = trand.make_env(8, device="cpu", verbose=False)
    gen = torch.Generator().manual_seed(1)
    sps = trand.chunk(env, gen, length=3)
    assert np.isfinite(sps) and sps > 0 and env.env_steps_count == (1 + 3) * 8  # reset + 3 steps
    assert trand.CHUNK == 50 and trand.NUM_ENVS == int(os.environ.get("NUM_ENVS", 8192))


def test_nan_replay_help_names_the_device_limit(capsys):
    with pytest.raises(SystemExit):
        nan_replay.main(["--help"])
    out = " ".join(capsys.readouterr().out.split())
    assert "replays only on the kind of device that wrote it" in out


# ---------------------------------------------------------------------------
# asset tools, on seeded synthetic meshes
# ---------------------------------------------------------------------------


def _sphere_obj(path, center, radius, seed):
    """A UV sphere mesh with seeded radial noise, as an OBJ."""
    rng = np.random.default_rng(seed)
    th, ph = np.meshgrid(np.linspace(0.1, np.pi - 0.1, 12), np.linspace(0, 2 * np.pi, 16,
                                                                         endpoint=False))
    r = radius * (1 + 0.02 * rng.standard_normal(th.shape))
    v = np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph),
                  r * np.cos(th)], -1).reshape(-1, 3) + center
    faces = []
    for i in range(16):
        for j in range(11):
            a, b = i * 12 + j, ((i + 1) % 16) * 12 + j
            faces.append((a + 1, b + 1, b + 2, a + 2))  # quads, fan-triangulated on load
    _write_obj(path, v, faces)


def _wall_obj(path, radius, height, seed):
    """A cylindrical wall (inner and outer skin) with a seeded flare."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, 48, endpoint=False)
    zs = np.linspace(0.0, height, 10)
    verts = []
    for r0 in (radius, radius + 0.01):
        for z in zs:
            r = r0 + 0.5 * max(z - 0.05, 0.0) + 0.001 * rng.standard_normal(ang.shape)
            verts += [(rr * np.cos(a), rr * np.sin(a), z) for rr, a in zip(r, ang)]
    faces = []
    for k in range(2):
        for zi in range(len(zs) - 1):
            for ai in range(48):
                a = k * 480 + zi * 48 + ai
                b = k * 480 + zi * 48 + (ai + 1) % 48
                faces.append((a + 1, b + 1, b + 49, a + 49))
    _write_obj(path, np.asarray(verts), faces)


def _write_obj(path, verts, faces):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.writelines(f"v {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in verts)
        f.writelines("f " + " ".join(f"{i}/{i}" for i in face) + "\n" for face in faces)


def _box_stl(path, half, seed):
    """A binary STL (with a "solid" header, as some exporters write) of a
    seeded box."""
    rng = np.random.default_rng(seed)
    c = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)]) * half
    c = c + 0.001 * rng.standard_normal(c.shape)
    tris = [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5), (0, 5, 1),
            (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)]
    with open(path, "wb") as f:
        f.write(b"solid binary".ljust(80, b" "))
        f.write(struct.pack("<I", len(tris)))
        for t in tris:
            f.write(struct.pack("<12f", 0, 0, 0, *c[t[0]], *c[t[1]], *c[t[2]]) + b"\0\0")


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    d = tmp_path_factory.mktemp("meshes")
    tip = d / "meshes" / "stl" / "pro" / "SIM__BL-Finger_Tip_actual_tip.obj"
    # the tip mesh in its own frame: the analytic sphere's center moved back
    # through the reference's collision origin (rpy pi/2 0 0, xyz -0.0185 0 0.1626)
    from leibnizgym_tpu_torch.models import trifinger as tf
    c = np.asarray(tf.TIP_SPHERE_OFFSET, float) - [-0.0185, 0, 0.1626]
    c = np.array([c[0], c[2], -c[1]])
    _sphere_obj(str(tip), c, float(tf.TIP_SPHERE_RADIUS), 1)
    wall = d / "meshes" / "stl" / "high_table_boundary.obj"
    _wall_obj(str(wall), 0.1945, 0.2, 2)
    box = d / "box.stl"
    _box_stl(str(box), np.array([0.0325, 0.0325, 0.0325]), 3)
    return d, str(tip), str(wall), str(box)


def test_asset_fits_match_reference(meshes):
    _, tip, wall, box = meshes
    ref = _jax_script("asset_tools")
    for path in (tip, wall, box, os.path.dirname(wall)):
        v = tat.load_vertices(path)
        np.testing.assert_array_equal(v, ref.load_vertices(path))
        for fit in ("fit_sphere", "fit_cylinder", "fit_box"):
            for x, y in zip(getattr(tat, fit)(v), getattr(ref, fit)(v)):
                np.testing.assert_array_equal(x, y, err_msg=f"{path} {fit}")
    verts, faces = tat.load_obj_mesh(tip)
    np.testing.assert_array_equal(tat.sample_surface(verts, faces, 1000, 5),
                                  ref.sample_surface(verts, faces, 1000, 5))
    assert tat.tip_sphere_deviation(tip, 20_000) == ref.tip_sphere_deviation(tip, 20_000)
    report = tat.wall_deviation(wall, 40_000)
    assert report == ref.wall_deviation(wall, 40_000)
    assert report["bins_covered"] > 0 and report["cylinder_default"]["max_abs_dev_m"] > 0


@pytest.mark.parametrize("kind", ["sphere", "cylinder", "box", "deviation"])
def test_asset_tools_main_prints_the_same(kind, meshes, capsys, monkeypatch):
    root, tip, wall, box = meshes
    path = {"sphere": tip, "cylinder": os.path.dirname(wall), "box": box,
            "deviation": str(root)}[kind]
    ref = _jax_script("asset_tools")
    monkeypatch.setattr(sys, "argv", ["asset_tools.py", kind, path])
    if kind == "deviation":
        # smaller samples than the reports' 200k + 400k points, alike in both
        monkeypatch.setattr(ref, "tip_sphere_deviation", _small(ref.tip_sphere_deviation))
        monkeypatch.setattr(ref, "wall_deviation", _small(ref.wall_deviation))
        monkeypatch.setattr(tat, "tip_sphere_deviation", _small(tat.tip_sphere_deviation))
        monkeypatch.setattr(tat, "wall_deviation", _small(tat.wall_deviation))
    ref.main()
    theirs = capsys.readouterr().out
    assert tat.main([kind, path]) == 0
    ours = capsys.readouterr().out
    assert ours == theirs and ours
    if kind == "deviation":
        assert set(json.loads(ours)) == {"tip_sphere_vs_pro_actual_tip",
                                         "wall_vs_high_table_boundary"}


def _small(fn):
    return lambda path, n=None: fn(path, 20_000)


def test_asset_tools_deviation_needs_a_directory(tmp_path, capsys):
    assert tat.main(["deviation", str(tmp_path / "absent")]) == 1
    assert "not found" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# export_assets
# ---------------------------------------------------------------------------


def test_export_writers_match_reference_and_shipped(tmp_path):
    ref = _jax_script("export_assets")
    assert tea.OBJECTS == ref.OBJECTS and tea.ROBOT_VARIANTS == ref.ROBOT_VARIANTS
    for who, mod in (("ours", tea), ("ref", ref)):
        for sub in ("objects", "stage"):
            os.makedirs(tmp_path / who / sub)
        for fname, kind, size, massing in mod.OBJECTS:
            mod.write_object_urdf(str(tmp_path / who / "objects" / fname), kind, size, massing)
        mod.write_stage_urdf(str(tmp_path / who / "stage" / "trifinger_stage_tpu.urdf"))
        mod.write_stage_variant_urdfs(str(tmp_path / who / "stage"))
    for sub in ("objects", "stage"):
        names = sorted(os.listdir(tmp_path / "ref" / sub))
        assert names == sorted(os.listdir(tmp_path / "ours" / sub)) == \
            sorted(os.listdir(os.path.join(ASSETS, sub)))
        for name in names:
            ours = tmp_path / "ours" / sub / name
            assert filecmp.cmp(ours, tmp_path / "ref" / sub / name, shallow=False), name
            assert filecmp.cmp(ours, os.path.join(ASSETS, sub, name), shallow=False), name


def test_export_assets_main_writes_the_shipped_set(tmp_path, capsys):
    """The whole set into a temporary directory; robots/ from a directory
    laid out as the reference's urdf/ (the shipped robots in its places):
    every file byte-equal to resources/assets/."""
    urdf_dir = tmp_path / "urdf"
    for ref_rel, shipped in tea.ROBOT_VARIANTS:
        os.makedirs((urdf_dir / ref_rel).parent, exist_ok=True)
        shutil.copy(os.path.join(ASSETS, "robots", shipped), urdf_dir / ref_rel)
    out = tmp_path / "assets"
    assert tea.main(["--out", str(out)]) == 0
    assert "robots/ not exported" in capsys.readouterr().out
    assert os.listdir(out / "robots") == []
    assert tea.main(["--out", str(out), "--reference-urdf-dir", str(urdf_dir)]) == 0
    shipped = sorted(os.path.relpath(os.path.join(b, f), ASSETS)
                     for b, _, fs in os.walk(ASSETS) for f in fs)
    written = sorted(os.path.relpath(os.path.join(b, f), out)
                     for b, _, fs in os.walk(out) for f in fs)
    assert written == shipped and len(shipped) == 22
    for rel in shipped:
        assert filecmp.cmp(out / rel, os.path.join(ASSETS, rel), shallow=False), rel
