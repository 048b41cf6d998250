"""Port parity: the URDF loader (``models/urdf.py`` over the port's own
``csrc/urdf_parser.cpp``) and the chain assembly (``models/chain.py``)
against the JAX package, on every URDF under ``resources/assets/`` (the
twin of tests/test_urdf.py).

Both sides parse with the same C++ source (the port builds its copy into
``build/leibnizgym_tpu_torch/urdf-<hash>/``, the JAX package its own under
``native/``) and assemble in numpy, so every field is compared exactly; the
exporters must write byte-equal files.
"""

import dataclasses
import os
import textwrap

import numpy as np
import pytest

from leibnizgym_tpu.models import chain as jchain
from leibnizgym_tpu.models import urdf as jurdf
from leibnizgym_tpu_torch.models import chain as tchain
from leibnizgym_tpu_torch.models import trifinger as tf_model
from leibnizgym_tpu_torch.models import urdf as turdf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "resources", "assets")
URDFS = sorted(os.path.relpath(os.path.join(base, f), ASSETS)
               for base, _, files in os.walk(ASSETS) for f in files if f.endswith(".urdf"))
ROBOTS = [u for u in URDFS if u.startswith("robots" + os.sep)]


def _same(a, b, what):
    """Dataclass trees equal field by field (arrays exactly, dtype included)."""
    assert type(a).__name__ == type(b).__name__, what
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, dict):
        assert list(a) == list(b), what
        for k in a:
            _same(a[k], b[k], f"{what}[{k}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), what
    else:
        assert a == b, what


def test_there_are_22_urdfs():
    assert len(URDFS) == 22 and len(ROBOTS) == 10


@pytest.mark.parametrize("rel", URDFS)
def test_parse_urdf_matches_reference(rel):
    path = os.path.join(ASSETS, rel)
    ours, ref = turdf.parse_urdf(path), jurdf.parse_urdf(path)
    _same(ref, ours, rel)
    for link in ours.links:
        _same(ref.chain_to(link), ours.chain_to(link), f"{rel} chain_to {link}")
        _same(ref.child_joints(link), ours.child_joints(link), f"{rel} child_joints {link}")


@pytest.mark.parametrize("rel", ROBOTS)
def test_chain_from_urdf_matches_reference(rel):
    path = os.path.join(ASSETS, rel)
    ours, ref = tchain.chain_from_urdf(path), jchain.chain_from_urdf(path)
    _same(ref, ours, rel)


def test_finger_chain_tables_match_reference(tmp_path):
    path = turdf.export_trifinger_urdf(str(tmp_path / "trifinger_tpu.urdf"))
    ours, ref = turdf.parse_urdf(path), jurdf.parse_urdf(path)
    for suffix in ("0", "120", "240"):
        _same(jurdf.finger_chain_tables(ref, suffix), turdf.finger_chain_tables(ours, suffix),
              suffix)
    t = turdf.finger_chain_tables(ours, "120")
    assert np.allclose(t["joint_offsets"], tf_model.JOINT_OFFSETS, atol=1e-6)
    with pytest.raises(ValueError, match="not a 3-DoF finger chain"):
        turdf.finger_chain_tables(ours, "60")


def test_non_trifinger_urdfs_are_refused_alike():
    stage = os.path.join(ASSETS, "stage", "trifinger_stage_tpu.urdf")
    for mod in (tchain, jchain):
        with pytest.raises(ValueError, match="no 3-DoF finger chains"):
            mod.chain_from_urdf(stage)
    with pytest.raises(FileNotFoundError, match="failed to parse URDF"):
        turdf.parse_urdf(os.path.join(ASSETS, "no_such.urdf"))


def test_parse_synthetic_matches_reference(tmp_path):
    path = tmp_path / "mini.urdf"
    path.write_text(textwrap.dedent("""\
        <?xml version="1.0"?>
        <!-- a comment -->
        <robot name="mini">
          <link name="base">
            <inertial>
              <origin xyz="0.1 0.2 0.3" rpy="0 0 0"/>
              <mass value="1.5"/>
              <inertia ixx="0.01" ixy="0.001" ixz="0" iyy="0.02" iyz="0" izz="0.03"/>
            </inertial>
            <collision><geometry><box size="0.1 0.2 0.3"/></geometry></collision>
          </link>
          <link name="arm"/>
          <joint name="j1" type="revolute">
            <parent link="base"/>
            <child link="arm"/>
            <origin xyz="0 0 0.5" rpy="0 0 1.57"/>
            <axis xyz="0 1 0"/>
            <limit lower="-1" upper="2" effort="10" velocity="5"/>
          </joint>
        </robot>
    """))
    ours = turdf.parse_urdf(str(path))
    _same(jurdf.parse_urdf(str(path)), ours, "mini")
    assert ours.links["base"].mass == 1.5 and ours.joints[0].upper == 2


def test_export_trifinger_urdf_is_byte_equal(tmp_path):
    ours = turdf.export_trifinger_urdf(str(tmp_path / "ours.urdf"))
    ref = jurdf.export_trifinger_urdf(str(tmp_path / "ref.urdf"))
    with open(ours, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    with open(os.path.join(ASSETS, "trifinger_tpu.urdf"), "rb") as shipped, \
            open(ours, "rb") as a:
        assert a.read() == shipped.read()


@pytest.mark.parametrize("rel", ROBOTS)
def test_export_chain_urdf_is_byte_equal(rel, tmp_path):
    """Each side exports its own chain of the shipped robot; the files are
    byte-equal, and equal to the shipped asset they were parsed from."""
    path = os.path.join(ASSETS, rel)
    ours = turdf.export_chain_urdf(tchain.chain_from_urdf(path), str(tmp_path / "ours.urdf"))
    ref = jurdf.export_chain_urdf(jchain.chain_from_urdf(path), str(tmp_path / "ref.urdf"))
    with open(ours, "rb") as a, open(ref, "rb") as b, open(path, "rb") as shipped:
        data = a.read()
        assert data == b.read()
        assert data == shipped.read()
