"""The port's copies of JAX-free modules of the JAX package stay equal to them.

The port imports nothing of the JAX package (``test_torch_imports.py``). It
keeps its own copies of the robot tables (``models/trifinger.py``), the
presets (``config/presets.py``), the dict, resource and seeding helpers
(``utils/helpers.py``), the task-name error (``utils/errors.py``, the same
code under its own docstring) and the URDF parser's C++ source (``csrc/urdf_parser.cpp``, of
``native/urdf_parser.cpp``) with its ctypes records (``models/urdf.py``);
these tests hold each copy to its source, so the two cannot drift. The
logging helpers (``utils/message.py``) print the same lines.
"""

import ast
import copy
import ctypes
import os
import random

import numpy as np
import pytest

from leibnizgym_tpu.config import presets as jax_presets
from leibnizgym_tpu.models import trifinger as jax_tf
from leibnizgym_tpu.models import urdf as jax_urdf
from leibnizgym_tpu.utils import helpers as jax_helpers
from leibnizgym_tpu.utils import message as jax_message
from leibnizgym_tpu_torch.config import presets as port_presets
from leibnizgym_tpu_torch.models import trifinger as port_tf
from leibnizgym_tpu_torch.models import urdf as port_urdf
from leibnizgym_tpu_torch.utils import helpers as port_helpers
from leibnizgym_tpu_torch.utils import message as port_message


def _public(module):
    return sorted(k for k in vars(module) if k.isupper() and not k.startswith("_"))


def test_trifinger_tables_have_the_same_names():
    assert _public(port_tf) == _public(jax_tf)
    assert len(_public(jax_tf)) > 30


@pytest.mark.parametrize("name", _public(jax_tf))
def test_trifinger_constant_is_equal(name):
    ours, ref = getattr(port_tf, name), getattr(jax_tf, name)
    assert type(ours) is type(ref), name
    if isinstance(ref, np.ndarray):
        assert ours.dtype == ref.dtype and np.array_equal(ours, ref), name
    else:
        assert np.array_equal(np.asarray(ours), np.asarray(ref)), name


@pytest.mark.parametrize("name", sorted(jax_presets.GYM_PRESETS))
def test_gym_preset_is_equal(name):
    assert sorted(port_presets.GYM_PRESETS) == sorted(jax_presets.GYM_PRESETS)
    assert port_presets.GYM_PRESETS[name] == jax_presets.GYM_PRESETS[name]


def test_default_config_and_agent_presets_are_equal():
    assert port_presets.default_config() == jax_presets.default_config()
    assert sorted(port_presets.RLG_PRESETS) == sorted(jax_presets.RLG_PRESETS)
    for name in jax_presets.RLG_PRESETS:
        assert port_presets.RLG_PRESETS[name]() == jax_presets.RLG_PRESETS[name]()


@pytest.mark.parametrize("argv", [
    [],
    ["gym=trifinger_difficulty_4_curriculum_dr", "args.num_envs=64"],
    ["gym=trifinger_difficulty_1_phase3", "rlg=vanilla", "rlg.params.config.gamma=0.5",
     "gym.sim.physx.num_position_iterations=2", "args.experiment_name=X"],
])
def test_cli_parsing_is_equal(argv):
    ours = port_presets.update_cfg(port_presets.parse_cli(argv))
    ref = jax_presets.update_cfg(jax_presets.parse_cli(argv))
    assert ours == ref


NESTED = [
    ({"a": 1, "b": {"c": 2, "d": {"e": 3}}}, {"b": {"d": {"e": 4, "f": 5}}, "g": 6}),
    ({"a": {"b": 1}}, {"a": 2}),
    ({"a": {"b": 1}, "k": [1]}, {"a": {"c": {"d": 2}}, "k": [2, 3]}),
    ({}, {"x": {"y": [1, 2]}, "z": None}),
]


@pytest.mark.parametrize("case", range(len(NESTED)))
def test_dict_helpers_behave_the_same(case):
    orig, new = NESTED[case]
    a, b = copy.deepcopy(orig), copy.deepcopy(orig)
    assert port_helpers.update_dict(a, new) == jax_helpers.update_dict(b, new)
    assert a == b  # both merge in place
    merged = port_helpers.merged_dict(orig, new)
    assert merged == jax_helpers.merged_dict(orig, new)
    assert orig == NESTED[case][0] and merged is not orig  # the pure variant


def test_message_helpers_print_the_same(capsys):
    cfg = {"a": 1, "b": {"c": [1, 2], "d": {"e": "x"}}}
    port_message.print_dict(cfg, nesting=2)
    ours = capsys.readouterr().out
    jax_message.print_dict(cfg, nesting=2)
    assert ours == capsys.readouterr().out
    for name in ("print_info", "print_debug", "print_notify", "print_warn", "print_error"):
        getattr(port_message, name)("hello")
        assert "hello" in capsys.readouterr().out


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_urdf_parser_source_is_byte_equal():
    with open(os.path.join(ROOT, "leibnizgym_tpu_torch/csrc/urdf_parser.cpp"), "rb") as a, \
            open(os.path.join(ROOT, "native/urdf_parser.cpp"), "rb") as b:
        assert a.read() == b.read()


def _code(path):
    """The module's code without its docstring."""
    with open(os.path.join(ROOT, path)) as f:
        body = ast.parse(f.read()).body
    return [ast.dump(node) for node in body[1:]]


def test_errors_module_is_the_same_code():
    assert _code("leibnizgym_tpu_torch/utils/errors.py") == \
        _code("leibnizgym_tpu/utils/errors.py")


def test_urdf_records_match_the_parser_bindings():
    def kind(t):
        inner = getattr(t, "_type_", t)  # a code ("d"), or an element / pointee class
        return inner if isinstance(inner, str) else inner.__name__

    def layout(cls):
        return ctypes.sizeof(cls), [(f, getattr(cls, f).offset, getattr(cls, f).size, kind(t))
                                    for f, t in cls._fields_]

    for name in ("_UrdfLink", "_UrdfJoint", "_UrdfModel"):
        assert layout(getattr(port_urdf, name)) == layout(getattr(jax_urdf, name)), name
    assert port_urdf._JOINT_TYPES == jax_urdf._JOINT_TYPES


def test_resource_and_seed_helpers_behave_the_same():
    assert port_helpers.get_resources_dir() == jax_helpers.get_resources_dir()
    saved = np.get_printoptions()
    try:
        port_helpers.set_np_formatting()
        ours = np.get_printoptions()
        np.set_printoptions(**saved)
        jax_helpers.set_np_formatting()
        assert ours == np.get_printoptions() and ours["linewidth"] == 4000
    finally:
        np.set_printoptions(**saved)
    state = random.getstate(), np.random.get_state()
    try:
        gen = port_helpers.set_seed(11)
        ours = random.random(), np.random.rand()
        key = jax_helpers.set_seed(11)
        assert ours == (random.random(), np.random.rand())
        assert gen.initial_seed() == 11 and int(np.asarray(key)[-1]) == 11
    finally:
        random.setstate(state[0])
        np.random.set_state(state[1])
