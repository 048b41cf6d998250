"""Port parity: the legacy argparse / YAML CLI (``config/config_utils.py``,
``utils/errors.py``) against the JAX package.

The same argv gives the same ``get_args`` namespace, and then the same
``(cfg_env, cfg_train)`` through ``load_cfg`` + ``update_cfg_from_args``
(read from the repo's resources/config/trifinger YAMLs, or from the presets
where a file is absent), compared exactly. An unknown task raises
``InvalidTaskNameError`` with the same message in both.
"""

import copy

import pytest

from leibnizgym_tpu.config import config_utils as jcu
from leibnizgym_tpu.utils import errors as jerrors
from leibnizgym_tpu_torch.config import config_utils as tcu
from leibnizgym_tpu_torch.utils import errors as terrors

ARGVS = [
    [],
    ["--num_envs", "64", "--seed", "3"],
    ["--training_type", "vanilla_ppo", "--episode_length", "500", "--task_difficulty", "3"],
    ["--play", "--checkpoint", "logs/x/nn/best", "--max_epochs", "10", "--verbose"],
    ["--randomize", "--random_actions", "--num_proc", "2", "--bench_len", "50",
     "--bench_file", "/tmp/b.yaml"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "defaults")
def test_same_argv_gives_same_configs(argv):
    jargs, targs = jcu.get_args(argv), tcu.get_args(argv)
    assert vars(targs) == vars(jargs)
    # retrieve_cfg_paths takes the training type without its "_ppo"
    for training_type in (targs.training_type, targs.training_type.split("_")[0]):
        assert tcu.retrieve_cfg_paths(targs.task, training_type) == \
            jcu.retrieve_cfg_paths(jargs.task, training_type)
        jenv, jtrain = jcu.load_cfg(jargs.task, training_type)
        tenv, ttrain = tcu.load_cfg(targs.task, training_type)
        assert (tenv, ttrain) == (jenv, jtrain)
        assert tcu.update_cfg_from_args(copy.deepcopy(tenv), copy.deepcopy(ttrain), targs) == \
            jcu.update_cfg_from_args(copy.deepcopy(jenv), copy.deepcopy(jtrain), jargs)


def test_invalid_task_name_raises_alike():
    with pytest.raises(jerrors.InvalidTaskNameError) as ref:
        jcu.retrieve_cfg_paths("Cartpole")
    with pytest.raises(terrors.InvalidTaskNameError) as ours:
        tcu.load_cfg("Cartpole")
    assert str(ours.value) == str(ref.value) and ours.value.task_name == "Cartpole"
    assert terrors.VALID_TASK_NAMES == jerrors.VALID_TASK_NAMES
