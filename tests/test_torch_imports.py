"""The port imports no JAX.

The machine the port runs on has no JAX, so every module of
``leibnizgym_tpu_torch`` and ``chip_smoke.py`` must import without it, and
a CPU env step must run without it. A subprocess blocks ``jax``, ``flax``,
``optax`` and ``orbax`` with a ``sys.meta_path`` finder, imports every
module of the port (the learner, runner, training entry and CLI among
them) and ``chip_smoke.py``, steps a 2-env ``TrifingerEnv`` on D1 and on
the D4 + DR preset, reads a shipped ``.npz`` policy and trains a 2-env
``Runner`` for one epoch.
"""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "leibnizgym_tpu_torch")
BLOCKED = ("jax", "flax", "optax", "orbax")

_GUARDED = r'''
import importlib, importlib.util, pkgutil, sys

BLOCKED = %r

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())

import torch
import leibnizgym_tpu_torch

names = [m.name for m in pkgutil.walk_packages(leibnizgym_tpu_torch.__path__,
                                                "leibnizgym_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))

from leibnizgym_tpu_torch.envs import TrifingerEnv
from leibnizgym_tpu_torch.wrappers.vec_task import VecTaskPython

torch.set_num_threads(1)
env = TrifingerEnv(config={"num_instances": 2, "command_mode": "torque",
                           "asymmetric_obs": True,
                           "sim": {"substeps": 1, "physx": {"num_position_iterations": 2}}},
                   verbose=False)
task = VecTaskPython(env)
obs = task.reset()
obs, reward, dones, _ = task.step(torch.zeros(2, 9))
states = task.get_state()
assert obs.shape == (2, 41) and states.shape == (2, 113) and reward.shape == (2,)
assert bool(torch.isfinite(obs).all()) and bool(torch.isfinite(states).all())
assert float(obs.abs().max()) <= 5.0 and float(states.abs().max()) <= 5.0
for name in ("learning.ppo", "learning.runner", "learning.train", "scripts.train",
             "wrappers.frame_stack", "convert", "dr", "scripts.eval_policy"):
    assert "leibnizgym_tpu_torch." + name in names, name

# the D4 flagship preset (DR, keypoints, curriculum) steps, and a shipped
# policy restores from its npz
from leibnizgym_tpu_torch.config.presets import GYM_PRESETS
import copy
d4 = copy.deepcopy(GYM_PRESETS["trifinger_difficulty_4_curriculum_dr"])
d4.pop("rlg_overrides")
d4.update(num_instances=2, asymmetric_obs=True)
d4["sim"].update(substeps=1, physx={"num_position_iterations": 2})
env = TrifingerEnv(config=d4, verbose=False)
obs = env.reset()
obs, reward, dones, info = env.step(torch.zeros(2, 9))
assert obs.shape == (2, 89) and env.get_state().shape == (2, 161)
assert bool(torch.isfinite(obs).all()) and "env/curriculum_level" in info
from leibnizgym_tpu_torch.convert import checkpoint_from_npz
payload = checkpoint_from_npz("leibnizgym_tpu_torch/resources/policies/d4_best_curriculum.npz")
assert payload["ac_state_dict"]["actor_0.weight"].shape == (400, 89)

# one epoch of the training path: Runner, rollout, GAE, updates, checkpoint
import tempfile
from leibnizgym_tpu_torch.config.presets import default_config, update_cfg
from leibnizgym_tpu_torch.learning.runner import Runner

cfg = default_config()
cfg["args"].update(num_envs=2, seed=0)
cfg = update_cfg(cfg)
cfg["gym"]["sim"].update(substeps=1, physx={"num_position_iterations": 2})
cfg["rlg"]["params"]["config"].update(steps_num=2, mini_epochs=1, frames=2)
with tempfile.TemporaryDirectory() as logdir:
    runner = Runner(cfg["gym"], cfg["rlg"]["params"], logdir=logdir, seed=0, device="cpu")
    runner.train(max_epochs=1)
    assert runner.ts.epoch == 1
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("imported", len(names), "modules")
'''


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _GUARDED % (BLOCKED,)], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "imported" in proc.stdout


def test_no_jax_import_lines():
    pattern = re.compile(r"^\s*(import|from) (jax|flax|optax|orbax)\b")
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(PORT):
        paths += [os.path.join(base, f) for f in files if f.endswith(".py")]
    offending = [f"{p}:{i + 1}" for p in paths
                 for i, line in enumerate(open(p, encoding="utf-8")) if pattern.match(line)]
    assert not offending, offending
