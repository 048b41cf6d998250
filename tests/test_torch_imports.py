"""The port imports no JAX and nothing of the JAX package.

The machine the port runs on has no JAX, so every module of
``leibnizgym_tpu_torch`` and ``chip_smoke.py`` must import without it, and
a CPU env step must run without it. The port keeps its own copies of what it
needs from the JAX package (held to it by ``test_torch_copies.py``), so the
JAX package ``leibnizgym_tpu`` itself is blocked too, by its exact top-level
name. A subprocess blocks ``jax``, ``flax``, ``optax``, ``orbax`` and
``leibnizgym_tpu`` with a ``sys.meta_path`` finder, imports every
module of the port (the learner, runner, training entry and CLI, the
robot-variant path and the tool scripts among them) and ``chip_smoke.py``,
steps a 2-env ``TrifingerEnv`` on D1 and on the D4 + DR preset, reads a
shipped ``.npz`` policy, runs the legacy CLI's config loading, a URDF
robot's chain step, a benchmark point, the asset export and a trajectory
dump, steps a 2-env env through the reference engine (``engine:
"reference"``), runs one ``bench`` window and one ``decompose_bench --what
physics`` window, runs ``graft_entry.entry``'s env step, takes a viewer
frame, and trains a 2-env ``Runner`` for one epoch.
"""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "leibnizgym_tpu_torch")
BLOCKED = ("jax", "flax", "optax", "orbax", "leibnizgym_tpu")

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
                   device="cpu", verbose=False)
task = VecTaskPython(env)
obs = task.reset()
obs, reward, dones, _ = task.step(torch.zeros(2, 9))
states = task.get_state()
assert obs.shape == (2, 41) and states.shape == (2, 113) and reward.shape == (2,)
assert bool(torch.isfinite(obs).all()) and bool(torch.isfinite(states).all())
assert float(obs.abs().max()) <= 5.0 and float(states.abs().max()) <= 5.0
for name in ("learning.ppo", "learning.runner", "learning.train", "scripts.train",
             "wrappers.frame_stack", "convert", "dr", "scripts.eval_policy",
             "config.config_utils", "utils.errors", "utils.mdp", "models.urdf",
             "models.chain", "ops.kinematics", "ops.dynamics", "ops.generic_chain",
             "scripts.benchmark", "scripts.asset_tools", "scripts.export_assets",
             "scripts.trifinger_random_action", "scripts.trajectory_parity",
             "parallel.mesh", "parallel.launch", "parallel.dryrun", "graft_entry",
             "utils.viewer", "scripts.replay_viewer", "scripts.multihost_demo",
             "scripts.scaling_bench", "ops.engine", "ops.contact", "bench",
             "scripts.decompose_bench"):
    assert "leibnizgym_tpu_torch." + name in names, name

# the robot-variant path, the legacy CLI and the tools run without JAX
import tempfile
from leibnizgym_tpu_torch.config.config_utils import get_args, load_cfg, update_cfg_from_args
from leibnizgym_tpu_torch.models.chain import chain_from_urdf
from leibnizgym_tpu_torch.ops.generic_chain import chain_default_state, chain_physics_step
from leibnizgym_tpu_torch.scripts import export_assets, trajectory_parity
from leibnizgym_tpu_torch.scripts.benchmark import bench_one

args = get_args(["--num_envs", "4"])
cfg_env, cfg_train = update_cfg_from_args(*load_cfg(args.task, "asymm"), args)
assert cfg_env["num_instances"] == 4
chain = chain_from_urdf("resources/assets/robots/trifingeredu.urdf")
cs = chain_physics_step(chain_default_state(chain, 2, device="cpu"), torch.zeros(2, 9), chain)
assert bool(torch.isfinite(cs.q).all())
assert bench_one(2, 1, 1, True, device="cpu") > 0
with tempfile.TemporaryDirectory() as tmp:
    assert export_assets.main(["--out", tmp]) == 0
    assert trajectory_parity.main(["dump", "--device", "cpu", "--num-envs", "2", "--steps",
                                   "1", "--out", tmp + "/t.npz"]) == 0

# the reference engine steps an env; one bench window and one decompose_bench
# physics window run
from leibnizgym_tpu_torch import bench
from leibnizgym_tpu_torch.ops import physics_step
from leibnizgym_tpu_torch.scripts import decompose_bench
env = TrifingerEnv(config={"num_instances": 2, "command_mode": "torque", "engine": "reference",
                           "sim": {"substeps": 1, "physx": {"num_position_iterations": 2}}},
                   device="cpu", verbose=False)
assert env.static.engine == "reference"
env.reset()
obs = env.step(torch.zeros(2, 9))[0]
assert bool(torch.isfinite(obs).all())
import os
os.environ.update(BENCH_SKIP_LIGHT="1", BENCH_SKIP_SOLVER8="1", BENCH_SKIP_PPO="1",
                  BENCH_NUM_ENVS="2", BENCH_TRIALS="1")
line = bench.main(["--device", "cpu", "--rounds", "1", "--window", "1", "--warmup", "0"])
assert line["value"] > 0 and line["device"] == "cpu"
out = decompose_bench.main(["--device", "cpu", "--num-envs", "2", "--what", "physics",
                            "--rounds", "1", "--length", "1", "--substeps", "1"])
assert out["physics_soa_ms"] > 0 and out["physics_reference_ms"] > 0

# the graft entry's env step and a viewer frame run without JAX
from leibnizgym_tpu_torch.graft_entry import entry
from leibnizgym_tpu_torch.utils.viewer import extract_frame
fn, example = entry("cpu")
assert tuple(fn(*example)[0].shape) == (128, 41)
assert extract_frame(example[0], 5)["tips"].shape == (3, 3)

# the D4 flagship preset (DR, keypoints, curriculum) steps, and a shipped
# policy restores from its npz
from leibnizgym_tpu_torch.config.presets import GYM_PRESETS
import copy
d4 = copy.deepcopy(GYM_PRESETS["trifinger_difficulty_4_curriculum_dr"])
d4.pop("rlg_overrides")
d4.update(num_instances=2, asymmetric_obs=True)
d4["sim"].update(substeps=1, physx={"num_position_iterations": 2})
env = TrifingerEnv(config=d4, device="cpu", verbose=False)
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
    # \b after leibnizgym_tpu excludes leibnizgym_tpu_torch
    pattern = re.compile(r"^\s*(import|from) (jax|flax|optax|orbax|leibnizgym_tpu)\b")
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(PORT):
        paths += [os.path.join(base, f) for f in files if f.endswith(".py")]
    offending = [f"{p}:{i + 1}" for p in paths
                 for i, line in enumerate(open(p, encoding="utf-8")) if pattern.match(line)]
    assert not offending, offending
