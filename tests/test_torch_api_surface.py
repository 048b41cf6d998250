"""The port's public surface against the JAX package's.

- An ``ast`` walk of every module that both packages have: its public
  functions, classes, methods, aliases and ``__all__`` exports, each
  callable's parameter names in order, and each dataclass's fields. Every
  difference must be one of the deliberate differences named in
  ``DELIBERATE``, with the port's exact parameters; any other difference is a
  fault, and so is an entry of the list that no longer differs.
- Parity cases on a 2-env D1 env against the JAX package: ``VecTaskPython``
  (positional ``rl_device``, the clipping of obs, states and actions, the
  spaces, ``str``), the ``EnvBase`` shape and gravity getters,
  ``TrifingerEnv``'s positional ``visualize``, ``PhysicsState.default``
  unbatched and batched.
- The packages whose ``__init__`` exports the reference's names, and the
  modules they import, import first in a fresh process.
- ``Runner.save(name, ts)`` of a ``TrainState``, restored bit-identically,
  and ``save(..., wait=False)`` followed by ``flush_saves()``.
"""

import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leibnizgym_tpu.envs.trifinger import env as jenv
from leibnizgym_tpu.ops import types as jtypes
from leibnizgym_tpu.wrappers import vec_task as jvec
from leibnizgym_tpu_torch.envs.trifinger import env as tenv
from leibnizgym_tpu_torch.ops import types as ttypes
from leibnizgym_tpu_torch.wrappers import vec_task as tvec

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = os.path.join(ROOT, "leibnizgym_tpu"), os.path.join(ROOT, "leibnizgym_tpu_torch")

# the deliberate differences, by kind
KEY = "a JAX key becomes a torch.Generator (or the seed it is made from)"
DRAWS = "the function takes injected draws in place of a key"
ADDED = "an added device / dtype / shard / backend / timeout parameter"
RUNNER_DEVICE = "Runner(devices=) becomes device="
DRYRUN = "run_dryrun(n_devices) becomes (n_processes, device)"
NO_MESH = "make_train_step_for_dryrun has no mesh"
DATASHARD = "make_mesh / shard_batch_pytree are replaced by DataShard"
FORWARD = "a flax module's __call__ is the torch module's forward"
MXU = "the MXU packing functions of models/networks.py:128-226"
XLA_KNOBS = ("PPOConfig's XLA scheduling knobs, which the port reads from the "
             "config and ignores")
NETS = "make_networks / make_optimizers take the modules and a generator"
TORCH_MODULE = ("a flax module's fields are the torch module's constructor "
                "arguments, with the input width flax infers and a generator")

# (module, name) -> (kind, the port's parameters, or None where the port has
# no such name)
DELIBERATE = {
    ("dr/__init__.py", "sample_scene_params"): (KEY, ("generator", "n", "base", "ranges")),
    ("envs/trifinger/sample.py", "random_xy"):
        (KEY, ("generator", "num", "max_com_distance_to_center", "device", "dtype")),
    ("envs/trifinger/sample.py", "random_z"):
        (KEY, ("generator", "num", "min_height", "max_height", "device", "dtype")),
    ("envs/trifinger/sample.py", "random_yaw_orientation"):
        (KEY, ("generator", "num", "device", "dtype")),
    ("envs/trifinger/sample.py", "random_orientation"):
        (KEY, ("generator", "num", "device", "dtype")),
    ("envs/trifinger/sample.py", "random_angular_vel"):
        (KEY, ("generator", "num", "magnitude_stdev", "device", "dtype")),
    ("learning/ppo.py", "init_train_state"):
        (KEY, ("cfg", "static", "params", "seed", "shard")),
    ("envs/trifinger/env.py", "EnvState"): (KEY, "fields without key"),
    ("envs/trifinger/env.py", "env_reset"):
        (DRAWS, ("static", "params", "u", "norm", "dr_blocks", "obs_noise")),
    ("envs/trifinger/env.py", "env_step"):
        (DRAWS, ("static", "params", "state", "action", "draws")),
    ("envs/trifinger/env.py", "TrifingerEnv.reset"): (DRAWS, ("self", "draws")),
    ("envs/trifinger/env.py", "TrifingerEnv.step"): (DRAWS, ("self", "action", "draws")),
    ("learning/ppo.py", "train_iteration"):
        (DRAWS, ("cfg", "static", "env_params", "ts", "noise", "env_draws", "perms",
                 "on_phase")),
    ("envs/trifinger/env.py", "TrifingerEnv.__init__"):
        (ADDED, ("self", "config", "device", "verbose", "visualize", "dtype", "shard")),
    ("envs/trifinger/env.py", "build_params"):
        (ADDED, ("static", "object_dims", "arena", "object_density", "device", "dtype")),
    ("envs/trifinger/env.py", "build_static"): (ADDED, ("config", "device")),
    ("envs/trifinger/env.py", "EnvStatic"): (ADDED, "fields with num_envs_global"),
    ("envs/trifinger/sample.py", "default_orientation"): (ADDED, ("num", "device", "dtype")),
    ("learning/train.py", "run_training"):
        (ADDED, ("task_cfg", "agent_cfg", "logdir", "seed", "train", "checkpoint",
                 "max_epochs", "play_steps", "verbose", "watchdog_timeout", "visualize",
                 "device")),
    ("ops/generic_chain.py", "chain_default_state"): (ADDED, ("chain", "n", "q0", "device",
                                                              "dtype")),
    ("ops/types.py", "PhysicsState.default"): (ADDED, ("cls", "batch_shape", "device", "dtype")),
    ("ops/types.py", "SceneParams.default"):
        (ADDED, ("cls", "object_size", "object_density", "object_shape", "device", "dtype")),
    ("parallel/mesh.py", "initialize_distributed"):
        (ADDED, ("coordinator_address", "num_processes", "process_id", "backend", "timeout")),
    ("utils/helpers.py", "set_seed"): (ADDED, ("seed", "device")),
    ("learning/runner.py", "Runner.__init__"):
        (RUNNER_DEVICE, ("self", "task_cfg", "agent_params", "logdir", "seed", "verbose",
                         "device", "visualize")),
    ("parallel/dryrun.py", "run_dryrun"): (DRYRUN, ("n_processes", "device")),
    ("learning/train.py", "make_train_step_for_dryrun"): (NO_MESH, ("env", "frames")),
    ("parallel/mesh.py", "make_mesh"): (DATASHARD, None),
    ("parallel/mesh.py", "shard_batch_pytree"): (DATASHARD, None),
    ("parallel/__init__.py", "make_mesh"): (DATASHARD, None),
    ("parallel/__init__.py", "shard_batch_pytree"): (DATASHARD, None),
    ("models/networks.py", "ActorCritic.__call__"): (FORWARD, None),
    ("models/networks.py", "CentralValue.__call__"): (FORWARD, None),
    ("models/networks.py", "stack_fused"): (MXU, None),
    ("models/networks.py", "unstack_fused"): (MXU, None),
    ("models/networks.py", "fused_forward"): (MXU, None),
    ("models/networks.py", "fused_log_std"): (MXU, None),
    ("models/networks.py", "ActorCritic"):
        (TORCH_MODULE, "fields as __init__(obs_dim, ..., generator)"),
    ("models/networks.py", "CentralValue"):
        (TORCH_MODULE, "fields as __init__(state_dim, ..., generator)"),
    ("learning/ppo.py", "PPOConfig"):
        (XLA_KNOBS, "fields without fused_update, fused_rollout, update_unroll"),
    ("learning/ppo.py", "make_networks"): (NETS, ("cfg", "static", "device", "generator")),
    ("learning/ppo.py", "make_optimizers"): (NETS, ("cfg", "actor_critic", "central_value")),
}
# the torch modules' constructor arguments beside the flax fields
TORCH_MODULE_EXTRA = {"ActorCritic": {"obs_dim", "generator"},
                      "CentralValue": {"state_dim", "generator"}}
FIELD_DIFFS = {"EnvState": ({"key"}, set()), "EnvStatic": (set(), {"num_envs_global"}),
               "PPOConfig": ({"fused_update", "fused_rollout", "update_unroll"}, set())}


def _modules(root):
    return {os.path.relpath(os.path.join(d, f), root)
            for d, _, files in os.walk(root) for f in files if f.endswith(".py")}


def _params(fn) -> tuple:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args]
    names += ["*" + a.vararg.arg] if a.vararg else []
    names += [x.arg for x in a.kwonlyargs]
    names += ["**" + a.kwarg.arg] if a.kwarg else []
    return tuple(names)


def _public(name: str) -> bool:
    return not name.startswith("_") or name in ("__init__", "__call__", "__str__")


def surface(path: str):
    """Public callables -> parameters (classes, aliases and exports -> None),
    and each class's annotated fields."""
    tree = ast.parse(open(path).read())
    names, fields = {}, {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(node.name):
            names[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            names[node.name] = None
            fields[node.name] = [m.target.id for m in node.body
                                 if isinstance(m, ast.AnnAssign)
                                 and isinstance(m.target, ast.Name)]
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(m.name):
                    names[f"{node.name}.{m.name}"] = _params(m)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if not isinstance(target, ast.Name):
                    continue
                if target.id == "__all__":
                    for e in node.value.elts:
                        names.setdefault(e.value, None)
                elif isinstance(node.value, ast.Name) and not target.id.startswith("_"):
                    names[target.id] = None  # an alias of a class or function
    return names, fields


def surface_differences():
    """Each difference of the port's surface from the reference's:
    (module, name, what the reference has, what the port has)."""
    out = []
    for mod in sorted(_modules(REF) & _modules(PORT)):
        (rn, rf), (pn, pf) = surface(os.path.join(REF, mod)), surface(os.path.join(PORT, mod))
        for name in sorted(rn):
            if name not in pn:
                out.append((mod, name, rn[name], None))
            elif rn[name] != pn[name] and rn[name] is not None:
                out.append((mod, name, rn[name], pn[name]))
        for cls in sorted(rf):
            if cls not in pf or rf[cls] == pf[cls]:
                continue
            if not pf[cls] and cls in TORCH_MODULE_EXTRA:
                init = set(pn.get(f"{cls}.__init__") or ()) - {"self"}
                if set(rf[cls]) <= init and init - set(rf[cls]) == TORCH_MODULE_EXTRA[cls]:
                    out.append((mod, cls, tuple(rf[cls]), "fields as __init__"))
                    continue
            out.append((mod, cls, tuple(rf[cls]), tuple(pf[cls])))
    return out


def test_public_surface_matches_the_reference_but_for_the_named_differences():
    """Every difference of names, parameters or fields is a named deliberate
    one with the port's exact parameters, and every named one still
    differs."""
    faults, seen = [], set()
    for mod, name, ref, port in surface_differences():
        entry = DELIBERATE.get((mod, name))
        if entry is None:
            faults.append(f"{mod} {name}: reference {ref}, port {port}")
            continue
        seen.add((mod, name))
        kind, expected = entry
        if isinstance(expected, str):  # fields: the named set of changes only
            if name in FIELD_DIFFS:
                gone, added = FIELD_DIFFS[name]
                if set(ref) - set(port) != gone or set(port) - set(ref) != added or \
                        [f for f in ref if f not in gone] != [f for f in port if f not in added]:
                    faults.append(f"{mod} {name} ({kind}): fields {port}")
            elif port != "fields as __init__":
                faults.append(f"{mod} {name} ({kind}): fields {port}")
        elif port != expected:
            faults.append(f"{mod} {name} ({kind}): port {port}, named as {expected}")
    stale = sorted(set(DELIBERATE) - seen)
    # only the TPU plugin pin and the Pallas launcher, which the CUDA kernel
    # replaces, have no module of the same path in the port
    assert _modules(REF) - _modules(PORT) == {"ops/pallas_engine.py", "utils/platform.py"}
    assert not faults, "undeclared differences from the reference:\n" + "\n".join(faults)
    assert not stale, f"named differences that no longer differ: {stale}"


@pytest.mark.parametrize("package, names", [
    ("learning", ["PPOConfig", "PPOTrainState", "init_train_state", "train_iteration",
                  "AverageMeter", "Runner", "run_training"]),
    ("config", ["GYM_PRESETS", "RLG_PRESETS", "default_config", "parse_cli", "update_cfg"]),
    ("envs.trifinger", ["TRIFINGER_DEFAULT_CONFIG_DICT", "ARENA_RADIUS", "CuboidalObject",
                        "TrifingerDimensions", "EnvParams", "EnvState", "EnvStatic",
                        "TrifingerEnv", "env_reset", "env_step"]),
    ("utils", ["InvalidTaskNameError", "get_resources_dir", "merged_dict", "update_dict",
               "print_debug", "print_dict", "print_error", "print_info", "print_notify",
               "print_warn"]),
])
def test_package_exports_resolve(package, names):
    """The reference's package-level names import from the port's package,
    and ``PPOTrainState`` is the port's ``TrainState``."""
    import importlib

    mod = importlib.import_module(f"leibnizgym_tpu_torch.{package}")
    ref = importlib.import_module(f"leibnizgym_tpu.{package}")
    assert sorted(mod.__all__) == sorted(ref.__all__) == sorted(names)
    for name in names:
        assert getattr(mod, name) is not None, name
    if package == "learning":
        from leibnizgym_tpu_torch.learning import ppo

        assert mod.PPOTrainState is ppo.PPOTrainState is ppo.TrainState


@pytest.mark.parametrize("module", ["convert", "learning", "learning.runner", "learning.ppo",
                                    "envs.trifinger", "config", "utils"])
def test_package_imports_first_in_a_fresh_process(module):
    """Each of these imports first in a new interpreter, and then the
    learning package's exports resolve: they must not close an import cycle
    (``convert`` imports ``learning.ppo``, whose package imports the runner,
    which reads ``convert``)."""
    code = (f"import leibnizgym_tpu_torch.{module}\n"
            "from leibnizgym_tpu_torch.learning import PPOTrainState, Runner, run_training")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-2000:]


# ---------------------------------------------------------------------------
# Parity cases on a 2-env D1 env
# ---------------------------------------------------------------------------

D1 = {"num_instances": 2, "task_difficulty": 1, "command_mode": "torque",
      "asymmetric_obs": True, "sim": {"substeps": 1}}


@pytest.fixture(scope="module")
def envs():
    return (jenv.TrifingerEnv(config=dict(D1, engine="soa"), verbose=False),
            tenv.TrifingerEnv(D1, "cpu", False))


class _FeedTask:
    """Stands in for an env's reset / step / get_state: returns fixed arrays
    and records the action it was given."""

    def __init__(self, task, obs, states, wrap):
        self.task, self.obs, self.states, self.wrap = task, obs, states, wrap
        self.action = None
        task.reset = lambda: wrap(obs)
        task.get_state = lambda: wrap(states)

        def step(action):
            self.action = np.asarray(action)
            return wrap(obs), wrap(np.zeros(2, np.float32)), wrap(np.zeros(2, bool)), {}

        task.step = step


def test_vec_task_positional_rl_device_and_clipping(envs):
    """``VecTaskPython(env, rl_device, clip_obs, clip_actions)`` positional,
    as in the reference: obs, states and actions clipped alike."""
    jx, tx = envs
    rng = np.random.default_rng(0)
    obs = (rng.standard_normal((2, 41)) * 6).astype(np.float32)
    states = (rng.standard_normal((2, 113)) * 6).astype(np.float32)
    action = (rng.standard_normal((2, 9)) * 2).astype(np.float32)
    jvt = jvec.VecTaskPython(jx, "tpu", 2.5, 0.4)
    tvt = tvec.VecTaskPython(tx, "cpu", 2.5, 0.4)
    jfeed, tfeed = _FeedTask(jx, obs, states, jnp.asarray), _FeedTask(tx, obs, states,
                                                                      torch.from_numpy)
    try:
        np.testing.assert_array_equal(tvt.reset().numpy(), np.asarray(jvt.reset()))
        np.testing.assert_array_equal(tvt.get_state().numpy(), np.asarray(jvt.get_state()))
        t_out, j_out = tvt.step(torch.from_numpy(action)), jvt.step(jnp.asarray(action))
        np.testing.assert_array_equal(t_out[0].numpy(), np.asarray(j_out[0]))
        np.testing.assert_array_equal(tfeed.action, jfeed.action)
        assert np.abs(tfeed.action).max() == np.float32(0.4)
        assert np.abs(t_out[0].numpy()).max() == np.float32(2.5)
        # numpy actions too, as jnp.asarray takes them: float64 arrays in the
        # env's float32
        for array in (action, action.astype(np.float64) * 0.3):
            tvt.step(array)
            jvt.step(array)
            assert tfeed.action.dtype == jfeed.action.dtype == np.float32
            np.testing.assert_array_equal(tfeed.action, jfeed.action)
    finally:
        for env in envs:
            for name in ("reset", "get_state", "step"):
                env.__dict__.pop(name, None)
    assert tvt._rl_device == torch.device("cpu")
    assert tvec.VecTaskPython(tx)._rl_device == tx.device  # None: the env's device


def test_vec_task_spaces_str_and_dump_config(envs, tmp_path):
    jx, tx = envs
    jvt, tvt = jvec.VecTaskPython(jx, "tpu", 3.0, 0.5), tvec.VecTaskPython(tx, "cpu", 3.0, 0.5)
    assert str(tvt) == str(jvt)
    assert "Observation clipping  : 3.0" in str(tvt)
    for name in ("observation_space", "state_space", "action_space"):
        js, ts = getattr(jvt, name), getattr(tvt, name)
        assert ts.shape == js.shape and ts.dtype == js.dtype, name
        np.testing.assert_array_equal(ts.low, js.low)
        np.testing.assert_array_equal(ts.high, js.high)
    assert (tvt.num_envs, tvt.num_obs, tvt.num_states, tvt.num_actions) == \
        (jvt.num_envs, jvt.num_obs, jvt.num_states, jvt.num_actions)
    assert tvt.get_number_of_agents() == jvt.get_number_of_agents() == 1
    tvt.dump_config(str(tmp_path / "env_config"))
    assert (tmp_path / "env_config.yaml").exists()


@pytest.mark.parametrize("rl_device", ["meta", torch.device("meta")])
def test_vec_task_refuses_another_device(envs, rl_device):
    """The wrapper moves nothing: naming a device that is not the env's is an
    error, never a quiet copy."""
    with pytest.raises(ValueError, match="not the env's device"):
        tvec.VecTaskPython(envs[1], rl_device)


def test_env_base_getters(envs):
    jx, tx = envs
    for name in ("get_obs_shape", "get_state_shape", "get_action_shape"):
        assert getattr(tx, name)() == getattr(jx, name)(), name
    assert tx.get_obs_shape() == (2, 41) and tx.get_state_shape() == (2, 113)
    assert tx.get_action_shape() == (2, 9)
    jg, tg = jx.get_gravity(), tx.get_gravity()
    assert isinstance(tg, np.ndarray) and tg.dtype == jg.dtype
    np.testing.assert_array_equal(tg, jg)


@pytest.mark.parametrize("visualize", [False, True])
def test_trifinger_env_positional_visualize(visualize):
    """``TrifingerEnv(config, device, verbose, visualize)`` lands
    ``visualize`` where the reference does; dtype stays float32."""
    env = tenv.TrifingerEnv(D1, "cpu", False, visualize)
    ref = jenv.TrifingerEnv(D1, None, False, visualize)
    assert env.visualize is ref.visualize is visualize
    assert env.verbose is ref.verbose is False
    assert env.static.num_envs == 2 and env.dtype == env.params.pd_stiffness.dtype == torch.float32


@pytest.mark.parametrize("batch_shape", [(), (3,), (2, 3)], ids=["unbatched", "1d", "2d"])
def test_physics_state_default(batch_shape):
    """``PhysicsState.default()`` is one unbatched scene and
    ``default(batch_shape)`` a batch, as in the reference; the port's int
    ``n`` still means ``(n,)``."""
    ref = jtypes.PhysicsState.default(batch_shape)
    port = ttypes.PhysicsState.default(batch_shape) if batch_shape else \
        ttypes.PhysicsState.default()
    as_int = ttypes.PhysicsState.default(batch_shape[0]) if len(batch_shape) == 1 else None
    for name in ("q", "qd", "cube_pos", "cube_quat", "cube_linvel", "cube_angvel"):
        r, p = np.asarray(getattr(ref, name)), getattr(port, name)
        assert p.shape == r.shape, name
        assert p.dtype == torch.float32
        np.testing.assert_array_equal(p.numpy(), r.astype(np.float32), err_msg=name)
        if as_int is not None:
            assert torch.equal(getattr(as_int, name), p), name


# ---------------------------------------------------------------------------
# Runner.save with the reference's signature
# ---------------------------------------------------------------------------


def _runner(tmp_path):
    from leibnizgym_tpu_torch.config.presets import parse_cli, update_cfg
    from leibnizgym_tpu_torch.learning.runner import Runner

    cfg = parse_cli([])
    cfg["args"].update(num_envs=8, seed=0)
    cfg = update_cfg(cfg)
    cfg["gym"]["sim"]["substeps"] = 1
    cfg["rlg"]["params"]["config"].update(steps_num=2, mini_epochs=1)
    cfg["rlg"]["params"]["config"]["central_value_config"]["mini_epochs"] = 1
    return Runner(cfg["gym"], cfg["rlg"]["params"], logdir=str(tmp_path), seed=0, device="cpu")


def _learner(runner):
    p = runner._ckpt_payload()
    out = {f"ac.{k}": v for k, v in p["ac_state_dict"].items()}
    out.update({f"cv.{k}": v for k, v in p["cv_state_dict"].items()})
    for part in ("ac_opt_state", "cv_opt_state"):
        out[f"{part}.count"] = p[part]["count"]
        out.update({f"{part}.mu.{k}": v for k, v in p[part]["mu"].items()})
        out.update({f"{part}.nu.{k}": v for k, v in p[part]["nu"].items()})
    out["lr"] = p["lr"]
    return {k: v.detach().clone() for k, v in out.items()}, (p["epoch"], p["frame"])


def test_runner_save_of_a_train_state_restores_bit_identically(tmp_path):
    """``save(name, ts)`` with a ``TrainState`` in the reference's position
    writes that state through the checkpoint payload; ``restore`` gives it
    back bit for bit, and the absolute path is returned."""
    r = _runner(tmp_path / "a")
    r.reset()
    r.train(max_epochs=1)
    trained, counters = _learner(r)
    path = r.save("by_ts", r.ts)
    assert os.path.isabs(path) and os.path.exists(path)
    fresh = _runner(tmp_path / "b")
    fresh.reset()
    fresh.restore(path)
    restored, fresh_counters = _learner(fresh)
    assert restored.keys() == trained.keys() and fresh_counters == counters == (1, 16)
    for k in trained:
        assert torch.equal(restored[k], trained[k]), k


def test_runner_save_without_wait_then_flush(tmp_path):
    """``save(..., wait=False)`` and ``flush_saves()`` as in the reference:
    the file is complete once ``flush_saves`` returns (``torch.save`` is
    synchronous), and equals the default ``save`` of the same state."""
    r = _runner(tmp_path)
    r.reset()
    no_wait = r.save("no_wait", wait=False)
    r.flush_saves()
    default = r.save("default")
    a = torch.load(no_wait, weights_only=True)
    b = torch.load(default, weights_only=True)
    assert a.keys() == b.keys()
    for k, v in a["ac_state_dict"].items():
        assert torch.equal(v, b["ac_state_dict"][k]), k
    assert (a["epoch"], a["frame"]) == (b["epoch"], b["frame"]) == (0, 0)
