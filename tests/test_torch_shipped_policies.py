"""The shipped D4 policies in the port.

The Orbax checkpoints under ``resources/policies/`` need JAX, Orbax and
tensorstore, which the GPU machine does not have, so three of them are
carried across as weights-only ``.npz`` files under
``leibnizgym_tpu_torch/resources/policies/`` (float32 leaves under their
``/``-joined tree paths, plus ``curriculum_level``, ``epoch`` and
``frame``). ``export_npz`` makes them with the JAX ``Runner.restore``;
regenerate all three with

    python tests/test_torch_shipped_policies.py

Checks: each npz equals its Orbax source leaf for leaf; the torch actor
restored from it gives the flax actor's action on the same observations
(1e-5); a 20-step replay at 32 envs on the CPU gives finite, in-range
actions; and, marked slow, the twin of
``tests/test_shipped_policies.py::test_d4_policy_solves_goals`` in the port.
"""

import os
import sys
import tempfile

import numpy as np
import pytest
import torch

from leibnizgym_tpu_torch.config.presets import parse_cli, update_cfg
from leibnizgym_tpu_torch.learning.runner import Runner
from leibnizgym_tpu_torch.scripts.eval_policy import record_goals, window_solve_rate

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORBAX_DIR = os.path.join(ROOT, "resources", "policies")
NPZ_DIR = os.path.join(ROOT, "leibnizgym_tpu_torch", "resources", "policies")
# policy -> (gym preset, overrides it was trained under)
POLICIES = {
    "d4_dr_cone_best_curriculum": ("trifinger_difficulty_4_curriculum_dr", ()),
    "d4_best_curriculum": ("trifinger_difficulty_4_curriculum",
                           ("gym.arena.profile=cylinder",)),
    "d4_rotating_best_curriculum": ("trifinger_difficulty_4_curriculum_rotating", ()),
}
EXPORTED = ("ac_params", "cv_params", "curriculum_level", "epoch", "frame")


def npz_path(name: str) -> str:
    return os.path.join(NPZ_DIR, name + ".npz")


def _flatten(tree, prefix: str) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def export_npz(name: str, out_dir: str = NPZ_DIR) -> str:
    """Restore the Orbax checkpoint ``name`` with the JAX ``Runner.restore``
    and write its weights as ``<out_dir>/<name>.npz``."""
    from leibnizgym_tpu.config.presets import parse_cli as jparse_cli, update_cfg as jupdate_cfg
    from leibnizgym_tpu.learning.runner import Runner as JaxRunner

    gym, overrides = POLICIES[name]
    cfg = jupdate_cfg(jparse_cli([f"gym={gym}", "args.num_envs=4", "args.play=True",
                                  *overrides]))
    with tempfile.TemporaryDirectory() as logdir:
        runner = JaxRunner(cfg["gym"], cfg["rlg"]["params"], logdir=logdir, seed=0,
                           verbose=False)
        runner.reset()
        runner.restore(os.path.join(ORBAX_DIR, name))
        payload = runner._ckpt_payload()
    flat = {}
    for key in ("ac_params", "cv_params"):
        flat.update({k: np.asarray(v, np.float32) for k, v in _flatten(payload[key], key).items()})
    flat["curriculum_level"] = np.asarray(payload["curriculum_level"], np.float32)
    flat["epoch"] = np.asarray(payload["epoch"], np.int64)
    flat["frame"] = np.asarray(payload["frame"], np.int64)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name + ".npz")
    np.savez(path, **flat)
    return path


def _orbax_leaves(name: str) -> dict:
    """The Orbax checkpoint's leaves, restored onto the CPU from its own
    metadata (its stored shardings name the TPU it was written on)."""
    import jax
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    path = os.path.join(ORBAX_DIR, name)
    meta = ckptr.metadata(path)
    meta = getattr(meta, "item_metadata", meta)
    cpu = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    template = jax.tree.map(lambda m: jax.ShapeDtypeStruct(m.shape, m.dtype, sharding=cpu),
                            meta)
    tree = ckptr.restore(path, template)
    return {k: np.asarray(v) for key in EXPORTED
            for k, v in _flatten(tree[key], key).items()}


def _runner(tmp_path, name: str, num_envs: int) -> Runner:
    gym, overrides = POLICIES[name]
    cfg = update_cfg(parse_cli([f"gym={gym}", f"args.num_envs={num_envs}", "args.play=True",
                                *overrides]))
    runner = Runner(cfg["gym"], cfg["rlg"]["params"], logdir=str(tmp_path), seed=0,
                    device="cpu")
    runner.reset()
    runner.restore(npz_path(name))
    return runner


@pytest.mark.parametrize("name", list(POLICIES))
def test_npz_equals_orbax_source(name):
    pytest.importorskip("orbax.checkpoint")
    src = _orbax_leaves(name)
    with np.load(npz_path(name)) as z:
        npz = {k: z[k] for k in z.files}
    assert set(npz) == set(src)
    for k, v in src.items():
        assert npz[k].shape == v.shape, k
        assert np.array_equal(npz[k], v.astype(npz[k].dtype)), k
        assert npz[k].dtype in (np.float32, np.int64), k
    assert float(npz["curriculum_level"]) == 1.0  # each reached the last level


@pytest.mark.parametrize("name", list(POLICIES))
def test_torch_actor_matches_flax(name, tmp_path):
    import jax
    import jax.numpy as jnp

    from leibnizgym_tpu.models.networks import ActorCritic as FlaxActorCritic

    runner = _runner(tmp_path, name, 16)
    cfg = runner.ppo_cfg
    with np.load(npz_path(name)) as z:
        leaves = {k[len("ac_params/"):]: z[k] for k in z.files if k.startswith("ac_params/")}
    params = {}
    for path, v in leaves.items():
        *parents, leaf = path.split("/")
        node = params
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    flax_ac = FlaxActorCritic(action_dim=9, units=cfg.units, log_std_min=cfg.log_std_min)
    # observations the policy meets: a reset and 4 steps of its own actions
    policy = runner.make_policy(deterministic=True)
    env = runner.wrap_env()
    seen = [env.reset()]
    for _ in range(4):
        seen.append(env.step(policy(seen[-1]))[0])
    obs = torch.clamp(torch.cat(seen), -cfg.clip_obs, cfg.clip_obs)
    mu, _, _ = flax_ac.apply(params, jnp.asarray(obs.numpy()))
    ref = np.clip(np.asarray(jax.device_get(mu)), -cfg.clip_actions, cfg.clip_actions)
    action = policy(obs).numpy()
    assert np.abs(action - ref).max() <= 1e-5
    # before the clip too (most of these policies' actions sit on it)
    with torch.no_grad():
        mu_t = runner.ts.actor_critic(obs)[0].numpy()
    mu = np.asarray(jax.device_get(mu))
    assert (np.abs(mu_t - mu) <= 1e-5 * np.maximum(1.0, np.abs(mu))).all()
    assert runner._cur_level == 1.0 and runner.ts.epoch > 0


@pytest.mark.parametrize("name", list(POLICIES))
def test_replay_runs_on_cpu(name, tmp_path):
    """20 deterministic steps at 32 envs at level 1.0: finite obs, finite
    actions within the action clip."""
    runner = _runner(tmp_path, name, 32)
    env = runner.wrap_env()
    policy = runner.make_policy(deterministic=True, curriculum_level=1.0)
    obs = env.reset()
    for _ in range(20):
        action = policy(obs)
        assert bool(torch.isfinite(action).all()) and float(action.abs().max()) <= 1.0
        obs, _, _, _ = env.step(action)
    assert obs.shape == (32, 89) and bool(torch.isfinite(obs).all())
    if runner.static.dr_activate:
        assert float(runner.env.state.scene.cube_mass.std()) > 0


@pytest.mark.slow  # ~2 min: 300 steps of the full-size env on the CPU
def test_d4_policy_solves_goals(tmp_path):
    """The twin of tests/test_shipped_policies.py::test_d4_policy_solves_goals:
    the cylinder-arena flagship policy solves >= 90% of its goals at full
    difficulty, deterministic, in the port."""
    runner = _runner(tmp_path, "d4_best_curriculum", 32)
    succ, _, _, _ = record_goals(runner, 300, level=1.0)  # < episode_length
    solved, attempts, rate = window_solve_rate(succ, fair_age=50)
    assert solved >= 200, f"policy solved only {solved} goals in 300 steps"
    assert rate >= 0.90, f"per-goal solve rate {rate:.3f} ({solved}/{attempts}) below 0.90"


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    for policy in (sys.argv[1:] or POLICIES):
        print(export_npz(policy), flush=True)
