"""Port parity: the float32 env against the recorded golden trajectories.

tests/golden/traj_d1_seed0{,_cone}.npz were recorded by the JAX package on
the CPU (16 envs, 50 steps, D1, torque). The port starts from the
reference's reset draws and takes the reference's reset / goal draws at
every step (the key splits of ``TrifingerEnv.reset`` and ``env_step``), on
the CPU, so through the plain physics step.

- Free-running: 50 steps of ``env_step`` with the golden action stream; q,
  cube_pos and cube_quat within 2e-4 at every step, the goldens' own bound
  (tests/test_golden_trajectory.py).
- Formulas on the golden states: each step's physics result is replaced by
  the recorded state, so everything downstream of the physics (observation
  assembly and scaling, rewards, success and goal resets) is held to the
  recording alone. obs within 2e-4. The reward within 2e-3: the recorded
  float32 rewards carry their own rounding, up to 1.1e-3 from the same
  formulas evaluated in float64 on the same states (the rate terms weigh a
  difference of tip distances by 750), so 2e-4 holds only for a replay that
  rounds exactly as XLA did.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from leibnizgym_tpu_torch.envs.trifinger import env as tenv
from leibnizgym_tpu_torch.ops.types import PhysicsState
from test_torch_common import STATE_FIELDS, max_diff

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
GOLDENS = ["traj_d1_seed0.npz", "traj_d1_seed0_cone.npz"]


def _start(fname):
    """(data, meta, env, state after the reference's reset, key)."""
    data = np.load(os.path.join(GOLDEN_DIR, fname), allow_pickle=True)
    meta = json.loads(str(data["meta"]))
    n = meta["num_envs"]
    env = tenv.TrifingerEnv(config={
        "num_instances": n, "task_difficulty": meta["difficulty"],
        "command_mode": "torque", "seed": meta["seed"],
        "arena": {"profile": meta.get("arena", "cylinder")},
        "sim": {"substeps": meta["substeps"],
                "physx": {"num_position_iterations": meta["iterations"],
                          "tpu_solver": meta.get("solver", "pgs")}},
    }, device="cpu", verbose=False)
    # the reference env's keys: reset() splits the seed key, env_reset splits
    # again and draws the init block; each step splits the state key in 3
    sub = jax.random.split(jax.random.PRNGKey(meta["seed"]))[1]
    key, k_init = jax.random.split(sub)
    u0 = np.array(jax.random.uniform(k_init, (n, 25)))
    state, _ = tenv.env_reset(env.static, env.params, torch.as_tensor(u0))
    return data, meta, env, state, key


def _draws(key, n):
    key, k_reset, k_goal = jax.random.split(key, 3)
    return key, (torch.as_tensor(np.array(jax.random.uniform(k_reset, (n, 25)))), None,
                 torch.as_tensor(np.array(jax.random.uniform(k_goal, (n, 25)))), None)


@pytest.mark.parametrize("fname", GOLDENS)
def test_port_matches_golden(fname):
    data, meta, env, state, key = _start(fname)
    for t in range(meta["steps"]):
        key, draws = _draws(key, meta["num_envs"])
        state, obs, _, _, _, _ = tenv.env_step(
            env.static, env.params, state, torch.as_tensor(data["action"][t]), draws)
        for name, value in (("q", state.physics.q), ("cube_pos", state.physics.cube_pos),
                            ("cube_quat", state.physics.cube_quat)):
            err = max_diff(data[name][t], value)
            assert err < 2e-4, f"{fname} step {t} {name}: {err}"
        assert bool(torch.isfinite(obs).all())


@pytest.mark.parametrize("fname", GOLDENS)
def test_port_formulas_on_golden_states(fname, monkeypatch):
    data, meta, env, state, key = _start(fname)
    simulate = tenv._simulate
    for t in range(meta["steps"]):
        recorded = PhysicsState(*(torch.as_tensor(data[k][t]) for k in STATE_FIELDS))

        def replay(static, physics, tau, scene, n_calls, recorded=recorded):
            _, wrench = simulate(static, physics, tau, scene, n_calls)
            return recorded, wrench

        monkeypatch.setattr(tenv, "_simulate", replay)
        key, draws = _draws(key, meta["num_envs"])
        state, obs, _, reward, _, _ = tenv.env_step(
            env.static, env.params, state, torch.as_tensor(data["action"][t]), draws)
        assert max_diff(data["obs"][t], obs) < 2e-4, f"{fname} step {t} obs"
        assert max_diff(data["reward"][t], reward) < 2e-3, f"{fname} step {t} reward"
