"""Port parity: one whole PPO epoch on the real env (``learning/ppo.py``
``train_iteration`` against the reference's ``train_iteration``).

16 envs, horizon 4, 2 + 2 mini-epochs of time-sliced minibatches, D1 in
torque mode with 3-step episodes and a 0.2 m success tolerance, so that the
horizon crosses full resets, goal resets and dones. The env runs in float64
on both sides, as in test_torch_rollout.py (in float32 the two frameworks'
contact solves part by ~1e-4 a step); what it hands the learner (obs,
states, rewards) is cast to float32 on both sides, by a wrapper around
``env_step`` in this test, so the learner runs in float32 as in training.
The reference draws its action noise, env reset blocks and permutations
from its keys; the port gets the same draws, recomputed from the key splits.

Bounds: the env outputs agree to ~1e-9 in float64, so the learner sees the
same data up to the float32 cast; losses and KL agree to float32 rounding
of matmuls and reductions summed in another order (rtol 1e-4, with a
small atol for the near-zero entropy and actor losses); new parameters to
the Adam-aware bound of test_torch_ppo_update.py, with lr_max the largest
lr that 4 steps of x1.5 can reach.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from leibnizgym_tpu.envs.trifinger import env as jenv
from leibnizgym_tpu.learning import ppo as jppo
from leibnizgym_tpu.models import networks as jnets
from leibnizgym_tpu.ops import types as jtypes
from leibnizgym_tpu_torch.convert import flax_params_to_state_dict, train_state_from_jax
from leibnizgym_tpu_torch.envs.trifinger import env as tenv
from leibnizgym_tpu_torch.learning import ppo as tppo
from test_torch_common import max_diff
from test_torch_ppo_update import ACT, OBS, STATES, port_config, reference_draws

torch.set_num_threads(1)

N, H = 16, 4
ENV_CFG = {"num_instances": N, "task_difficulty": 1, "command_mode": "torque",
           "asymmetric_obs": True, "seed": 0, "episode_length": 3,
           "termination_conditions": {"success": {"position_tolerance": 0.2}},
           "sim": {"substeps": 2, "physx": {"num_position_iterations": 4,
                                            "tpu_solver": "tgs"}}}


def _jax_env_step_f32(static, params, state, action):
    state, obs, states, reward, done, info = jenv.env_step(static, params, state, action)
    return (state, obs.astype(jnp.float32), states.astype(jnp.float32),
            reward.astype(jnp.float32), done, info)


def _torch_env_step_f32(static, params, state, action, draws):
    state, obs, states, reward, done, info = tenv.env_step(static, params, state, action, draws)
    return state, obs.float(), states.float(), reward.float(), done, info


def _reset_from_port(te, key):
    """The reference's ``env_reset(static, params, key)`` state and obs, made
    by the port's float64 ``env_reset`` from the reference's reset draw
    (env.py:1112, 516) and handed to the reference as its EnvState. Both
    resets agree to float64 rounding (test_torch_env.py); the port's saves
    the ~30 s of compiling the reference's reset in float64."""
    key, k_init = jax.random.split(key)
    u = torch.as_tensor(np.array(jax.random.uniform(k_init, (N, 25))))
    state, obs = tenv.env_reset(te.static, te.params, u)

    def arrays(obj):
        return {k: jnp.asarray(v.numpy()) for k, v in obj.fields().items()}

    fields = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    fields.update(physics=jtypes.PhysicsState(**arrays(state.physics)),
                  scene=jtypes.SceneParams(**arrays(state.scene)),
                  frames=jnp.asarray(state.frames, jnp.int32), key=key)
    return (jenv.EnvState(**{k: jnp.asarray(v.numpy()) if torch.is_tensor(v) else v
                             for k, v in fields.items()}),
            jnp.asarray(obs.numpy()))


def test_train_iteration_matches_reference_on_the_env(monkeypatch):
    je = jenv.TrifingerEnv(config=dict(ENV_CFG, engine="soa"), verbose=False)
    te = tenv.TrifingerEnv(config=ENV_CFG, device="cpu", verbose=False, dtype=torch.float64)
    jcfg = jppo.PPOConfig(horizon=H, mini_epochs=2, cv_mini_epochs=2, minibatch_size=32,
                          cv_minibatch_size=32, units=(64, 32))
    tcfg = port_config(jcfg)
    assert tppo.minibatch_layout(True, H, N, 32) == (2, 2, True)
    monkeypatch.setattr(jppo, "env_step", _jax_env_step_f32)
    monkeypatch.setattr(tppo, "env_step", _torch_env_step_f32)

    with jax.enable_x64(True):
        jparams = jax.tree.map(
            lambda x: x.astype(jnp.float64) if jnp.issubdtype(x.dtype, jnp.floating) else x,
            je.params)
        jstate, jobs = _reset_from_port(te, jax.random.PRNGKey(5))
        k_ac, k_cv = jax.random.split(jax.random.PRNGKey(3))
        ac_params = jnets.ActorCritic(action_dim=ACT, units=jcfg.units).init(
            k_ac, jnp.zeros((1, OBS), jnp.float32))
        cv_params = jnets.CentralValue(units=jcfg.units).init(
            k_cv, jnp.zeros((1, STATES), jnp.float32))
        ac_tx, cv_tx = jppo.make_optimizers(jcfg)
        jts = jppo.PPOTrainState(
            ac_params=ac_params, cv_params=cv_params, ac_opt_state=ac_tx.init(ac_params),
            cv_opt_state=cv_tx.init(cv_params), lr=jnp.asarray(jcfg.learning_rate, jnp.float32),
            env_state=jstate, obs=jnp.clip(jobs, -5.0, 5.0).astype(jnp.float32),
            states=jnp.zeros((N, STATES), jnp.float32), ep_return=jnp.zeros(N, jnp.float32),
            ep_len=jnp.zeros(N, jnp.int32), key=jax.random.PRNGKey(9),
            epoch=jnp.zeros((), jnp.int32), frame=jnp.zeros((), jnp.float32))
        new_jts, jm = jax.jit(
            lambda ts: jppo.train_iteration(jcfg, je.static, jparams, ts))(jts)
        # the env's reset and goal blocks of each step (env.py:980)
        key, draws = jstate.key, []
        for _ in range(H):
            key, k_reset, k_goal = jax.random.split(key, 3)
            draws.append((torch.as_tensor(np.array(jax.random.uniform(k_reset, (N, 25)))), None,
                          torch.as_tensor(np.array(jax.random.uniform(k_goal, (N, 25)))), None))
        noise, perms = reference_draws(tcfg, jts.key, N, H, True)
        jts, new_jts, jm = jax.device_get((jts, new_jts, jm))

    assert noise.dtype == torch.float64  # x64 normals: the action is float64 on both sides
    tts = train_state_from_jax(jts, tcfg, te.static)
    tm = tppo.train_iteration(tcfg, te.static, te.params, tts, noise=noise, env_draws=draws,
                              perms=perms)

    assert set(tm) == set(jm)
    assert float(jm["episodes/finished_count"]) > 0  # the horizon crossed resets
    for k in ("losses/total", "losses/a_loss", "losses/c_loss", "losses/entropy",
              "losses/cv_loss", "info/kl", "info/lr", "rewards/step_mean",
              "episodes/finished_return_sum"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    for k in ("info/epochs", "info/frames", "episodes/finished_count",
              "episodes/finished_success_sum"):
        assert float(tm[k]) == float(jm[k]), k
    for k in jm:
        if k.startswith("env/"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    np.testing.assert_array_equal(tm["episodes/finished_n"].numpy(), jm["episodes/finished_n"])
    assert max_diff(jm["episodes/finished_returns"], tm["episodes/finished_returns"]) < 1e-4

    lr_max = jcfg.learning_rate * 1.5 ** tts.ac_opt.count
    for tree, module, steps in ((new_jts.ac_params, tts.actor_critic, tts.ac_opt.count),
                                (new_jts.cv_params, tts.central_value, tts.cv_opt.count)):
        ref = flax_params_to_state_dict(tree)
        for name, p in module.state_dict().items():
            d = np.abs(p.numpy() - ref[name].numpy())
            assert d.max() <= 2 * lr_max * steps, (name, d.max())
            assert np.mean(d <= 1e-5) >= 0.999, (name, np.mean(d <= 1e-5))
    assert tts.ac_opt.count == 4 and tts.cv_opt.count == 4
    assert max_diff(new_jts.obs, tts.carry.obs) < 1e-5
    assert max_diff(new_jts.states, tts.carry.states) < 1e-5
    assert max_diff(new_jts.env_state.physics.q, tts.carry.env_state.physics.q) < 1e-6
