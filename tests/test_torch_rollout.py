"""Port parity: networks, GAE and the PPO rollout (``models/networks.py``,
``learning/ppo.py``, ``convert.py``).

- ``ActorCritic`` / ``CentralValue`` with flax params carried over by
  ``convert.flax_params_to_state_dict`` against flax ``apply`` on the same
  seeded inputs, float32, 1e-5 (float32 matmuls summed in another order).
- ``gae`` against ``ppo._gae``: the same float32 operations in the same
  order, so the two agree to float32 rounding (rtol 1e-6).
- A 16-env, horizon-4 ``rollout`` against a JAX loop of ``env_step`` plus
  flax ``apply``, as the reference's rollout scan runs them, with the same
  injected action noise and the reference's reset and goal draws. The env
  runs in float64 on both sides (see test_torch_env.py for why); flax casts
  the network outputs to float32, so mu, log_std and the values agree to
  float32 rounding (1e-6) and the env outputs to 2e-4, the goldens' bound.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leibnizgym_tpu.config.presets import rlg_asymm_config
from leibnizgym_tpu.envs.trifinger import env as jenv
from leibnizgym_tpu.learning import ppo as jppo
from leibnizgym_tpu.models import networks as jnets
from leibnizgym_tpu_torch.convert import env_state_from_jax, flax_params_to_state_dict
from leibnizgym_tpu_torch.envs.trifinger import env as tenv
from leibnizgym_tpu_torch.learning import ppo as tppo
from leibnizgym_tpu_torch.models import networks as tnets
from test_torch_common import max_diff

torch.set_num_threads(1)

OBS, STATES, ACT = 41, 113, 9


def _flax_pair(seed: int, dtype=jnp.float32):
    """Flax actor-critic and central value, initialised from ``seed``."""
    ac = jnets.ActorCritic(action_dim=ACT, dtype=dtype)
    cv = jnets.CentralValue(dtype=dtype)
    k_ac, k_cv = jax.random.split(jax.random.PRNGKey(seed))
    ac_params = ac.init(k_ac, jnp.zeros((1, OBS), dtype))
    cv_params = cv.init(k_cv, jnp.zeros((1, STATES), dtype))
    return ac, ac_params, cv, cv_params


def _torch_pair(ac_params, cv_params, dtype=torch.float32):
    ac = tnets.ActorCritic(OBS, ACT)
    cv = tnets.CentralValue(STATES)
    ac.load_state_dict(flax_params_to_state_dict(jax.device_get(ac_params)))
    cv.load_state_dict(flax_params_to_state_dict(jax.device_get(cv_params)))
    return ac.to(dtype), cv.to(dtype)


def test_networks_match_flax():
    ac, ac_params, cv, cv_params = _flax_pair(0)
    # a non-zero log_std so that its clip and broadcast are exercised
    ac_params = {"params": dict(ac_params["params"], log_std=jnp.linspace(-0.5, 0.3, ACT))}
    tac, tcv = _torch_pair(ac_params, cv_params)
    rng = np.random.default_rng(0)
    obs = rng.uniform(-5, 5, (64, OBS)).astype(np.float32)
    states = rng.uniform(-5, 5, (64, STATES)).astype(np.float32)
    ref_mu, ref_ls, ref_v = ac.apply(ac_params, jnp.asarray(obs))
    ref_cv = cv.apply(cv_params, jnp.asarray(states))
    with torch.no_grad():
        mu, ls, v = tac(torch.as_tensor(obs))
        cvv = tcv(torch.as_tensor(states))
    for name, a, b in (("mu", ref_mu, mu), ("log_std", ref_ls, ls), ("value", ref_v, v),
                       ("central_value", ref_cv, cvv)):
        assert max_diff(a, b) < 1e-5, name
    action = rng.normal(size=(64, ACT)).astype(np.float32)
    ref_nlp = jnets.gaussian_neglogp(ref_mu, ref_ls, jnp.asarray(action))
    assert max_diff(ref_nlp, tnets.gaussian_neglogp(mu, ls, torch.as_tensor(action))) < 1e-4


def test_network_init_statistics():
    """Random init follows flax's truncated-normal variance scaling: the
    weight variance is scale / fan_in (2 in the towers, 0.02 in the mu head),
    cut at two of the untruncated standard deviations; biases and log_std
    are zero. The variance is held to three standard errors of its
    estimate, 3 * sqrt(2 / samples)."""
    gen = torch.Generator().manual_seed(0)
    ac = tnets.ActorCritic(OBS, ACT, generator=gen)
    for name in ("actor_0", "actor_1", "critic_2", "mu"):
        layer, scale = getattr(ac, name), 0.02 if name == "mu" else 2.0
        w = layer.weight.detach()
        std = (scale / w.shape[1]) ** 0.5
        assert abs(float(w.var()) / std**2 - 1.0) < 3.0 * (2.0 / w.numel()) ** 0.5, name
        assert float(w.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-6, name
        assert torch.count_nonzero(layer.bias) == 0
    assert torch.count_nonzero(ac.log_std) == 0


def test_ppo_config_subset_matches_reference():
    params = rlg_asymm_config()["params"]
    ref = jppo.PPOConfig.from_rlg_params(params, 8192)
    port = tppo.PPOConfig.from_rlg_params(params, 8192)
    for f in dataclasses.fields(tppo.PPOConfig):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.horizon == 32
    # frame stacking is ported; num_actors is the default minibatch size
    stacked = {k: v for k, v in params["config"].items() if k != "minibatch_size"}
    port = tppo.PPOConfig.from_rlg_params({"config": dict(stacked, frames=3)}, 64)
    assert port.frames == 3 and port.minibatch_size == 64


@pytest.mark.parametrize("seed", [0, 1])
def test_gae_matches_reference(seed):
    rng = np.random.default_rng(seed)
    h, n = 32, 64
    rewards = rng.normal(size=(h, n)).astype(np.float32)
    values = rng.normal(size=(h, n)).astype(np.float32)
    dones = (rng.random((h, n)) < 0.1).astype(np.float32)
    last = rng.normal(size=n).astype(np.float32)
    cfg = tppo.PPOConfig()
    ref = jppo._gae(jppo.PPOConfig(), jnp.asarray(rewards), jnp.asarray(values),
                    jnp.asarray(dones), jnp.asarray(last))
    port = tppo.gae(cfg, torch.as_tensor(rewards), torch.as_tensor(values),
                    torch.as_tensor(dones), torch.as_tensor(last))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_rollout_matches_reference_loop():
    # 3-step episodes and a 0.2 m success tolerance, so that the horizon
    # crosses full resets (zero action on the reset step) and goal resets
    # (dones = reset AND goal reset), and the episode bookkeeping counts
    n, horizon = 16, 6
    cfg = {"num_instances": n, "task_difficulty": 1, "command_mode": "torque",
           "asymmetric_obs": True, "seed": 0, "episode_length": 3,
           "termination_conditions": {"success": {"position_tolerance": 0.2}},
           "sim": {"substeps": 2, "physx": {"num_position_iterations": 4,
                                            "tpu_solver": "tgs"}}}
    je = jenv.TrifingerEnv(config=dict(cfg, engine="soa"), verbose=False)
    te = tenv.TrifingerEnv(config=cfg, device="cpu", verbose=False, dtype=torch.float64)
    pcfg = tppo.PPOConfig(horizon=horizon)
    noise = np.random.default_rng(7).normal(size=(horizon, n, ACT))

    with jax.enable_x64(True):
        ac, ac_params, cv, cv_params = _flax_pair(3, jnp.float64)
        ac_params = jax.tree.map(lambda x: x.astype(jnp.float64), ac_params)
        cv_params = jax.tree.map(lambda x: x.astype(jnp.float64), cv_params)
        jparams = jax.tree.map(
            lambda x: x.astype(jnp.float64) if jnp.issubdtype(x.dtype, jnp.floating) else x,
            je.params)
        jstate, jobs = jax.jit(jenv.env_reset, static_argnums=0)(
            je.static, jparams, jax.random.PRNGKey(5))
        start = env_state_from_jax(jax.device_get(jstate))
        obs = jnp.clip(jobs, -pcfg.clip_obs, pcfg.clip_obs)
        states = jnp.zeros((n, STATES))
        step = jax.jit(jenv.env_step, static_argnums=0)
        ref, draws = {k: [] for k in ("obs", "states", "action", "mu", "neglogp",
                                      "value", "reward", "done", "reset",
                                      "goal_reset")}, []
        ep_ret, fin_ret, fin_n = np.zeros(n), np.zeros(n), np.zeros(n, np.int64)
        for t in range(horizon):
            mu, log_std, _ = ac.apply(ac_params, obs)
            value = cv.apply(cv_params, states)
            action = mu + jnp.exp(log_std) * noise[t]
            neglogp = jnets.gaussian_neglogp(mu, log_std, action)
            _, k_reset, k_goal = jax.random.split(jstate.key, 3)
            draws.append((torch.as_tensor(np.array(jax.random.uniform(k_reset, (n, 25)))),
                          None,
                          torch.as_tensor(np.array(jax.random.uniform(k_goal, (n, 25)))),
                          None))
            jstate, nobs, nstates, reward, done, _ = step(
                je.static, jparams, jstate,
                jnp.clip(action, -pcfg.clip_actions, pcfg.clip_actions))
            for k, v in (("obs", obs), ("states", states), ("action", action), ("mu", mu),
                         ("neglogp", neglogp), ("value", value),
                         ("reward", reward * pcfg.reward_shaper_scale), ("done", done),
                         ("reset", jstate.reset_buf), ("goal_reset", jstate.goal_reset_buf)):
                ref[k].append(np.asarray(v))
            finished = np.asarray(jstate.reset_buf)
            ep_ret += np.asarray(reward)
            fin_ret = np.where(finished, ep_ret, fin_ret)
            fin_n += finished
            ep_ret = np.where(finished, 0.0, ep_ret)
            obs = jnp.clip(nobs, -pcfg.clip_obs, pcfg.clip_obs)
            states = jnp.clip(nstates, -pcfg.clip_obs, pcfg.clip_obs)
        last_value = np.asarray(cv.apply(cv_params, states))
        ref_advs = np.asarray(jppo._gae(
            jppo.PPOConfig(), jnp.asarray(np.stack(ref["reward"])),
            jnp.asarray(np.stack(ref["value"])), jnp.asarray(np.stack(ref["done"])),
            jnp.asarray(last_value, jnp.float64)))

    tac, tcv = _torch_pair(ac_params, cv_params, torch.float64)
    carry = tppo.RolloutCarry.start(start, torch.as_tensor(np.array(jobs)), STATES, pcfg)
    carry, traj = tppo.rollout(pcfg, te.static, te.params, carry, tac, tcv,
                               noise=torch.as_tensor(noise), env_draws=draws)
    tol = {"obs": 2e-4, "states": 2e-4, "reward": 2e-4, "action": 1e-6, "mu": 1e-6,
           "value": 1e-6, "neglogp": 1e-5}
    for k, bound in tol.items():
        err = max_diff(np.stack(ref[k]), getattr(traj, k))
        assert err < bound, f"{k}: {err}"
    assert np.array_equal(np.stack(ref["done"]).astype(np.float64), traj.done.numpy())
    # the horizon did cross full resets, goal resets and dones
    assert np.stack(ref["reset"]).any() and np.stack(ref["goal_reset"]).any()
    assert np.stack(ref["done"]).any()
    assert np.array_equal(fin_n, traj.fin_n.numpy())
    assert max_diff(fin_ret, traj.fin_ret) < 2e-4
    assert max_diff(ep_ret, carry.ep_return) < 2e-4
    assert max_diff(obs, carry.obs) < 2e-4
    assert max_diff(states, carry.states) < 2e-4
    with torch.no_grad():
        advs = tppo.gae(pcfg, traj.reward, traj.value, traj.done, tcv(carry.states))
    assert max_diff(ref_advs, advs) < 2e-4
