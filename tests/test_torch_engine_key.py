"""Port parity: the env's ``engine`` key (``envs/trifinger/env.py``
``resolve_engine``, ``build_static``, ``_simulate``).

- Resolution as the JAX package's ``build_static`` does it: None is
  ``"soa"`` on the CPU (the JAX package's default off the TPU) and
  ``"pallas"`` (the kernel) on a CUDA device; ``soa``, ``pallas`` and
  ``reference`` pass through; any other value raises the JAX package's
  ``ValueError``, word for word.
- ``_simulate`` steps the engine the key names: ``pallas`` through the
  kernel's wrapper, ``soa`` through the plain version, ``reference``
  through ``ops/engine.py`` (spied here); on CPU tensors ``pallas`` and
  ``soa`` give the same rollout.
- A 4-env D1 env with ``engine: "reference"``: the JAX env's reset state,
  converted, stepped twice by the JAX ``env_step`` and by the port's with
  the JAX draws injected, both in float64; obs, states and reward within
  1e-6, dones equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leibnizgym_tpu.envs.trifinger import env as jenv
from leibnizgym_tpu.envs.trifinger.config import (
    SIM_DEFAULT_CONFIG_DICT as JSIM,
    TRIFINGER_DEFAULT_CONFIG_DICT as JTRI,
)
from leibnizgym_tpu.utils.helpers import merged_dict as jmerged
from leibnizgym_tpu_torch.convert import env_state_from_jax
from leibnizgym_tpu_torch.envs.trifinger import env as tenv
from leibnizgym_tpu_torch.envs.trifinger.config import (
    SIM_DEFAULT_CONFIG_DICT,
    TRIFINGER_DEFAULT_CONFIG_DICT,
)
from leibnizgym_tpu_torch.utils.helpers import merged_dict
from test_torch_common import max_diff

torch.set_num_threads(1)

N = 4
CFG = {"num_instances": N, "command_mode": "torque", "asymmetric_obs": True,
       "sim": {"substeps": 2, "physx": {"num_position_iterations": 4}}}


def _jax_config(engine):
    return jmerged(jmerged(dict(JSIM), JTRI), dict(CFG, engine=engine))


def _port_config(engine):
    return merged_dict(merged_dict(dict(SIM_DEFAULT_CONFIG_DICT), TRIFINGER_DEFAULT_CONFIG_DICT),
                       dict(CFG, engine=engine))


@pytest.mark.parametrize("engine", [None, "soa", "pallas", "reference"])
def test_engine_resolves_as_reference(engine):
    assert jax.default_backend() == "cpu"
    ref = jenv.build_static(_jax_config(engine)).engine
    assert tenv.build_static(_port_config(engine), device="cpu").engine == ref
    expected_card = "pallas" if engine is None else engine
    assert tenv.build_static(_port_config(engine), device="cuda:0").engine == expected_card


@pytest.mark.parametrize("engine", ["bogus", "xla", "PALLAS"])
def test_unknown_engine_raises_reference_error(engine):
    with pytest.raises(ValueError) as ref:
        jenv.build_static(_jax_config(engine))
    with pytest.raises(ValueError) as port:
        tenv.build_static(_port_config(engine), device="cpu")
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="Invalid engine"):
        tenv.TrifingerEnv(config=dict(CFG, engine=engine), device="cpu", verbose=False)


@pytest.mark.parametrize("engine,called", [("pallas", "physics_step_cuda"),
                                           ("soa", "physics_step_plain"),
                                           ("reference", "reference")])
def test_simulate_steps_the_named_engine(monkeypatch, engine, called):
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls.append(name)
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(tenv, "physics_step_cuda", spy("physics_step_cuda",
                                                       tenv.physics_step_cuda))
    monkeypatch.setattr(tenv, "physics_step_plain", spy("physics_step_plain",
                                                        tenv.physics_step_plain))
    monkeypatch.setattr(tenv.reference_engine, "physics_step",
                        spy("reference", tenv.reference_engine.physics_step))
    env = tenv.TrifingerEnv(config=dict(CFG, num_instances=2, engine=engine), device="cpu",
                            verbose=False)
    assert env.static.engine == engine
    env.reset()
    env.step(torch.zeros(2, 9))
    assert calls == [called, called]


def test_pallas_and_soa_agree_on_the_cpu():
    out = []
    for engine in ("pallas", "soa"):
        env = tenv.TrifingerEnv(config=dict(CFG, engine=engine), device="cpu", verbose=False)
        env.seed(3)
        env.reset()
        obs = env.step(torch.full((N, 9), 0.2))[0]
        out.append(obs)
    assert torch.equal(out[0], out[1])


def _jax_draws(key, n):
    """The reset and goal draws of the reference env_step for this key."""
    _, k_reset, k_goal = jax.random.split(key, 3)
    return (np.array(jax.random.uniform(k_reset, (n, 25))),
            np.array(jax.random.uniform(k_goal, (n, 25))))


def test_reference_engine_env_matches_jax():
    je = jenv.TrifingerEnv(config=dict(CFG, engine="reference"), verbose=False)
    te = tenv.TrifingerEnv(config=dict(CFG, engine="reference"), device="cpu", verbose=False,
                           dtype=torch.float64)
    assert je.static.engine == te.static.engine == "reference"
    actions = np.random.default_rng(5).uniform(-1, 1, (2, N, 9))
    with jax.enable_x64(True):
        jparams = jax.tree.map(
            lambda x: x.astype(jnp.float64) if jnp.issubdtype(x.dtype, jnp.floating) else x,
            je.params)
        jstate, _ = jax.jit(jenv.env_reset, static_argnums=0)(je.static, jparams,
                                                              jax.random.PRNGKey(7))
        state = env_state_from_jax(jax.device_get(jstate))
        step = jax.jit(jenv.env_step, static_argnums=0)
        for t, action in enumerate(actions):
            u_reset, u_goal = _jax_draws(jstate.key, N)
            jstate, jo, js, jr, jd, _ = jax.device_get(
                step(je.static, jparams, jstate, jnp.asarray(action)))
            state, obs, states, reward, dones, _ = tenv.env_step(
                te.static, te.params, state, torch.as_tensor(action),
                (torch.as_tensor(u_reset), None, torch.as_tensor(u_goal), None))
            for name, a, b in (("obs", jo, obs), ("states", js, states),
                               ("reward", jr, reward)):
                err = max_diff(a, b)
                assert err < 1e-6, f"step {t} {name}: {err}"
            assert np.array_equal(np.asarray(jd), dones.numpy())
            assert max_diff(jstate.physics.q, state.physics.q) < 1e-9
    # the fingers moved under the actions
    assert float(np.abs(np.asarray(jstate.physics.qd)).max()) > 1e-2
