"""Port parity: bfloat16 networks (``models/networks.py`` ``dtype``,
``learning/ppo.py`` ``network_dtype`` / ``mixed_precision``).

- The bfloat16 ``ActorCritic`` and ``CentralValue`` against flax
  ``dtype=jnp.bfloat16`` on the same converted weights. Both cast input,
  weight and bias to bfloat16 and round the product, the bias add and the
  ELU to it, so they differ only where the two frameworks' bfloat16 products
  (float32 sums in another order, then one rounding) land on neighbouring
  bfloat16 numbers: measured on the CPU, 99.8% of the outputs are equal and
  the rest one bfloat16 ulp (2^-7 of the value's binade) apart. Held: every
  output within 2^-7 |ref| + 2^-10 max|ref| and >= 99% equal. A float32
  tower misses that by far: its outputs sit ~0.5% off the bfloat16 ones.
- One ``train_iteration`` with ``network_dtype: bfloat16`` against the
  reference's on the replayed trajectory of ``test_torch_ppo_update.py``.
  The towers' bfloat16 rounding (2^-9 relative per value) enters every loss
  through thousands of averaged terms: measured 3e-5 to 1.3e-3 relative on
  the losses; the KL is a mean of differences of two bfloat16 policies, so
  an ulp of one ``mu`` moves it more: measured 1.2e-3 and 7.0e-3 relative.
  Held at rtol 5e-3 (losses) and 2e-2 (KL); every step's KL at least 5% off
  the adaptive-lr thresholds, so both sides take the same branches and the
  lr agrees to float32 rounding (rtol 1e-5).
- The CLI takes ``rlg.params.config.mixed_precision=True``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leibnizgym_tpu.learning import ppo as jppo
from leibnizgym_tpu.models import networks as jnets
from leibnizgym_tpu_torch.convert import flax_params_to_state_dict, train_state_from_jax
from leibnizgym_tpu_torch.learning import ppo as tppo
from leibnizgym_tpu_torch.models import networks as tnets
from test_torch_ppo_update import (
    ACT, CASES, OBS, STATES, UNITS, Static, TorchStubState, _jax_stub, _jax_train_state,
    _recorded, _torch_stub, port_config, reference_draws,
)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_ULP = 2.0 ** -7


def _hold_bf16(ours: torch.Tensor, ref):
    ref = np.asarray(ref, np.float32)
    ours = ours.detach().numpy()
    assert ours.dtype == np.float32
    bound = BF16_ULP * np.abs(ref) + 2.0 ** -10 * np.abs(ref).max()
    assert (np.abs(ours - ref) <= bound).all(), np.abs(ours - ref).max()
    assert np.mean(ours == ref) >= 0.99, np.mean(ours == ref)


@pytest.mark.parametrize("units", [UNITS, (400, 200, 100)], ids=["narrow", "d1_widths"])
def test_bf16_towers_match_flax(units):
    rng = np.random.default_rng(0)
    obs = rng.uniform(-5, 5, (256, OBS)).astype(np.float32)
    states = rng.uniform(-5, 5, (256, STATES)).astype(np.float32)

    jac = jnets.ActorCritic(action_dim=ACT, units=units, dtype=jnp.bfloat16)
    p = jac.init(jax.random.PRNGKey(1), jnp.zeros((1, OBS)))
    p = jax.device_get({"params": dict(p["params"], log_std=jnp.linspace(-0.6, 0.2, ACT))})
    ref_mu, ref_ls, ref_v = jac.apply(p, jnp.asarray(obs))
    ac = tnets.ActorCritic(OBS, ACT, units, dtype=torch.bfloat16)
    ac.load_state_dict(flax_params_to_state_dict(p))
    mu, log_std, value = ac(torch.as_tensor(obs))
    _hold_bf16(mu, ref_mu)
    _hold_bf16(value, ref_v)
    np.testing.assert_array_equal(log_std.detach().numpy(), np.asarray(ref_ls))  # float32 clip

    jcv = jnets.CentralValue(units=units, dtype=jnp.bfloat16)
    pc = jax.device_get(jcv.init(jax.random.PRNGKey(2), jnp.zeros((1, STATES))))
    cv = tnets.CentralValue(STATES, units, dtype=torch.bfloat16)
    cv.load_state_dict(flax_params_to_state_dict(pc))
    _hold_bf16(cv(torch.as_tensor(states)), jcv.apply(pc, jnp.asarray(states)))

    # the same weights in float32 are ~0.5% away: the test sees the dtype
    f32 = tnets.ActorCritic(OBS, ACT, units)
    f32.load_state_dict(ac.state_dict())
    assert np.mean(f32(torch.as_tensor(obs))[0].detach().numpy() == np.asarray(ref_mu)) < 0.5


@pytest.mark.parametrize("case", ["time_sliced_cv", "flat_cv_frames2"])
def test_bf16_update_matches_reference(case, monkeypatch):
    n, h = 64, 8
    kw = CASES[case]
    static = Static(n, OBS, STATES, ACT, True)
    jcfg = jppo.PPOConfig(horizon=h, mini_epochs=2, cv_mini_epochs=3, units=UNITS,
                          fused_rollout=False, network_dtype="bfloat16", **kw)
    tcfg = port_config(jcfg)
    assert tcfg.network_dtype == "bfloat16"
    table = _recorded(n, h, STATES, seed=11)

    jts = _jax_train_state(jcfg, static, table, seed=5)
    monkeypatch.setattr(jppo, "env_step", _jax_stub(table))
    _, jm = jax.jit(lambda ts: jppo.train_iteration(jcfg, static, None, ts))(jts)
    jts, jm = jax.device_get((jts, jm))

    noise, perms = reference_draws(tcfg, jts.key, n, h, True)
    tts = train_state_from_jax(jts, tcfg, static, env_state=TorchStubState(
        0, torch.zeros(n, dtype=torch.bool), torch.zeros(n, dtype=torch.int32)))
    assert tts.actor_critic.dtype == tts.central_value.dtype == torch.bfloat16
    steps = []
    step = tppo.actor_critic_step

    def recording_step(cfg, ac, opt, lr, mb, shard=None):
        new_lr, terms = step(cfg, ac, opt, lr, mb, shard)
        steps.append(float(terms[4]))
        return new_lr, terms

    monkeypatch.setattr(tppo, "env_step", _torch_stub(table))
    monkeypatch.setattr(tppo, "actor_critic_step", recording_step)
    tm = tppo.train_iteration(tcfg, static, None, tts, noise=noise, env_draws=[None] * h,
                              perms=perms)

    for k in ("losses/total", "losses/a_loss", "losses/c_loss", "losses/entropy",
              "losses/cv_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=5e-3, err_msg=k)
    np.testing.assert_allclose(float(tm["info/kl"]), float(jm["info/kl"]), rtol=2e-2)
    thr = tcfg.kl_threshold
    for kl in steps:
        assert not (0.475 * thr < kl < 0.525 * thr or 1.9 * thr < kl < 2.1 * thr), (kl, thr)
    np.testing.assert_allclose(float(tm["info/lr"]), float(jm["info/lr"]), rtol=1e-5)
    assert len(set(steps)) > 1 and float(jm["info/lr"]) != tcfg.learning_rate  # lr moved
    for p in tts.actor_critic.parameters():
        assert p.dtype == torch.float32 and bool(torch.isfinite(p).all())


def test_cli_trains_with_mixed_precision(tmp_path):
    argv = ["gym=trifinger_difficulty_1", "args.num_envs=8", "args.device=cpu",
            "gym.sim.substeps=1", "rlg.params.config.steps_num=2",
            "rlg.params.config.mini_epochs=1", "rlg.params.config.mixed_precision=True",
            "args.max_epochs=2", f"args.logdir={tmp_path}"]
    proc = subprocess.run([sys.executable, "-m", "leibnizgym_tpu_torch.scripts.train", *argv],
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (stamp,) = os.listdir(tmp_path)
    run = tmp_path / stamp
    with open(run / "agent_config.yaml") as f:
        import yaml

        agent = yaml.safe_load(f)
    assert agent["config"]["mixed_precision"] is True
    assert tppo.PPOConfig.from_rlg_params(agent, 8).network_dtype == "bfloat16"
    ckpt = torch.load(run / "nn" / "final", weights_only=True)
    assert ckpt["epoch"] == 2
    for sd in (ckpt["ac_state_dict"], ckpt["cv_state_dict"]):
        assert all(v.dtype == torch.float32 and bool(torch.isfinite(v).all())
                   for v in sd.values())
