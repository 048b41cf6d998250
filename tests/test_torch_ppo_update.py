"""Port parity: the PPO update (``learning/ppo.py``, ``models/networks.py``,
``convert.py``).

- ``gaussian_kl`` / ``gaussian_entropy`` against the flax-side functions on
  the same seeded inputs: the same float32 formulas, rtol 1e-6.
- ``ClippedAdam`` against ``jppo.make_optimizers()`` + ``_apply_lr`` over
  several steps, below and above the clip threshold and with the clip off.
  The elementwise float32 operations are optax's, in its order; only the
  global norm sums in another order, which scales every clipped gradient by
  a number an ulp off. So parameters and moments agree to a few float32
  ulps (rtol 2e-6), plus 1e-6 of the largest element for the entries that
  sums of gradients of both signs have made small.
- The minibatch schedules: the layout against the reference's formulas
  (ppo.py:421-442), and the reference's own index construction
  (ppo.py:509-557) on the same permutations.
- The update: the reference's ``train_iteration`` runs with ``env_step``
  replaced, in this test only, by a table lookup that replays a recorded
  trajectory (the stub's env state carries the step index, ``reset_buf``
  and ``successes``); the port runs on the same table from the converted
  train state, with the reference's action noise and permutations
  recomputed from its key splits. Losses, KL and ``lr`` agree to float32
  rounding (rtol 1e-5: float32 matmuls and reductions in another order).
  Adam moves a parameter by about ``lr`` a step whatever its gradient's
  size, so where a gradient is at rounding-noise level its sign, and that
  step, may differ between the frameworks: new parameters are held to
  max |diff| <= 2 * lr_max * steps and >= 99.9% of elements within 1e-5;
  the Adam moments to 1e-5 of their largest magnitude (a flipped sign moves
  a first moment by ~2 * 0.1 * |g| with |g| at rounding-noise level). The
  KL of every step is asserted clear of the adaptive-lr thresholds (0.5x and
  2x), so the lr sequence is the same on both sides and the final lr agrees.
  The cases cover time-sliced and flat minibatches, the central value on and
  off, the frame stack, clipped values and both lr branches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

from leibnizgym_tpu.config.presets import rlg_asymm_config
from leibnizgym_tpu.learning import ppo as jppo
from leibnizgym_tpu.models import networks as jnets
from leibnizgym_tpu_torch.convert import (
    adam_state_from_jax,
    flax_params_to_state_dict,
    train_state_from_jax,
)
from leibnizgym_tpu_torch.learning import ppo as tppo
from leibnizgym_tpu_torch.models import networks as tnets
from test_torch_common import max_diff

torch.set_num_threads(1)

OBS, STATES, ACT = 41, 113, 9
UNITS = (64, 32)


def test_gaussian_kl_and_entropy_match_reference():
    rng = np.random.default_rng(0)
    mu0, mu1 = rng.normal(size=(2, 256, ACT)).astype(np.float32)
    ls0, ls1 = rng.uniform(-1.5, 0.5, (2, 256, ACT)).astype(np.float32)
    ref_kl = jnets.gaussian_kl(*(jnp.asarray(x) for x in (mu0, ls0, mu1, ls1)))
    kl = tnets.gaussian_kl(*(torch.as_tensor(x) for x in (mu0, ls0, mu1, ls1)))
    np.testing.assert_allclose(kl.numpy(), np.asarray(ref_kl), rtol=1e-6)
    ref_ent = jnets.gaussian_entropy(jnp.asarray(ls0))
    np.testing.assert_allclose(tnets.gaussian_entropy(torch.as_tensor(ls0)).numpy(),
                               np.asarray(ref_ent), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("setting, field, value", [
    ({"mixed_precision": True}, "network_dtype", "bfloat16"),
    ({"network_dtype": "bfloat16"}, "network_dtype", "bfloat16"),
    ({"nan_telemetry": True}, "nan_telemetry", True),
])
def test_from_rlg_params_honours_settings(setting, field, value):
    """bfloat16 networks and nan_telemetry are read as the reference reads
    them (ppo.py:165-174), and the networks take the dtype."""
    params = rlg_asymm_config()["params"]
    params["config"].update(setting)
    cfg = tppo.PPOConfig.from_rlg_params(params, 64)
    assert getattr(cfg, field) == value == getattr(jppo.PPOConfig.from_rlg_params(params, 64),
                                                   field)
    static = Static(64, OBS, STATES, ACT, True)
    ac, cv = tppo.make_networks(cfg, static)
    dtype = torch.bfloat16 if cfg.network_dtype == "bfloat16" else torch.float32
    assert ac.dtype == cv.dtype == dtype
    assert all(p.dtype == torch.float32 for p in list(ac.parameters()) + list(cv.parameters()))


def test_from_rlg_params_ignores_tpu_scheduling_knobs():
    """fused_update, fused_rollout and update_unroll schedule the same math
    on the TPU; the port reads them and runs its own schedule."""
    params = rlg_asymm_config()["params"]
    base = tppo.PPOConfig.from_rlg_params(params, 64)
    params["config"].update(fused_update=True, fused_rollout=False, update_unroll=4)
    assert tppo.PPOConfig.from_rlg_params(params, 64) == base


@pytest.mark.parametrize("grad_scale, truncate", [(1e-2, True), (10.0, True), (10.0, False)],
                         ids=["below_clip", "above_clip", "no_clip"])
def test_clipped_adam_matches_optax(grad_scale, truncate):
    """Several steps with seeded gradients and a per-step 0-d tensor lr."""
    rng = np.random.default_rng(1)
    shapes = {"dense_0": (OBS, 64), "dense_1": (64, 32), "value": (32, 1)}

    def tree(scale):
        return {"params": {k: {"kernel": (scale * rng.normal(size=s)).astype(np.float32),
                               "bias": (scale * rng.normal(size=s[1])).astype(np.float32)}
                           for k, s in shapes.items()}}

    params = jax.tree.map(jnp.asarray, tree(0.3))
    cfg = jppo.PPOConfig(grad_norm=1.0, truncate_grads=truncate)
    tx, _ = jppo.make_optimizers(cfg)
    opt_state = tx.init(params)
    sd = flax_params_to_state_dict(jax.device_get(params))
    tparams = [(k, v.clone()) for k, v in sd.items()]
    adam = tppo.ClippedAdam(tparams, cfg.grad_norm if truncate else None)
    norms = []
    for step, lr in enumerate([3e-4, 4.5e-4, 2e-4, 1e-3]):
        grads = jax.tree.map(jnp.asarray, tree(grad_scale))
        norms.append(float(jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree.leaves(grads)))))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u,
                              params, jppo._apply_lr(updates, jnp.float32(lr)))
        tgrads = flax_params_to_state_dict(jax.device_get(grads))
        adam.step([tgrads[k] for k in adam.names], torch.tensor(lr, dtype=torch.float32))
    assert (max(norms) < 1.0) == (grad_scale < 1.0)  # which side of the clip
    ref = flax_params_to_state_dict(jax.device_get(params))
    ref_adam = adam_state_from_jax(jax.device_get(opt_state))
    assert adam.count == ref_adam["count"] == 4
    for i, name in enumerate(adam.names):
        for ours, theirs in ((adam.params[i], ref[name]), (adam.mu[i], ref_adam["mu"][name]),
                             (adam.nu[i], ref_adam["nu"][name])):
            r = theirs.numpy()
            np.testing.assert_allclose(ours.numpy(), r, rtol=2e-6, atol=1e-6 * np.abs(r).max())


def test_clipped_adam_load_state_dict_copies_the_moments():
    """Stepping after ``load_state_dict`` leaves the loaded state as it was
    (a checkpoint restored twice gives the same learner twice)."""
    params = [("w", torch.ones(3, 2)), ("b", torch.zeros(2))]
    adam = tppo.ClippedAdam(params, 1.0)
    adam.step([torch.full((3, 2), 0.5), torch.full((2,), -0.5)], torch.tensor(3e-4))
    saved = adam.state_dict()
    kept = {k: {n: t.clone() for n, t in saved[k].items()} for k in ("mu", "nu")}
    restored = tppo.ClippedAdam([(n, p.clone()) for n, p in params], 1.0)
    restored.load_state_dict(saved)
    restored.step([torch.full((3, 2), 2.0), torch.full((2,), 1.0)], torch.tensor(3e-4))
    for k in ("mu", "nu"):
        for n, t in kept[k].items():
            assert torch.equal(saved[k][n], t), (k, n)
    assert not torch.equal(restored.mu[0], kept["mu"]["w"])


@pytest.mark.parametrize("h, n, mb, shuffle, expect", [
    (32, 8192, 8192, True, (32, 1, True)),  # D1 at 8192 envs: one row per minibatch
    (8, 64, 128, True, (4, 2, True)),
    (8, 64, 96, True, (5, 102, False)),  # 5 does not divide 8: flat, 2 samples unused
    (8, 64, 32, True, (16, 32, False)),  # more minibatches than rows
    (8, 64, 128, False, (4, 128, False)),  # no shuffle: flat identity order
    (4, 8, 1000, True, (1, 4, True)),  # minibatch larger than the batch
])
def test_minibatch_schedules_match_reference(h, n, mb, shuffle, expect):
    assert tppo.minibatch_layout(shuffle, h, n, mb) == expect
    cfg = tppo.PPOConfig(horizon=h, minibatch_size=mb, cv_minibatch_size=mb, mini_epochs=2,
                         cv_mini_epochs=3, shuffle_minibatches=shuffle)
    num_mb, width, time_sliced = expect
    batch = h * n
    # the reference's index construction (ppo.py:509-557) on its own draws
    key, ref_ac, ref_cv, perms = jax.random.PRNGKey(3), [], [], []
    for i in range(cfg.mini_epochs + cfg.cv_mini_epochs):
        key, k = jax.random.split(key)
        actor = i < cfg.mini_epochs
        if time_sliced:
            p = jax.random.permutation(k, h)
            (ref_ac if actor else ref_cv).append(p.reshape(num_mb, width))
        else:
            p = (jax.random.permutation(k, batch) if shuffle or not actor
                 else jnp.arange(batch))
            (ref_ac if actor else ref_cv).append(p[: num_mb * width].reshape(num_mb, width))
        perms.append(torch.as_tensor(np.array(p)))
    ac_idx, cv_idx = tppo.minibatch_indices(cfg, h, n, True, perms)
    np.testing.assert_array_equal(ac_idx.numpy(), np.concatenate(ref_ac))
    np.testing.assert_array_equal(cv_idx.numpy(), np.concatenate(ref_cv))
    # the port's own draws have the same layout, and each mini-epoch visits
    # every row (time-sliced) or distinct samples (flat)
    drawn = tppo.draw_permutations(cfg, h, n, True, torch.Generator().manual_seed(0), "cpu")
    ac_idx, cv_idx = tppo.minibatch_indices(cfg, h, n, True, drawn)
    assert ac_idx.shape == (cfg.mini_epochs * num_mb, width)
    assert cv_idx.shape == (cfg.cv_mini_epochs * num_mb, width)
    for e in range(cfg.mini_epochs):
        rows = ac_idx[e * num_mb:(e + 1) * num_mb].reshape(-1)
        assert len(set(rows.tolist())) == rows.numel()


# ---------------------------------------------------------------------------
# The update against the reference's train_iteration on a replayed trajectory
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Static:
    """The EnvStatic fields the learner reads."""

    num_envs: int
    obs_dim: int
    state_dim: int
    action_dim: int
    asymmetric_obs: bool


@struct.dataclass
class JaxStubState:
    t: jax.Array
    reset_buf: jax.Array
    successes: jax.Array


@dataclasses.dataclass
class TorchStubState:
    t: int
    reset_buf: torch.Tensor
    successes: torch.Tensor


def _recorded(n, h, state_dim, seed):
    """A trajectory table: raw obs and states (some beyond the clip), raw
    rewards, dones, resets (the episodes that finish) and successes."""
    rng = np.random.default_rng(seed)
    return {
        "obs0": rng.uniform(-6, 6, (n, OBS)).astype(np.float32),
        "obs": rng.uniform(-6, 6, (h, n, OBS)).astype(np.float32),
        "states": rng.uniform(-6, 6, (h, n, state_dim)).astype(np.float32),
        "reward": (100 * rng.normal(size=(h, n))).astype(np.float32),
        "done": rng.random((h, n)) < 0.1,
        "reset": rng.random((h, n)) < 0.15,
        "successes": rng.integers(0, 3, (h, n)).astype(np.int32),
    }


def _jax_stub(table):
    tab = {k: jnp.asarray(v) for k, v in table.items()}

    def env_step(static, params, state, action):
        t = state.t
        new = JaxStubState(t=t + 1, reset_buf=tab["reset"][t], successes=tab["successes"][t])
        info = {"env/action_mean": jnp.mean(action), "env/step": t.astype(jnp.float32)}
        return new, tab["obs"][t], tab["states"][t], tab["reward"][t], tab["done"][t], info

    return env_step


def _torch_stub(table):
    tab = {k: torch.as_tensor(v) for k, v in table.items()}

    def env_step(static, params, state, action, draws):
        t = state.t
        new = TorchStubState(t + 1, tab["reset"][t], tab["successes"][t])
        info = {"env/action_mean": torch.mean(action), "env/step": torch.tensor(float(t))}
        return new, tab["obs"][t], tab["states"][t], tab["reward"][t], tab["done"][t], info

    return env_step


def _jax_train_state(cfg, static, table, seed):
    asym = cfg.central_value and static.asymmetric_obs
    ac = jnets.ActorCritic(action_dim=ACT, units=cfg.units)
    k_ac, k_cv, k_ts = jax.random.split(jax.random.PRNGKey(seed), 3)
    ac_params = ac.init(k_ac, jnp.zeros((1, OBS * cfg.frames)))
    # a non-zero log_std, so that the entropy and KL terms see one
    ac_params = {"params": dict(ac_params["params"], log_std=jnp.linspace(-0.6, 0.2, ACT))}
    cv_params = jnets.CentralValue(units=cfg.units).init(k_cv, jnp.zeros((1, STATES))) if asym else None
    ac_tx, cv_tx = jppo.make_optimizers(cfg)
    obs = jnp.clip(jnp.asarray(table["obs0"]), -cfg.clip_obs, cfg.clip_obs)
    n = static.num_envs
    return jppo.PPOTrainState(
        ac_params=ac_params, cv_params=cv_params, ac_opt_state=ac_tx.init(ac_params),
        cv_opt_state=cv_tx.init(cv_params) if asym else None,
        lr=jnp.asarray(cfg.learning_rate, jnp.float32),
        env_state=JaxStubState(t=jnp.zeros((), jnp.int32), reset_buf=jnp.zeros(n, bool),
                               successes=jnp.zeros(n, jnp.int32)),
        obs=jnp.tile(obs, (1, cfg.frames)), states=jnp.zeros((n, static.state_dim)),
        ep_return=jnp.zeros(n), ep_len=jnp.zeros(n, jnp.int32), key=k_ts,
        epoch=jnp.zeros((), jnp.int32), frame=jnp.zeros((), jnp.float32),
    )


def reference_draws(cfg, key, n, h, asym):
    """The reference's action noise and minibatch permutations, recomputed
    from its key splits (ppo.py:356-358, 509-557)."""
    noise = []
    for _ in range(h):
        key, k_act = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(k_act, (n, ACT))))
    ac_ts = tppo.minibatch_layout(cfg.shuffle_minibatches, h, n, cfg.minibatch_size)[2]
    cv_ts = tppo.minibatch_layout(cfg.shuffle_minibatches, h, n, cfg.cv_minibatch_size)[2]
    perms = []
    for i in range(cfg.mini_epochs + (cfg.cv_mini_epochs if asym else 0)):
        key, k = jax.random.split(key)
        actor = i < cfg.mini_epochs
        if (ac_ts if actor else cv_ts):
            perms.append(jax.random.permutation(k, h))
        elif cfg.shuffle_minibatches or not actor:
            perms.append(jax.random.permutation(k, h * n))
        else:
            perms.append(jnp.arange(h * n))
    return torch.as_tensor(np.stack(noise)), [torch.as_tensor(np.array(p)) for p in perms]


def port_config(jcfg) -> tppo.PPOConfig:
    return tppo.PPOConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(tppo.PPOConfig)})


CASES = {
    # D1-like: time-sliced rows for both networks (2 and 4 rows a minibatch)
    "time_sliced_cv": dict(minibatch_size=128, cv_minibatch_size=256, kl_threshold=0.008),
    # flat shuffles (5 actor minibatches do not divide 8 rows; 10 cv ones
    # outnumber them), frame stack, clipped values, entropy bonus, no clip
    "flat_cv_frames2": dict(minibatch_size=96, cv_minibatch_size=48, frames=2, clip_value=True,
                            entropy_coef=0.01, grad_norm=100.0, kl_threshold=0.002),
    # no central value: the actor-critic's own critic gives the values
    "time_sliced_no_cv": dict(minibatch_size=256, central_value=False, kl_threshold=0.02),
    # no shuffle: the actor's flat identity order
    "flat_unshuffled_no_cv": dict(minibatch_size=128, central_value=False,
                                  shuffle_minibatches=False, kl_threshold=0.02),
}


@pytest.mark.parametrize("case", list(CASES))
def test_update_matches_reference(case, monkeypatch):
    n, h = 64, 8
    kw = CASES[case]
    asym = kw.get("central_value", True)
    static = Static(n, OBS, STATES if asym else 0, ACT, asym)
    jcfg = jppo.PPOConfig(horizon=h, mini_epochs=2, cv_mini_epochs=3, units=UNITS,
                          fused_rollout=False, **kw)
    tcfg = port_config(jcfg)
    table = _recorded(n, h, static.state_dim, seed=11)

    jts = _jax_train_state(jcfg, static, table, seed=5)
    monkeypatch.setattr(jppo, "env_step", _jax_stub(table))
    new_jts, jm = jax.jit(lambda ts: jppo.train_iteration(jcfg, static, None, ts))(jts)
    jts, new_jts, jm = jax.device_get((jts, new_jts, jm))

    noise, perms = reference_draws(tcfg, jts.key, n, h, asym)
    tts = train_state_from_jax(jts, tcfg, static, env_state=TorchStubState(
        0, torch.zeros(n, dtype=torch.bool), torch.zeros(n, dtype=torch.int32)))
    steps = []
    step = tppo.actor_critic_step

    def recording_step(cfg, ac, opt, lr, mb, shard=None):
        new_lr, terms = step(cfg, ac, opt, lr, mb, shard)
        steps.append((float(terms[-1]), float(new_lr)))
        return new_lr, terms

    monkeypatch.setattr(tppo, "env_step", _torch_stub(table))
    monkeypatch.setattr(tppo, "actor_critic_step", recording_step)
    tm = tppo.train_iteration(tcfg, static, None, tts, noise=noise, env_draws=[None] * h,
                              perms=perms)

    assert set(tm) == set(jm)
    for k in ("losses/total", "losses/a_loss", "losses/c_loss", "losses/entropy",
              "losses/cv_loss", "info/kl", "info/lr", "rewards/step_mean",
              "episodes/finished_return_sum", "episodes/finished_success_sum",
              "env/action_mean"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    for k in ("info/epochs", "info/frames", "episodes/finished_count", "env/step"):
        assert float(tm[k]) == float(jm[k]), k
    np.testing.assert_array_equal(tm["episodes/finished_n"].numpy(), jm["episodes/finished_n"])
    assert max_diff(jm["episodes/finished_returns"], tm["episodes/finished_returns"]) < 1e-3
    assert tm["episodes/finished_n"].sum() > 0 and float(jm["losses/cv_loss"] != 0) == asym

    # the adaptive lr: every step's KL at least 2% away from the thresholds
    # (~1000x a KL's float32 rounding), so both sides took the same branch at
    # every step
    num_mb = tppo.minibatch_layout(tcfg.shuffle_minibatches, h, n, tcfg.minibatch_size)[0]
    assert len(steps) == tcfg.mini_epochs * num_mb
    thr = tcfg.kl_threshold
    for kl, _ in steps:
        assert not (0.49 * thr < kl < 0.51 * thr or 1.96 * thr < kl < 2.04 * thr), (kl, thr)
    lrs = [lr for _, lr in steps]
    assert any(b > a for a, b in zip(lrs, lrs[1:]))  # the lr rose
    if case in ("time_sliced_cv", "flat_cv_frames2"):
        assert any(b < a for a, b in zip(lrs, lrs[1:]))  # and fell
    lr_max = max([tcfg.learning_rate] + lrs)

    def hold_params(ref_tree, module, total_steps):
        ref = flax_params_to_state_dict(ref_tree)
        for name, p in module.state_dict().items():
            d = np.abs(p.numpy() - ref[name].numpy())
            assert d.max() <= 2 * lr_max * total_steps, (name, d.max())
            assert np.mean(d <= 1e-5) >= 0.999, (name, np.mean(d <= 1e-5))

    def hold_adam(ref_opt, opt):
        ref = adam_state_from_jax(ref_opt)
        assert opt.count == ref["count"]
        for key, moments in (("mu", opt.mu), ("nu", opt.nu)):
            for name, m in zip(opt.names, moments):
                r = ref[key][name].numpy()
                assert np.abs(m.numpy() - r).max() <= 1e-5 * np.abs(r).max() + 1e-12, (key, name)

    hold_params(new_jts.ac_params, tts.actor_critic, len(steps))
    hold_adam(new_jts.ac_opt_state, tts.ac_opt)
    if asym:
        cv_steps = tts.cv_opt.count
        hold_params(new_jts.cv_params, tts.central_value, cv_steps)
        hold_adam(new_jts.cv_opt_state, tts.cv_opt)
    assert tts.epoch == int(new_jts.epoch) and tts.frame == int(new_jts.frame)
    for name in ("obs", "states", "ep_return", "ep_len"):
        assert max_diff(getattr(new_jts, name), getattr(tts.carry, name)) < 1e-3, name


def test_train_state_from_jax_carries_adam_state(monkeypatch):
    """A JAX train state after one epoch of updates (non-zero moments,
    count 8) converts exactly; one more step from it on the same gradients
    agrees with optax as in test_clipped_adam_matches_optax, which it could
    not if a moment were misplaced or not transposed."""
    n, h = 64, 8
    static = Static(n, OBS, STATES, ACT, True)
    jcfg = jppo.PPOConfig(horizon=h, mini_epochs=2, cv_mini_epochs=3, units=UNITS,
                          minibatch_size=128, cv_minibatch_size=256)
    table = _recorded(n, h, STATES, seed=12)
    monkeypatch.setattr(jppo, "env_step", _jax_stub(table))
    jts, _ = jax.jit(lambda ts: jppo.train_iteration(jcfg, static, None, ts))(
        _jax_train_state(jcfg, static, table, seed=6))
    jts = jax.device_get(jts)
    env_state = TorchStubState(8, torch.zeros(n, dtype=torch.bool),
                               torch.zeros(n, dtype=torch.int32))
    tts = train_state_from_jax(jts, port_config(jcfg), static, env_state=env_state)

    for tree, opt_state, module, opt in ((jts.ac_params, jts.ac_opt_state, tts.actor_critic,
                                          tts.ac_opt),
                                         (jts.cv_params, jts.cv_opt_state, tts.central_value,
                                          tts.cv_opt)):
        ref, ref_adam = flax_params_to_state_dict(tree), adam_state_from_jax(opt_state)
        for name, p in module.state_dict().items():
            assert torch.equal(p, ref[name]), name
        assert opt.count == ref_adam["count"] > 0
        for i, name in enumerate(opt.names):
            assert torch.equal(opt.mu[i], ref_adam["mu"][name]) and opt.mu[i].abs().max() > 0
            assert torch.equal(opt.nu[i], ref_adam["nu"][name]) and opt.nu[i].abs().max() > 0
        # one more step on the same gradients on both sides
        rng = np.random.default_rng(2)
        grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32), tree)
        tx, _ = jppo.make_optimizers(jcfg)
        updates, opt_state = tx.update(grads, opt_state, tree)
        tree = jax.tree.map(lambda p, u: p + u, tree, jppo._apply_lr(updates, jts.lr))
        tgrads = flax_params_to_state_dict(jax.device_get(grads))
        opt.step([tgrads[k] for k in opt.names], tts.lr)
        ref = flax_params_to_state_dict(jax.device_get(tree))
        for name, p in module.state_dict().items():
            r = ref[name].numpy()
            np.testing.assert_allclose(p.numpy(), r, rtol=2e-6, atol=1e-6 * np.abs(r).max())
    assert float(tts.lr) == float(jts.lr) and tts.epoch == 1 and tts.frame == h * n
    for name in ("obs", "states", "ep_return", "ep_len"):
        np.testing.assert_array_equal(getattr(tts.carry, name).numpy(), getattr(jts, name))
