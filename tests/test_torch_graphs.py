"""The port's compiled paths (``learning/graphs.py``, the captured env step
of ``envs/trifinger/env.py``) and the repairs they rest on: the env's frame
counter and the Adam step counts are 0-d int32 device tensors, as the
reference keeps them (``EnvState.frames``, optax's ``count``), and the
learner's state is written in place.

On the CPU nothing is captured. What a capture needs is checked here in
three ways:

- ``CaptureGuard`` runs a body and fails on what a CUDA graph cannot hold:
  a tensor made from host data (``lift_fresh``), a read back to the host
  (``_local_scalar_dense``) or a random draw;
- the graph bodies run epoch after epoch with only their buffers' contents
  changing (Adam counts, frames, lr, the curriculum level, a checkpoint
  restored in place) and are held bitwise to ``ppo.train_iteration`` fed
  the same draws;
- ``make_fx`` traces the minibatch-step bodies and the traced modules,
  replayed on the next epoch's buffers, are held bitwise to the bodies: a
  value read on the host at trace time would be a baked constant there, as
  in a captured graph. (The rollout body traces too, but its ~62,000 nodes
  take ~70 s on one CPU core; the guard covers it.)

``tests/test_torch_cuda_graphs.py`` captures and replays on the card.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from leibnizgym_tpu.config.presets import GYM_PRESETS
from leibnizgym_tpu.envs.trifinger import env as jenv
from leibnizgym_tpu.learning import ppo as jppo
from leibnizgym_tpu_torch.convert import flax_params_to_state_dict
from leibnizgym_tpu_torch.envs.trifinger import env as tenv
from leibnizgym_tpu_torch.learning import graphs as tgraphs
from leibnizgym_tpu_torch.learning import ppo as tppo
from leibnizgym_tpu_torch.scripts import nan_replay
from test_torch_common import max_diff
from test_torch_d4_env import (
    _JIT_PHYSICS,
    _compare_info,
    _torch,
    case_config,
    reference_reset_draws,
    reference_step_draws,
)
from test_torch_runner import _real_runner
# the guard and the guarded epoch live with the rank functions, which the
# data-parallel graph tests run in spawned processes without JAX
from torch_parallel_workers import CaptureGuard, GuardedEpoch

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# EnvState.frames
# ---------------------------------------------------------------------------

N_ENV, RAMP_STEPS = 8, 4


def test_frames_counter_and_frame_ramps_match_reference(monkeypatch):
    """The frame-ramped tolerance and goal-orientation curricula (ramps of
    160 and 200 env-steps, 2-step episodes so that goals are drawn at every
    other step) against the JAX env in float64 over 4 steps: the counter is
    a 0-d int32 tensor on the env's device equal to the reference's, and
    each step passes ``CaptureGuard``."""
    monkeypatch.setattr(jenv, "_batched_physics_step_v2", _JIT_PHYSICS)
    cfg = case_config("trifinger_difficulty_4_curriculum", {
        "goal_curriculum": {"success_gated": False, "anneal_frames": 160.0},
        "termination_conditions": {"success": {"tolerance_anneal_frames": 200.0}}})
    cfg["episode_length"] = 2
    je = jenv.TrifingerEnv(config=dict(cfg, engine="soa"), verbose=False)
    te = tenv.TrifingerEnv(config=cfg, device="cpu", verbose=False, dtype=torch.float64)
    st = te.static
    assert st.tolerance_anneal_frames == 200.0 and st.ori_difficulty_anneal_frames == 160.0
    rng = np.random.default_rng(5)
    tolerances = []
    with jax.enable_x64(True):
        jparams = jax.tree.map(
            lambda x: x.astype(jnp.float64) if jnp.issubdtype(x.dtype, jnp.floating) else x,
            je.params)
        key = jax.random.PRNGKey(4)
        jstate, _ = jenv.env_reset(je.static, jparams, key)
        state, _ = tenv.env_reset(st, te.params, *_torch(reference_reset_draws(je.static, key,
                                                                               N_ENV)))
        for t in range(RAMP_STEPS):
            assert state.frames.dtype == torch.int32 and state.frames.dim() == 0
            assert state.frames.device == te.device
            assert int(state.frames) == int(jstate.frames), t
            action = rng.uniform(-1.0, 1.0, (N_ENV, st.action_dim))
            draws = _torch(reference_step_draws(je.static, jstate.key, N_ENV))
            jstate, jo, _, jr, _, jinfo = jenv.env_step(je.static, jparams, jstate,
                                                        jnp.asarray(action))
            action = torch.as_tensor(action)
            with CaptureGuard():
                state, o, _, r, _, info = tenv.env_step(st, te.params, state, action, draws)
            assert max_diff(jo, o) < 2e-4 and max_diff(jr, r) < 2e-4, t
            assert max_diff(jstate.goal_pose_cm, state.goal_pose_cm) < 2e-4, t
            _compare_info(jinfo, info, f"step {t}")
            tolerances.append(float(info["env/position_tolerance"]))
    assert int(state.frames) == 1 + RAMP_STEPS
    assert len(set(tolerances)) == RAMP_STEPS  # the ramp moved at every step


# ---------------------------------------------------------------------------
# ClippedAdam.count
# ---------------------------------------------------------------------------


def _tree(rng, scale, shapes):
    return {"params": {k: {"kernel": (scale * rng.normal(size=s)).astype(np.float32),
                           "bias": (scale * rng.normal(size=s[1])).astype(np.float32)}
                       for k, s in shapes.items()}}


def _host_count_step(opt, grads, lr, count):
    """``ClippedAdam.step`` as it was with a host int count: the bias
    corrections as float32 numpy scalars handed over as Python floats."""
    def bc(decay):
        return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))

    grads = list(grads)
    g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = g_norm < opt.max_norm
    torch._foreach_div_(grads, torch.where(keep, 1.0, g_norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, opt.max_norm).to(g_norm.dtype))
    torch._foreach_mul_(opt.mu, opt.b1)
    torch._foreach_add_(opt.mu, torch._foreach_mul(grads, 1.0 - opt.b1))
    sq = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(sq, 1.0 - opt.b2)
    torch._foreach_mul_(opt.nu, opt.b2)
    torch._foreach_add_(opt.nu, sq)
    upd = torch._foreach_div(opt.mu, bc(opt.b1))
    den = torch._foreach_div(opt.nu, bc(opt.b2))
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, opt.eps)
    torch._foreach_div_(upd, den)
    torch._foreach_mul_(upd, -lr)
    torch._foreach_add_(opt.params, upd)


@pytest.mark.parametrize("steps, clip", [(1, False), (2, False), (3, False), (4, False),
                                         (5, False), (5, True)])
def test_clipped_adam_device_count(steps, clip):
    """``steps`` steps with the device count against the host-count
    arithmetic it replaced: bitwise in float32, parameters, moments and
    count. Against optax: the count and both bias corrections bitwise, and
    the moments too while the global-norm clip is not active. The clip's
    scaling (active on every other step with ``clip``) and the parameter
    update ``p + (-lr) * u`` round apart from XLA's in the last place (as
    before the count moved: one element of 2048 one ulp off at step 3), so
    there the bound of test_torch_ppo_update.py's optax test holds."""
    rng = np.random.default_rng(steps)
    shapes = {"dense_0": (41, 64), "dense_1": (64, 32), "value": (32, 1)}
    params = jax.tree.map(jnp.asarray, _tree(rng, 0.3, shapes))
    cfg = jppo.PPOConfig(grad_norm=1.0, truncate_grads=True)
    tx, _ = jppo.make_optimizers(cfg)
    opt_state = tx.init(params)
    sd = flax_params_to_state_dict(jax.device_get(params))
    ours = tppo.ClippedAdam([(k, v.clone()) for k, v in sd.items()], cfg.grad_norm)
    old = tppo.ClippedAdam([(k, v.clone()) for k, v in sd.items()], cfg.grad_norm)
    for step in range(1, steps + 1):
        lr = float(np.float32(3e-4 * 1.5 ** (step % 3)))
        scale = 10.0 if clip and step % 2 else 1e-2
        grads = jax.tree.map(jnp.asarray, _tree(rng, scale, shapes))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params,
                              jppo._apply_lr(updates, jnp.float32(lr)))
        tg = flax_params_to_state_dict(jax.device_get(grads))
        with torch.no_grad():
            ours.step([tg[k].clone() for k in ours.names], torch.tensor(lr))
            _host_count_step(old, [tg[k].clone() for k in old.names], torch.tensor(lr), step)
        for decay in (ours.b1, ours.b2):
            ref = np.float32(1.0) - np.float32(decay) ** np.float32(step)
            assert ours._bias_correction(decay, ours.count).numpy() == ref
            assert ref == np.asarray(jax.jit(lambda c, d=decay: 1 - d ** c)(
                jnp.asarray(step, jnp.int32)))
    assert ours.count.dtype == torch.int32 and ours.count.dim() == 0 and int(ours.count) == steps
    adam = next(s for s in opt_state if hasattr(s, "mu"))
    assert int(adam.count) == steps
    ref_p = flax_params_to_state_dict(jax.device_get(params))
    ref_mu = flax_params_to_state_dict(jax.device_get(adam.mu))
    ref_nu = flax_params_to_state_dict(jax.device_get(adam.nu))
    for i, name in enumerate(ours.names):
        for a, b, c in ((ours.params[i], old.params[i], ref_p[name]),
                        (ours.mu[i], old.mu[i], ref_mu[name]),
                        (ours.nu[i], old.nu[i], ref_nu[name])):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
            if clip or a is ours.params[i]:
                r = c.numpy()
                np.testing.assert_allclose(a.numpy(), r, rtol=2e-6,
                                           atol=1e-6 * np.abs(r).max(), err_msg=name)
            else:
                np.testing.assert_array_equal(a.numpy(), c.numpy(), err_msg=name)


def test_adam_load_state_dict_int_count_then_steps():
    """A state dict with an int count, as checkpoints held it, loads in place
    into a fresh optimizer (its tensors kept, the caller's not aliased), and
    the next steps equal those of the optimizer it was saved from."""
    rng = np.random.default_rng(3)
    shapes = [("w", (16, 8)), ("b", (8,))]
    params = [(k, torch.as_tensor(rng.normal(size=s).astype(np.float32))) for k, s in shapes]
    grads = [[torch.as_tensor(rng.normal(size=s).astype(np.float32)) for _, s in shapes]
             for _ in range(5)]
    a = tppo.ClippedAdam([(k, v.clone()) for k, v in params], 1.0)
    for g in grads[:3]:
        a.step([x.clone() for x in g], 3e-4)
    state = a.state_dict()
    state = {"count": int(state["count"]), "mu": {k: v.clone() for k, v in state["mu"].items()},
             "nu": {k: v.clone() for k, v in state["nu"].items()}}
    b = tppo.ClippedAdam([(k, p.clone()) for k, p in zip(a.names, a.params)], 1.0)
    own = (b.count, *b.mu, *b.nu)
    b.load_state_dict(state)
    assert all(x is y for x, y in zip(own, (b.count, *b.mu, *b.nu)))
    assert b.count.dtype == torch.int32 and int(b.count) == 3
    for g in grads[3:]:
        a.step([x.clone() for x in g], 3e-4)
        b.step([x.clone() for x in g], 3e-4)
    assert int(state["count"]) == 3 and not torch.equal(state["mu"]["w"], b.mu[0])
    assert torch.equal(a.count, b.count)
    for x, y in zip(a.params + a.mu + a.nu, b.params + b.mu + b.nu):
        assert torch.equal(x, y)


def test_old_checkpoint_and_nan_dump_restore(tmp_path):
    """A checkpoint whose Adam counts are ints, and a NaN dump whose frame
    counter is an int beside an env state without it, as written before the
    counters moved onto the device, still restore: the counts and frames
    arrive as device int32 tensors."""
    r = _real_runner(tmp_path / "run", host_pipeline_depth=1)
    r.train(max_epochs=2)
    path = os.path.join(r.nn_dir, "final")
    ckpt = torch.load(path, weights_only=True)
    steps = int(ckpt["ac_opt_state"]["count"])
    assert steps == 2 * 2 and ckpt["ac_opt_state"]["count"].dtype == torch.int32
    for part in ("ac_opt_state", "cv_opt_state"):
        ckpt[part]["count"] = int(ckpt[part]["count"])
    old = str(tmp_path / "old_final")
    torch.save(ckpt, old)
    fresh = _real_runner(tmp_path / "fresh")
    fresh.restore(old)
    for opt in (fresh.ts.ac_opt, fresh.ts.cv_opt):
        assert opt.count.dtype == torch.int32 and int(opt.count) == steps
    assert fresh.ts.epoch == 2

    dump = tenv_dump = r.nan_dump_payload()
    frames = int(tenv_dump["carry"]["frames"])
    assert frames == 1 + 2 * r.ppo_cfg.horizon
    del dump["carry"]["env_state"]["frames"]
    dump["carry"]["frames"] = frames
    for part in ("ac_opt_state", "cv_opt_state"):
        dump[part]["count"] = int(dump[part]["count"])
    torch.save(dump, os.path.join(r.logdir, nan_replay.DUMP))
    _, _, ts = nan_replay.load_run(r.logdir, torch.device("cpu"))
    assert ts.carry.env_state.frames.dtype == torch.int32
    assert int(ts.carry.env_state.frames) == frames


# ---------------------------------------------------------------------------
# The graphed epoch's bodies
# ---------------------------------------------------------------------------

N, H = 8, 2
# case -> (gym preset, gym changes): the success-gated level, and the frame
# ramps (2-step episodes: goals drawn inside every epoch)
def _ramped(preset: str) -> dict:
    """The preset's curriculum sections with frame ramps of 64 and 48
    env-steps (an epoch is 16) in place of the success gate."""
    term = copy.deepcopy(GYM_PRESETS[preset]["termination_conditions"])
    term["success"]["tolerance_anneal_frames"] = 48.0
    gc = dict(GYM_PRESETS[preset]["goal_curriculum"], success_gated=False, anneal_frames=64.0)
    return {"episode_length": 2, "goal_curriculum": gc, "termination_conditions": term}


# case -> (gym preset, gym changes, agent changes)
EPOCH_CASES = {
    "gated_level": ("trifinger_difficulty_4_curriculum_dr", {"episode_length": 3}, {}),
    "frame_ramps": ("trifinger_difficulty_4_curriculum",
                    _ramped("trifinger_difficulty_4_curriculum"), {}),
    # the nan/* metrics of every epoch; the per-step gradient norms are the
    # ac step graph's sixth row of terms
    "nan_telemetry": ("trifinger_difficulty_4_curriculum",
                      _ramped("trifinger_difficulty_4_curriculum"), {"nan_telemetry": True}),
}


def _learner(r):
    ts = r.ts
    out = {f"ac.{k}": v for k, v in ts.actor_critic.state_dict().items()}
    out.update({f"cv.{k}": v for k, v in ts.central_value.state_dict().items()})
    for tag, opt in (("ac_opt", ts.ac_opt), ("cv_opt", ts.cv_opt)):
        out.update({f"{tag}.mu.{n}": m for n, m in zip(opt.names, opt.mu)})
        out.update({f"{tag}.nu.{n}": m for n, m in zip(opt.names, opt.nu)})
        out[f"{tag}.count"] = opt.count
    out["lr"] = ts.lr
    out.update({f"carry.{k}": v for k, v in tenv.env_state_tensors(ts.carry.env_state).items()})
    out.update({f"carry.{k}": getattr(ts.carry, k)
                for k in ("obs", "states", "ep_return", "ep_len")})
    return out


def _assert_same(a: dict, b: dict, where: str):
    assert set(a) == set(b)
    for k in a:
        if torch.is_tensor(a[k]):
            assert torch.equal(a[k], b[k]), f"{where}: {k}"
        else:
            assert a[k] == b[k], f"{where}: {k}"


def _draws(r, seed):
    """One epoch's action noise, env draws and permutations from numpy."""
    rng = np.random.default_rng(seed)
    st, cfg = r.static, r.ppo_cfg
    f = lambda *shape: torch.as_tensor(rng.uniform(size=shape).astype(np.float32))  # noqa: E731
    normal = lambda *shape: torch.as_tensor(rng.normal(size=shape).astype(np.float32))  # noqa: E731
    noise = normal(H, N, st.action_dim)
    env_draws = [(f(N, 25), normal(N, 8), f(N, 25), normal(N, 8),
                  (f(N, 7), f(N, 2)) if st.dr_activate else None,
                  normal(N, st.obs_dim) if st.obs_noise_std > 0 else None) for _ in range(H)]
    asym = r.ts.central_value is not None
    g = torch.Generator().manual_seed(seed)
    perms = tppo.draw_permutations(cfg, H, N, asym, g, "cpu")
    return noise, env_draws, perms


@pytest.mark.parametrize("case", list(EPOCH_CASES))
def test_graphed_epoch_bodies_match_train_iteration(case, tmp_path):
    """Four epochs of the graph bodies (under ``CaptureGuard``) against
    ``train_iteration`` on twin learners: epoch 1 from the generator, the
    rest from injected draws; the curriculum level written in place before
    epoch 3; a checkpoint of epoch 1 restored in place into both before
    epoch 4. Every metric (with ``nan_telemetry`` every ``nan/*`` key) and
    every learner and carry tensor bitwise equal."""
    preset, changes, agent = EPOCH_CASES[case]
    eager = _real_runner(tmp_path / "eager", gym=preset, gym_changes=changes, **agent)
    graphed = _real_runner(tmp_path / "graphed", gym=preset, gym_changes=changes, **agent)
    for r in (eager, graphed):
        r.reset()
    epoch = GuardedEpoch()
    cfg = eager.ppo_cfg
    gated = eager.static.curriculum_success_gated
    assert gated == (case == "gated_level")
    frames_seen, tol_seen = [], []
    for e in range(1, 5):
        if e == 3 and gated:
            for r in (eager, graphed):
                r._set_curriculum_level(0.6)
        if e == 4:
            for r in (eager, graphed):
                r.restore(os.path.join(eager.nn_dir, "epoch1"))
        draws = {} if e == 1 else dict(zip(("noise", "env_draws", "perms"), _draws(eager, e)))
        me = tppo.train_iteration(cfg, eager.static, eager.env_params, eager.ts,
                                  **copy.deepcopy(draws))
        mg = epoch(cfg, graphed.static, graphed.env_params, graphed.ts, **copy.deepcopy(draws))
        _assert_same(me, mg, f"{case} epoch {e} metrics")
        assert len([k for k in mg if k.startswith("nan/")]) == (22 if agent else 0)
        _assert_same(_learner(eager), _learner(graphed), f"{case} epoch {e} learner")
        if e == 1:
            eager.save("epoch1")
        frames_seen.append(int(graphed.ts.carry.env_state.frames))
        tol_seen.append(float(mg["env/position_tolerance"]))
    assert int(graphed.ts.ac_opt.count) == 2 * epoch.ac_steps  # epoch 1's, then epoch 4's
    assert len(set(tol_seen)) >= 2  # the level or the ramp moved the tolerance
    assert frames_seen == sorted(frames_seen)


def _trace(body):
    """``body()`` run once for real, traced."""
    return make_fx(lambda: body())()


def test_traced_steps_replay_the_next_epoch(tmp_path):
    """``make_fx`` traces the actor-critic and central-value step bodies at
    their first calls in epoch 2; in epoch 3, after a level change, the
    traced modules replay every minibatch step on the buffers that epoch 3
    filled (the minibatch sources copied into the traced ones, as a graph's
    static buffers would be), bitwise as the bodies do: the Adam counts,
    lr, step counters and index buffers were not baked in."""
    r = _real_runner(tmp_path, gym="trifinger_difficulty_4_curriculum_dr",
                     gym_changes={"episode_length": 3})
    r.reset()
    g = tgraphs.GraphedEpoch()
    g(r.ppo_cfg, r.static, r.env_params, r.ts)
    assert g.ac_steps > 1 and g.cv_steps > 1
    g._load_draws(None, None, None)
    g._rollout_body()
    g._gae_body()
    traced, sources = {}, {}
    for name, body, times in g._phases()[2:]:  # epoch 2's steps, the first traced
        traced[name] = _trace(body)
        for _ in range(times - 1):
            body()
    sources = (dict(g.ac_data), tuple(g.cv_data))
    r._set_curriculum_level(0.4)
    g._load_draws(None, None, None)
    g._rollout_body()
    g._gae_body()
    state = dict(_learner(r), ac_step=g.ac_step, cv_step=g.cv_step)
    snap = {k: v.clone() for k, v in state.items()}

    def steps(run):
        for name, body, times in g._phases()[2:]:
            for _ in range(times):
                run(name, body)
        return {**{k: v.clone() for k, v in _learner(r).items()},
                "ac_terms": g.ac_terms.clone(), "cv_losses": g.cv_losses.clone()}

    want = steps(lambda name, body: body())
    for k, v in state.items():
        v.copy_(snap[k])
    with torch.no_grad():
        for k, v in sources[0].items():
            v.copy_(g.ac_data[k])
        for v, new in zip(sources[1], g.cv_data):
            v.copy_(new)
        got = steps(lambda name, body: traced[name]())
    _assert_same(want, got, "traced replay")
    assert int(r.ts.ac_opt.count) == 3 * g.ac_steps
