"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
 1. device: torch version, card name and power limit, TF32 off, kernel build;
 2. kernel vs plain: the CUDA physics kernel against its plain PyTorch version
    on seeded random states, N = 4096 and a ragged N = 1000, over PGS / TGS,
    each contact gate off, per-env (DR-like) params, cylinder / cone arenas
    and the sphere object;
 3. golden one-step replay: the kernel steps each recorded state of
    tests/golden/traj_d1_seed0{,_cone}.npz and is held to the next one;
 4. the rollout: the D1 training preset with the asymmetric agent config at
    8192 envs: reset, one 32-step rollout of actor + central value, GAE; the
    kernel must be launched exactly 33 times; then timings;
 5. training: the same preset through ``Runner`` + ``Runner.train`` (what
    ``run_training`` and the CLI call) for EPOCHS epochs into a temporary
    logdir, full widths (obs 41, states 113, MLPs 400/200/100, minibatch
    8192, 4 + 4 mini-epochs, horizon 32). Checks: finite losses, KL and lr,
    lr within [1e-6, 1e-2], the parameters moved, info/frames, the kernel
    launched 1 + 32 * EPOCHS times (the reset, then one launch per env step),
    the ``final`` checkpoint restored bit-identically into a fresh Runner,
    ``make_policy`` + ``play`` for a few steps, the kernel against its plain
    version on the trained state; one actor-critic and one central-value step
    on the card against the same step on the CPU (TF32 off); then the epoch
    time split into rollout / GAE / update (CUDA events, first epoch as
    warm-up) and training env-steps/s.
The last two lines are the kernels' JSON record and the device JSON line.
Needs a CUDA device and the repository around it; imports no JAX.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
import time

try:
    import numpy as np
    import torch

    from leibnizgym_tpu_torch.config.presets import default_config, update_cfg
    from leibnizgym_tpu_torch.models import trifinger as tf_model
    from leibnizgym_tpu_torch.envs.trifinger import env as tenv
    from leibnizgym_tpu_torch.learning import ppo
    from leibnizgym_tpu_torch.learning.runner import Runner
    from leibnizgym_tpu_torch.models import networks as tnets
    from leibnizgym_tpu_torch.ops import cuda_engine
    from leibnizgym_tpu_torch.ops.engine_v2 import pack_params, pack_state, step_packed
    from leibnizgym_tpu_torch.ops.types import PhysicsState, SceneParams, SolverConfig
except ImportError as exc:  # run outside the repository
    print(f"chip_smoke: cannot import the port ({exc})", file=sys.stderr)
    sys.exit(2)

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
TGS = dict(solver_type=1, substeps=4, solver_iterations=8)

# Kernel vs plain, elementwise |kernel - plain| <= atol + rtol * |plain|.
# nvcc contracts a*b+c into FMAs and the device sinf/cosf differ from
# PyTorch's by an ulp; the contact solve amplifies such differences, most in
# the cube's angular velocity (its inverse inertia is ~1.8e4 1/(kg m^2)).
# Positions and orientations stay within 1e-4; velocities get a relative term.
KERNEL_TOL = {
    "q": (1e-4, 0.0), "qd": (1e-3, 1e-3), "cube_pos": (1e-4, 0.0),
    "cube_quat": (1e-4, 0.0), "cube_linvel": (1e-3, 1e-3),
    "cube_angvel": (5e-3, 5e-3), "wrench": (1e-4, 1e-4),
}
# Golden replay: the goldens' own bound (tests/test_golden_trajectory.py)
# on q, cube_pos and cube_quat; qd, which the goldens do not bound, gets the
# velocity bound above.
GOLDEN_TOL = {"q": 2e-4, "qd": 1e-3, "cube_pos": 2e-4, "cube_quat": 2e-4}
ROWS = {"q": (0, 9), "qd": (9, 18), "cube_pos": (18, 21), "cube_quat": (21, 25),
        "cube_linvel": (25, 28), "cube_angvel": (28, 31)}

failures: list = []


def check(ok: bool, what: str):
    if not ok:
        failures.append(what)
        print(f"FAIL: {what}", flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: n/a"


def cuda_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(out, wrench, ref, ref_wrench):
    """Per-field max abs diff and whether every element is within KERNEL_TOL."""
    diffs, ok = {}, True
    fields = [(k, out[a:b], ref[a:b]) for k, (a, b) in ROWS.items()]
    fields.append(("wrench", wrench, ref_wrench))
    for name, x, y in fields:
        atol, rtol = KERNEL_TOL[name]
        d = (x - y).abs()
        diffs[name] = float(d.max())
        ok &= bool(torch.isfinite(x).all()) and bool((d <= atol + rtol * y.abs()).all())
    return diffs, ok


# ---------------------------------------------------------------------------
# phase 2 inputs
# ---------------------------------------------------------------------------


def random_inputs(n: int, seed: int, dev):
    rng = np.random.default_rng(seed)
    q = np.tile(tf_model.JOINT_POS_DEFAULT, 3) + rng.uniform(-0.4, 0.4, (n, 9))
    qd = rng.uniform(-2.0, 2.0, (n, 9))
    pos = np.stack([rng.uniform(-0.12, 0.12, n), rng.uniform(-0.12, 0.12, n),
                    rng.uniform(0.02, 0.08, n)], -1)
    quat = rng.normal(size=(n, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    lv = rng.uniform(-0.5, 0.5, (n, 3))
    av = rng.uniform(-3.0, 3.0, (n, 3))
    tau = rng.uniform(-0.36, 0.36, (n, 9))
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    state = PhysicsState(t(q), t(qd), t(pos), t(quat), t(lv), t(av))
    dr = {  # per-env scales in the reference's DR ranges
        "cube_mass": rng.uniform(0.8, 1.2, n), "link_masses": rng.uniform(0.9, 1.1, (n, 3)),
        "mu_tip_cube": rng.uniform(0.7, 1.3, n), "mu_cube_ground": rng.uniform(0.7, 1.3, n),
        "restitution_tip_cube": rng.uniform(0.0, 0.8, n),
    }
    return state, t(tau), {k: t(v) for k, v in dr.items()}


def scene_for(case: str, n: int, dr: dict, dev) -> SceneParams:
    shape = "sphere" if case == "tgs_sphere" else "box"
    sp = SceneParams.default(object_shape=shape, device=dev).broadcast(n)
    cone = dict(wall_radius=tf_model.WALL_CONE_BASE_RADIUS,
                wall_slope=tf_model.WALL_CONE_SLOPE, wall_knee_z=tf_model.WALL_CONE_KNEE_Z)
    if case == "tgs_cone":
        for k, v in cone.items():
            getattr(sp, k).fill_(v)
    if case == "tgs_dr":  # per-env params; even envs on the cone, odd on the cylinder
        for k, v in cone.items():
            getattr(sp, k)[::2] = v
        sp.cube_mass *= dr["cube_mass"]
        sp.cube_inertia *= dr["cube_mass"][:, None]
        sp.link_masses *= dr["link_masses"]
        sp.mu_tip_cube *= dr["mu_tip_cube"]
        sp.mu_cube_ground *= dr["mu_cube_ground"]
        sp.restitution_tip_cube.copy_(dr["restitution_tip_cube"])
    return sp


CASES = {
    "pgs": dict(solver_type=0, substeps=4, solver_iterations=8),
    "tgs": TGS,
    "tgs_cone": TGS,
    "tgs_dr": TGS,
    "tgs_sphere": dict(TGS, object_shape=1),
    **{f"tgs_no_{g}": dict(TGS, **{f"enable_{g}": False})
       for g in ("cube_wall", "tip_ground", "tip_wall", "link_cube", "torsion")},
}


def phase_kernel_vs_plain(dev):
    for n in (4096, 1000):
        state, tau, dr = random_inputs(n, SEED + n, dev)
        s31, t9 = pack_state(state), tau.T.contiguous()
        for case, kw in CASES.items():
            cfg = SolverConfig(**kw)
            p40 = pack_params(scene_for(case, n, dr, dev), n)
            out, wrench = cuda_engine.step_packed_cuda(s31, p40, t9, cfg, 0.02)
            ref, ref_w = step_packed(s31, p40, t9, cfg, 0.02)
            torch.cuda.synchronize()
            diffs, ok = compare(out, wrench, ref, ref_w)
            print(f"kernel_vs_plain n={n} case={case} "
                  + " ".join(f"{k}={v:.3e}" for k, v in diffs.items())
                  + f" within_tol={ok}", flush=True)
            check(ok, f"kernel vs plain n={n} case={case}")


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------


def phase_golden(dev):
    for fname in ("traj_d1_seed0.npz", "traj_d1_seed0_cone.npz"):
        data = np.load(os.path.join(ROOT, "tests", "golden", fname), allow_pickle=True)
        meta = json.loads(str(data["meta"]))
        env = tenv.TrifingerEnv(config={
            "num_instances": meta["num_envs"], "task_difficulty": meta["difficulty"],
            "command_mode": "torque", "arena": {"profile": meta.get("arena", "cylinder")},
            "sim": {"substeps": meta["substeps"],
                    "physx": {"num_position_iterations": meta["iterations"],
                              "tpu_solver": meta.get("solver", "pgs")}},
        }, device=dev, verbose=False)
        st, prm = env.static, env.params
        scene = prm.scene_base.broadcast(st.num_envs)
        t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
        worst = dict.fromkeys(GOLDEN_TOL, 0.0)
        for i in range(meta["steps"] - 1):
            state = PhysicsState(*(t(data[k][i]) for k in (
                "q", "qd", "cube_pos", "cube_quat", "cube_linvel", "cube_angvel")))
            tau = tenv.compute_torque(st, prm, t(data["action"][i + 1]), state.q, state.qd)
            new, _ = cuda_engine.physics_step_cuda(state, tau, scene, st.solver, st.dt)
            for k in worst:
                err = float((getattr(new, k) - t(data[k][i + 1])).abs().max())
                worst[k] = max(worst[k], err)
        ok = all(worst[k] <= GOLDEN_TOL[k] for k in worst)
        print(f"golden_replay {fname} steps={meta['steps'] - 1} "
              + " ".join(f"{k}={v:.3e}" for k, v in worst.items())
              + f" within_tol={ok}", flush=True)
        check(ok, f"golden replay {fname}")


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------


def phase_slice(dev, num_envs: int = 8192):
    cfg = default_config()  # gym = trifinger_difficulty_1, rlg = asymm
    cfg["args"]["num_envs"] = num_envs
    cfg["args"]["seed"] = SEED
    cfg = update_cfg(cfg)
    env = tenv.TrifingerEnv(config=copy.deepcopy(cfg["gym"]), device=dev, verbose=False)
    pcfg = ppo.PPOConfig.from_rlg_params(cfg["rlg"]["params"], num_envs)
    st = env.static
    actor, cv = ppo.make_networks(pcfg, st, dev, torch.Generator().manual_seed(SEED))
    check(cv is not None, "the D1 asymmetric config has no central value")
    print(f"slice envs={st.num_envs} obs={st.obs_dim} states={st.state_dim} "
          f"solver=tgs substeps={st.solver.substeps} iters={st.solver.solver_iterations} "
          f"arena_slope={float(env.params.scene_base.wall_slope):.3f}", flush=True)

    # the main path, counted
    cuda_engine.launch_count = 0
    obs = env.reset()
    carry = ppo.RolloutCarry.start(env.state, obs, st.state_dim, pcfg)
    carry, traj = ppo.rollout(pcfg, st, env.params, carry, actor, cv, generator=env.generator)
    with torch.no_grad():
        last_value = cv(carry.states)
    advs = ppo.gae(pcfg, traj.reward, traj.value, traj.done, last_value)
    torch.cuda.synchronize()
    launches = cuda_engine.launch_count

    h, n = pcfg.horizon, st.num_envs
    shapes = {"obs": (h, n, st.obs_dim), "states": (h, n, st.state_dim),
              "action": (h, n, st.action_dim), "value": (h, n), "reward": (h, n),
              "done": (h, n), "neglogp": (h, n)}
    for k, shape in shapes.items():
        x = getattr(traj, k)
        check(tuple(x.shape) == shape and bool(torch.isfinite(x).all()),
              f"trajectory {k}: shape {tuple(x.shape)} != {shape} or not finite")
    check(tuple(advs.shape) == (h, n) and bool(torch.isfinite(advs).all()),
          "gae advantages not finite")
    check(launches == 1 + h, f"launch_count {launches} != {1 + h}")
    print(f"slice rollout horizon={h} launches={launches} "
          f"reward_mean={float(traj.reward.mean()):.6f} adv_abs_mean={float(advs.abs().mean()):.6f} "
          f"value_mean={float(traj.value.mean()):.6f} finite=True", flush=True)

    # rollout throughput after the warm-up rollout above
    ms = cuda_ms(lambda: ppo.rollout(pcfg, st, env.params, carry, actor, cv,
                                     generator=env.generator), 1)
    print(f"slice rollout_ms={ms:.3f} env_steps_per_s={h * n / (ms / 1e3):.1f}", flush=True)

    # kernel vs plain on the main path's own state and shapes
    es = carry.env_state
    s31 = pack_state(es.physics)
    p40 = pack_params(es.scene, n)
    t9 = es.applied_torque.T.contiguous()
    out, wrench = cuda_engine.step_packed_cuda(s31, p40, t9, st.solver, st.dt)
    ref, ref_w = step_packed(s31, p40, t9, st.solver, st.dt)
    torch.cuda.synchronize()
    diffs, ok = compare(out, wrench, ref, ref_w)
    print(f"slice kernel_vs_plain n={n} " + " ".join(f"{k}={v:.3e}" for k, v in diffs.items())
          + f" within_tol={ok}", flush=True)
    check(ok, "kernel vs plain on the slice's state")

    kernel_ms = cuda_ms(lambda: cuda_engine.step_packed_cuda(s31, p40, t9, st.solver, st.dt), 50)
    plain_ms = cuda_ms(lambda: step_packed(s31, p40, t9, st.solver, st.dt), 2)
    print(f"physics_step n={n} kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.2f}", flush=True)
    # the block size the wrapper uses against larger blocks (see the kernel's note)
    print(f"physics_step n={n} ms_by_block_size " + " ".join(
        f"{b}={cuda_ms(lambda: cuda_engine.step_packed_cuda(s31, p40, t9, st.solver, st.dt, b), 50):.4f}"  # noqa: B023
        for b in (32, 64, 128, 256)), flush=True)
    return {"launches": launches, "max_abs_err": max(diffs.values()),
            "ms": kernel_ms, "plain_ms": plain_ms}


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------

EPOCHS = 8
# One learner step on the card against the same step on the CPU, float32 with
# TF32 off: the matmuls and reductions sum in other orders (cuBLAS against the
# CPU BLAS, 8192-sample means), so losses and KL agree to rtol 1e-4. One Adam
# step moves each parameter by lr * g / (|g| + 1e-8), i.e. +-lr unless |g| is
# at rounding level, where the sign may flip: max |diff| <= 2 lr + 1e-6, and
# >= 99.9% of elements within 1e-6.
LEARNER_RTOL = 1e-4


def learner_card_vs_cpu(dev, n: int = 8192, seed: int = SEED):
    """One actor-critic and one central-value step from the same parameters
    and minibatch (one time-sliced row of n envs, as the D1 path gives it)
    on ``dev`` and on the CPU. Returns (worst relative loss/KL diff, worst
    parameter diff, share of parameters within 1e-6, lr equal, ok)."""
    cfg = ppo.PPOConfig()
    gen = torch.Generator().manual_seed(seed)
    ac = tnets.ActorCritic(41, 9, cfg.units, generator=gen)
    cv = tnets.CentralValue(113, cfg.units, generator=gen)
    rng = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32))[None]  # noqa: E731
    obs = t(rng.uniform(-5, 5, (n, 41)))
    with torch.no_grad():
        mu, log_std, _ = ac(obs)
    # the rollout's policy: a little off the current one, so ratio != 1, KL > 0
    mu_old = mu + 0.05 * t(rng.normal(size=(n, 9)))
    log_std_old = log_std - 0.1
    action = mu_old + torch.exp(log_std_old) * t(rng.normal(size=(n, 9)))
    mb = {"obs": obs, "action": action, "mu": mu_old, "log_std": log_std_old,
          "neglogp": tnets.gaussian_neglogp(mu_old, log_std_old, action),
          "advs": t(rng.normal(size=n)), "returns": t(rng.normal(size=n)),
          "value": t(rng.normal(size=n))}
    states = t(rng.uniform(-5, 5, (n, 113)))
    out = {}
    for where in ("cpu", dev):
        a, c = copy.deepcopy(ac).to(where), copy.deepcopy(cv).to(where)
        ac_opt, cv_opt = ppo.make_optimizers(cfg, a, c)
        lr = torch.tensor(cfg.learning_rate, device=where)
        lr, terms = ppo.actor_critic_step(cfg, a, ac_opt, lr, {k: v.to(where) for k, v in mb.items()})
        cv_loss = ppo.central_value_step(cfg, c, cv_opt, states.to(where), mb["returns"].to(where))
        out[str(where)] = ([float(x) for x in terms] + [float(cv_loss)], float(lr),
                           {**{f"ac.{k}": v.cpu() for k, v in a.state_dict().items()},
                            **{f"cv.{k}": v.cpu() for k, v in c.state_dict().items()}})
    (ref_terms, ref_lr, ref_p), (terms, lr, params) = out["cpu"], out[str(dev)]
    rel = max(abs(x - y) / max(abs(y), 1e-6) for x, y in zip(terms, ref_terms))
    diffs = torch.cat([(params[k] - ref_p[k]).abs().reshape(-1) for k in ref_p])
    within = float((diffs <= 1e-6).double().mean())
    worst = float(diffs.max())
    ok = (rel <= LEARNER_RTOL and lr == ref_lr and worst <= 2 * cfg.learning_rate + 1e-6
          and within >= 0.999)
    return rel, worst, within, lr == ref_lr, ok


def phase_training(dev, num_envs: int = 8192, epochs: int = EPOCHS):
    cfg = default_config()  # gym = trifinger_difficulty_1, rlg = asymm
    cfg["args"]["num_envs"] = num_envs
    cfg["args"]["seed"] = SEED
    cfg = update_cfg(cfg)
    marks, history = [], []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    def train_iter(pcfg, static, env_params, ts):
        mark("start")
        metrics = ppo.train_iteration(pcfg, static, env_params, ts, on_phase=mark)
        history.append(metrics)
        return metrics

    with tempfile.TemporaryDirectory() as logdir:
        runner = Runner(copy.deepcopy(cfg["gym"]), cfg["rlg"]["params"], logdir=logdir,
                        seed=SEED, device=dev)
        pcfg, st = runner.ppo_cfg, runner.static
        widths = (st.obs_dim, st.state_dim, pcfg.units, pcfg.minibatch_size,
                  pcfg.cv_minibatch_size, pcfg.mini_epochs, pcfg.cv_mini_epochs, pcfg.horizon)
        check(widths == (41, 113, (400, 200, 100), 8192, 8192, 4, 4, 32),
              f"phase 5 is not the D1 preset at full widths: {widths}")
        runner._train_iter = train_iter

        # the main path, counted
        cuda_engine.launch_count = 0
        runner.reset()
        start = {k: v.clone() for k, v in runner._ckpt_payload()["ac_state_dict"].items()}
        t0 = time.perf_counter()
        runner.train(max_epochs=epochs)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = cuda_engine.launch_count
        h, n = pcfg.horizon, st.num_envs
        check(launches == 1 + h * epochs, f"training launch_count {launches} != {1 + h * epochs}")

        # every epoch's metrics are finite, lr in range; the parameters moved
        rows = [{k: float(v) for k, v in m.items() if not torch.is_tensor(v) or v.dim() == 0}
                for m in history]
        keys = [k for k in rows[0] if k.startswith("losses/")] + ["info/kl", "info/lr"]
        check(len(rows) == epochs and all(np.isfinite(r[k]) for r in rows for k in keys),
              "a loss, kl or lr is not finite")
        # the clamp bounds as float32 holds them (1e-6 is 9.99999997e-07)
        check(all(np.float32(1e-6) <= r["info/lr"] <= np.float32(1e-2) for r in rows),
              "lr outside [1e-6, 1e-2]")
        check(rows[-1]["info/frames"] == epochs * h * n,
              f"info/frames {rows[-1]['info/frames']} != {epochs * h * n}")
        trained = runner._ckpt_payload()
        moved = any(not torch.equal(start[k], v) for k, v in trained["ac_state_dict"].items())
        check(moved, "the parameters did not move")
        for e, r in enumerate(rows, 1):
            print(f"train epoch={e} " + " ".join(f"{k}={r[k]:.6g}" for k in keys)
                  + f" step_reward={r['rewards/step_mean']:.6g}", flush=True)

        # the final checkpoint restores bit-identically into a fresh Runner
        fresh = Runner(copy.deepcopy(cfg["gym"]), cfg["rlg"]["params"], logdir=logdir,
                       seed=SEED + 1, device=dev)
        fresh.restore(os.path.join(runner.nn_dir, "final"))
        restored = fresh._ckpt_payload()
        same = all(torch.equal(restored[part][k], v) for part in ("ac_state_dict", "cv_state_dict")
                   for k, v in trained[part].items())
        check(same and restored["epoch"] == epochs, "final checkpoint did not restore exactly")
        play_reward = runner.play(num_steps=3)
        check(np.isfinite(play_reward), "play gave a non-finite reward")
        print(f"train epochs={epochs} launches={launches} wall_s={wall_s:.3f} "
              f"restore_bit_identical={same} play_reward={play_reward:.6g}", flush=True)

        # the kernel against its plain version on the trained path's state
        es = runner.ts.carry.env_state
        s31, p40 = pack_state(es.physics), pack_params(es.scene, n)
        t9 = es.applied_torque.T.contiguous()
        out, wrench = cuda_engine.step_packed_cuda(s31, p40, t9, st.solver, st.dt)
        ref, ref_w = step_packed(s31, p40, t9, st.solver, st.dt)
        torch.cuda.synchronize()
        diffs, ok = compare(out, wrench, ref, ref_w)
        print(f"train kernel_vs_plain n={n} " + " ".join(f"{k}={v:.3e}" for k, v in diffs.items())
              + f" within_tol={ok}", flush=True)
        check(ok, "kernel vs plain on the trained state")

    rel, worst, within, lr_same, ok = learner_card_vs_cpu(dev)
    print(f"learner card_vs_cpu loss_kl_rel={rel:.3e} param_max_abs={worst:.3e} "
          f"param_within_1e-6={within:.6f} lr_equal={lr_same} within_tol={ok}", flush=True)
    check(ok, "learner step on the card vs the CPU")

    # epoch time (start to next start) and its split, epochs 2.. (1 = warm-up)
    per_epoch = [marks[i:i + 4] for i in range(0, len(marks), 4)]
    check(len(per_epoch) == epochs and all([m[0] for m in p] == ["start", "rollout", "gae", "update"]
                                            for p in per_epoch), "phase marks out of order")
    split = {name: [p[j - 1][1].elapsed_time(p[j][1]) for p in per_epoch[1:]]
             for j, name in ((1, "rollout"), (2, "gae"), (3, "update"))}
    epoch_ms = [a[0][1].elapsed_time(b[0][1]) for a, b in zip(per_epoch[1:], per_epoch[2:])]
    med = float(np.median(epoch_ms))
    print(f"{smi()} train epoch_ms median={med:.3f} min={min(epoch_ms):.3f} "
          f"max={max(epoch_ms):.3f} n={len(epoch_ms)} all=" + ",".join(f"{x:.3f}" for x in epoch_ms),
          flush=True)
    for name, xs in split.items():
        print(f"{smi()} train {name}_ms median={float(np.median(xs)):.3f} min={min(xs):.3f} "
              f"max={max(xs):.3f} n={len(xs)}", flush=True)
    print(f"{smi()} train env_steps_per_s={h * n / (med / 1e3):.1f} "
          f"(32 x {n} / median epoch)", flush=True)
    return {"launches": launches, "max_abs_err": max(diffs.values())}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"device torch={torch.__version__} cuda={torch.version.cuda} name={name}", flush=True)
    print(smi(), flush=True)
    t0 = time.perf_counter()
    cuda_engine.build()
    info = cuda_engine.build_info
    print(f"build seconds={time.perf_counter() - t0:.2f} registers={info.get('registers')} "
          f"stack_frame_bytes={info.get('stack_frame_bytes')} "
          f"spill_store_bytes={info.get('spill_store_bytes')} "
          f"spill_load_bytes={info.get('spill_load_bytes')}", flush=True)

    phase_kernel_vs_plain(dev)
    phase_golden(dev)
    record = phase_slice(dev)
    trained = phase_training(dev)
    record = dict(record, launches=trained["launches"],
                  max_abs_err=max(record["max_abs_err"], trained["max_abs_err"]))

    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
        return 1
    print(smi(), flush=True)
    print(json.dumps({"kernels": [{
        "name": "physics_step", "route": "cuda",
        "source": "leibnizgym_tpu_torch/csrc/physics_step.cu",
        "replaces": "leibnizgym_tpu/ops/pallas_engine.py:131",
        **record,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
