"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
 1. device: torch version, card name and power limit, TF32 off, kernel build
    with its registers, spills, shared memory per block and resident blocks
    per SM (every one of 8192 envs resident at once);
 2. kernel vs plain: the CUDA physics kernel against its plain PyTorch version
    on seeded random states, N = 4096 and a ragged N = 1000, over PGS / TGS,
    each contact gate off, per-env (DR-like) params, cylinder / cone arenas
    and the sphere object (``CASES``);
 3. golden one-step replay: the kernel steps each recorded state of
    tests/golden/traj_d1_seed0{,_cone}.npz and is held to the next one;
 4. the rollout: the D1 training preset with the asymmetric agent config at
    8192 envs: reset, one 32-step rollout of actor + central value, GAE; the
    kernel must be launched exactly 33 times; then timings: the kernel on
    that state beside its bound (``cuda_engine.bound_ms``: operations over
    the card's float32 rate, bytes over its memory rate), its GFLOP/s, the
    chain figure and the plain version's time; the split of its time into
    build and sweep (iterations 1/2/4/8, substeps 1/4, a linear fit); the
    launch geometry (32 envs per block, the one the design allows);
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
    warm-up) and training env-steps/s;
 6. the D4 flagship: ``trifinger_difficulty_4_curriculum_dr`` (domain
    randomization, keypoint obs, success-gated curriculum, cone arena) with
    the asymmetric agent config and the preset's agent overrides, 8192 envs,
    full widths (obs 89, states 161), through ``Runner.train`` for a warm-up
    epoch and 3 timed ones. Checks: 1 + 32 * 4 kernel launches, finite
    losses, KL and lr in range, the curriculum level in [0, 1] with the
    tolerances on its lerp, DR live (per-env cube mass and size and PD
    scales spread inside their ranges, inertia = mass * size^2), the kernel
    against its plain version on the trained DR state and scenes, with the
    referees of KERNEL_TOL's note; then its time there and the epoch split;
 7. replay of the shipped D4 policies (``leibnizgym_tpu_torch/resources/
    policies/*.npz``) through the port's eval, deterministic, level 1.0,
    1024 envs for one 750-step episode, each under the recipe it was trained
    on: the per-goal solve rate of tests/test_shipped_policies.py must be
    >= 0.90 with >= 200 goals solved; the raw and censoring-corrected rates
    and the median solve time print beside the JAX package's recorded ones;
 8. bfloat16 training: phase 5's preset with ``mixed_precision=True`` through
    ``Runner.train`` for a warm-up epoch and 3 timed ones at full widths.
    Checks: 1 + 32 * 4 kernel launches, finite losses, KL and lr in range,
    the parameters moved, the ``final`` checkpoint restored bit-identically,
    and the trained towers' bfloat16 forward against their float32 forward
    on a seeded batch within ``BF16_REL``; then its epoch split beside phase
    5's float32 one;
 9. the NaN path: phase 5's preset with ``nan_telemetry=True``: two clean
    epochs (every ``nan/*`` key, every ``*_fin`` 1, ``kl_first_bad`` -1, the
    loop at depth 1); then one env's cube is given a finite but degenerate
    velocity (``DEGENERATE_LINVEL``) before epoch 3, through a hook on
    ``Runner._train_iter``. Checks: the halt at epoch 3, ``nan_prev_ts.pt``
    holding epoch 2's state, ``nan_replay`` naming step 0 and that env,
    ``nan_microscope`` reproducing the blow-up on the card, and the kernel
    and the plain version going non-finite at the same substep of its walk,
    in the same fields;
10. the tools path, at the reference scripts' defaults: ``trajectory_parity``
    dumps 64 envs x 100 steps (D1, torque, 2 substeps, 4 TGS iterations) on
    the card (1 + 100 launches) and, from the same draws and actions, on the
    CPU through the plain version; each recorded card state, stepped once by
    the plain version, must land on the next within KERNEL_TOL and its
    referees; the free run's ``compare`` verdict prints ungated (contacts
    make it chaotic). ``benchmark.py``'s sweep over 1024 / 4096 / 8192 /
    16384 envs (100 steps, 2 substeps, random actions; 1 + 2 x 100 launches
    each, the reference script's YAML keys); one 50-step chunk of
    ``trifinger_random_action`` at 8192 envs (1 + 50 launches); the 10 robot
    URDFs parsed by the port's parser built here, and ``chain_physics_step``
    at 8192 envs in float32 on the card against float64 on the CPU for the
    first 64 envs (``CHAIN_TOL``), with ms per step.
The last two lines are the kernels' JSON record (times, flops, bytes and
bound from phase 6; launches summed over the counted paths of phases 4-6
and 8-10) and the device JSON line.
Needs a CUDA device and the repository around it; imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

try:
    import numpy as np
    import torch
    import yaml

    from leibnizgym_tpu_torch.config.presets import default_config, parse_cli, update_cfg
    from leibnizgym_tpu_torch.models import trifinger as tf_model
    from leibnizgym_tpu_torch.envs.trifinger import env as tenv
    from leibnizgym_tpu_torch.learning import ppo
    from leibnizgym_tpu_torch.learning.runner import Runner
    from leibnizgym_tpu_torch.models import networks as tnets
    from leibnizgym_tpu_torch.ops import cuda_engine
    from leibnizgym_tpu_torch.ops.engine_v2 import pack_params, pack_state, step_packed
    from leibnizgym_tpu_torch.ops.types import PhysicsState, SceneParams, SolverConfig
    from leibnizgym_tpu_torch.models.chain import chain_from_urdf
    from leibnizgym_tpu_torch.ops import generic_chain
    from leibnizgym_tpu_torch.scripts import (
        benchmark,
        nan_microscope,
        nan_replay,
        trajectory_parity,
        trifinger_random_action,
    )
    from leibnizgym_tpu_torch.utils.helpers import smi
    from leibnizgym_tpu_torch.scripts.eval_policy import (
        goal_solve_stats,
        record_goals,
        window_solve_rate,
    )
except ImportError as exc:  # run outside the repository
    print(f"chip_smoke: cannot import the port ({exc})", file=sys.stderr)
    sys.exit(2)

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
TGS = dict(solver_type=1, substeps=4, solver_iterations=8)

# Kernel vs plain, elementwise |kernel - plain| <= atol + rtol * |plain|.
# nvcc contracts a*b+c into FMAs, the kernel sums each solver row in its own
# order and the device sinf/cosf differ from PyTorch's by an ulp; the contact
# solve amplifies such differences, most in the cube's angular velocity (its
# inverse inertia is ~1.8e4 1/(kg m^2)). Positions and orientations stay
# within 1e-4; velocities get a relative term.
# On the trained D4 + DR state (phase 6) two referees take envs outside that
# bound (``kernel_vs_plain(..., referee=True)``); phases 2-5 hold the plain
# bound alone:
#  - float64: on a resting cube both float32 versions can land ~4e-3 rad/s
#    off the float64 angular velocity, in opposite directions (measured on
#    the H100 on D1 and D4 + DR states, about one element in 25 states of
#    8192 envs). Such an env passes if the kernel is within the same bound of
#    the plain version run in float64 on the same inputs.
#  - joint limit: the step is discontinuous where a joint reaches its limit
#    (q clipped, qd zeroed), and there the plain version itself, even in
#    float64, lands on one of two answers when its inputs move by float32
#    rounding (measured on the H100 with a draft of the kernel: a finger at
#    its joint-1 limit on the D1 state, qd -4.195 or 9.759 under 3e-7
#    relative moves of the state). An env outside both bounds passes only if
#    a joint of it sits exactly on a limit (in its input, the kernel's output
#    or one of the outcomes below), the float64 plain version on PERTURB
#    copies of its inputs, state moved by PERTURB_REL relative, spreads
#    beyond the bound by itself, and the kernel is within the bound of one of
#    those outcomes; at most MAX_SPLIT envs per state. Such envs are counted
#    apart and left out of the reported max_abs_err.
KERNEL_TOL = {
    "q": (1e-4, 0.0), "qd": (1e-3, 1e-3), "cube_pos": (1e-4, 0.0),
    "cube_quat": (1e-4, 0.0), "cube_linvel": (1e-3, 1e-3),
    "cube_angvel": (5e-3, 5e-3), "wrench": (1e-4, 1e-4),
}
PERTURB, PERTURB_REL, MAX_SPLIT = 256, 3e-7, 4
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


def cuda_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def env_within(out, wrench, ref, ref_wrench):
    """(N,) bool: every element of the env's column within KERNEL_TOL."""
    ok = torch.isfinite(out).all(0) & torch.isfinite(wrench).all(0)
    fields = [(k, out[a:b], ref[a:b]) for k, (a, b) in ROWS.items()]
    fields.append(("wrench", wrench, ref_wrench))
    for name, x, y in fields:
        atol, rtol = KERNEL_TOL[name]
        ok &= ((x - y).abs() <= atol + rtol * y.abs()).all(0)
    return ok


def at_joint_limit(q, cfg) -> torch.Tensor:
    """(N,) bool: some joint of the env exactly on its lower or upper limit
    (the limits rounded to q's dtype, as the step's clip leaves them)."""
    lims = [torch.tensor(x, dtype=q.dtype, device=q.device)[:, None]
            for x in (cfg.joint_limit_lower, cfg.joint_limit_upper)]
    return ((q == lims[0]) | (q == lims[1])).any(0)


def on_joint_limit_split(e, out, wrench, packed, cfg, dt) -> bool:
    """The joint-limit referee of KERNEL_TOL's note for env e."""
    s31, p40, t9 = (x[:, e:e + 1].double().repeat(1, PERTURB) for x in packed)
    gen = torch.Generator(device=s31.device).manual_seed(SEED + e)
    s31[:, 1:] *= 1 + PERTURB_REL * torch.randn(s31[:, 1:].shape, generator=gen,
                                                 device=s31.device, dtype=s31.dtype)
    outs, wrenches = step_packed(s31, p40, t9, cfg, dt)
    q = ROWS["q"]
    on_limit = bool(at_joint_limit(packed[0][q[0]:q[1], e:e + 1], cfg).any()
                    or at_joint_limit(out[q[0]:q[1], e:e + 1], cfg).any()
                    or at_joint_limit(outs[q[0]:q[1]], cfg).any())
    spread = not bool(env_within(outs, wrenches, outs[:, :1].expand_as(outs),
                                 wrenches[:, :1].expand_as(wrenches)).all())
    ours = env_within(out[:, e:e + 1].double().expand_as(outs),
                      wrench[:, e:e + 1].double().expand_as(wrenches), outs, wrenches)
    return on_limit and spread and bool(ours.any())


def kernel_vs_plain(tag: str, packed, cfg, dt, referee: bool = False, result=None):
    """The kernel against its plain version on packed inputs, with the two
    referees of KERNEL_TOL's note when ``referee``; prints one line and
    checks. ``result`` = (state (31, N), impulses (18, N) or None) held to
    the plain version in place of a launch (a recorded kernel output; None
    impulses are not compared). Returns the per-field max abs diffs to the
    float32 plain version over the envs that no joint-limit referee took."""
    s31, p40, t9 = packed
    out, wrench = result or cuda_engine.step_packed_cuda(s31, p40, t9, cfg, dt)
    ref, ref_w = step_packed(s31, p40, t9, cfg, dt)
    if wrench is None:
        wrench = ref_w
    torch.cuda.synchronize()
    bad = ~env_within(out, wrench, ref, ref_w)
    keep = torch.ones_like(bad)
    note = ""
    ok = not bool(bad.any())
    if not ok and referee:
        ref64, ref64_w = step_packed(s31.double(), p40.double(), t9.double(), cfg, dt)
        bad64 = torch.nonzero(bad & ~env_within(out.double(), wrench.double(), ref64,
                                                ref64_w)).flatten().tolist()
        split = [e for e in bad64[:MAX_SPLIT]
                 if on_joint_limit_split(e, out, wrench, packed, cfg, dt)]
        keep[split] = False
        ok = len(split) == len(bad64)
        note = (f" envs_outside_float32_plain={int(bad.sum())} refereed_float64="
                f"{int(bad.sum()) - len(bad64)} outside_float64_plain={len(bad64)} "
                f"refereed_joint_limit={len(split)} envs={bad64[:MAX_SPLIT]}")
    diffs = max_diffs(out[:, keep], wrench[:, keep], ref[:, keep], ref_w[:, keep])
    print(f"{tag} kernel_vs_plain n={s31.shape[1]} "
          + " ".join(f"{k}={v:.3e}" for k, v in diffs.items()) + note
          + f" within_tol={ok}", flush=True)
    check(ok, f"kernel vs plain: {tag}")
    return diffs


def max_diffs(out, wrench, ref, ref_wrench) -> dict:
    """Per-field max abs diff."""
    fields = [(k, out[a:b], ref[a:b]) for k, (a, b) in ROWS.items()]
    fields.append(("wrench", wrench, ref_wrench))
    return {name: float((x - y).abs().max()) for name, x, y in fields}


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
            kernel_vs_plain(f"case={case}", (s31, p40, t9), cfg, 0.02)


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
    diffs = kernel_vs_plain("slice", (s31, p40, t9), st.solver, st.dt)

    timing = time_kernel("d1", (s31, p40, t9), st.solver, st.dt)
    kernel_split((s31, p40, t9), st.solver, st.dt)
    # the launch geometry the design allows (see the kernel's source note):
    # 32 envs and 4 warps per block, every env resident at once
    occ = cuda_engine.occupancy()
    epb = occ["envs_per_block"]
    print(f"{smi()} physics_step d1 n={n} geometry envs_per_block={epb} "
          f"threads_per_block={4 * epb} blocks={-(-n // epb)} "
          f"resident_blocks_per_sm={occ['blocks_per_sm']} "
          f"dynamic_smem_bytes_per_block={occ['dynamic_smem_bytes']} "
          f"kernel_ms={timing['ms']:.4f}", flush=True)
    return {"launches": launches, "max_abs_err": max(diffs.values()), **timing}


def time_kernel(tag: str, packed, cfg, dt):
    """The kernel's time per launch (CUDA events over 50 launches) beside
    its bound, its achieved rate, the chain figure and the plain version's
    time. Returns the kernels' JSON record's timing keys."""
    s31, p40, t9 = packed
    n = s31.shape[1]
    launch = lambda: cuda_engine.step_packed_cuda(s31, p40, t9, cfg, dt)  # noqa: E731
    launch()
    kernel_ms = cuda_ms(launch, 50)
    plain_ms = cuda_ms(lambda: step_packed(s31, p40, t9, cfg, dt), 2)
    flops, nbytes = cuda_engine.step_flops(cfg), cuda_engine.step_bytes(n)
    bound, bound_by = cuda_engine.bound_ms(cfg, n)
    chain_ms = cuda_engine.step_chain(cfg) * CHAIN_CYCLES / (sm_clock_mhz() * 1e3)
    print(f"{smi()} physics_step {tag} n={n} kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.2f} "
          f"bound_ms={bound:.5f} bound_by={bound_by} bound_share={bound / kernel_ms:.4f} "
          f"flops_per_env={flops} bytes={nbytes} gflops_per_s={flops * n / kernel_ms / 1e6:.1f} "
          f"chain_ops={cuda_engine.step_chain(cfg)} chain_ms={chain_ms:.4f}", flush=True)
    # no single PyTorch call computes the step: no library time
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "flops": flops * n, "bytes": nbytes, "library_ms": None}


# dependent operations take ~4 cycles each on the SM (the chain figure)
CHAIN_CYCLES = 4


def sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def kernel_split(packed, cfg, dt):
    """The kernel's time for solver_iterations in {1, 2, 4, 8} and substeps
    in {1, 4} (runtime fields, no rebuild), and the least-squares fit
    t = launch + substeps * (build + iterations * sweep)."""
    s31, p40, t9 = packed
    rows, times = [], {}
    # two passes, the first a warm-up of every configuration (the card's
    # clock ramps up under load), the second timed
    for timed in (False, True):
        for s in (1, 4):
            for i in (1, 2, 4, 8):
                c = dataclasses.replace(cfg, substeps=s, solver_iterations=i)
                ms = cuda_ms(lambda: cuda_engine.step_packed_cuda(s31, p40, t9, c, dt), 50)  # noqa: B023
                if timed:
                    times[(s, i)] = ms
                    rows.append((1.0, s, s * i))
    a, b, c = np.linalg.lstsq(np.array(rows), np.array(list(times.values())), rcond=None)[0]
    total = times[(cfg.substeps, cfg.solver_iterations)]
    print(f"{smi()} physics_step split n={s31.shape[1]} " + " ".join(
        f"s{s}_i{i}={t:.4f}" for (s, i), t in times.items())
        + f" fit_launch_ms={a:.4f} fit_build_ms_per_substep={b:.4f} "
          f"fit_sweep_ms_per_iteration={c:.5f} build_share="
          f"{cfg.substeps * b / total:.3f} sweep_share="
          f"{cfg.substeps * cfg.solver_iterations * c / total:.3f}", flush=True)


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
    train_iter = marked_train_iter(history, marks)

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
        check_epoch_metrics("train", history, epochs, h, n)
        trained = runner._ckpt_payload()
        moved = any(not torch.equal(start[k], v) for k, v in trained["ac_state_dict"].items())
        check(moved, "the parameters did not move")

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
        diffs, _ = kernel_vs_plain_on("train", runner.ts.carry.env_state, st)

    rel, worst, within, lr_same, ok = learner_card_vs_cpu(dev)
    print(f"learner card_vs_cpu loss_kl_rel={rel:.3e} param_max_abs={worst:.3e} "
          f"param_within_1e-6={within:.6f} lr_equal={lr_same} within_tol={ok}", flush=True)
    check(ok, "learner step on the card vs the CPU")

    split = print_epoch_split("train", marks, epochs, h, n)
    return {"launches": launches, "max_abs_err": max(diffs.values()), "split": split}


def check_epoch_metrics(tag: str, history: list, epochs: int, h: int, n: int) -> list:
    """Every epoch's losses, KL and lr finite, lr within its clamp, the
    frame count; prints one line per epoch and returns the scalar rows."""
    rows = [{k: float(v) for k, v in m.items() if not torch.is_tensor(v) or v.dim() == 0}
            for m in history]
    keys = [k for k in rows[0] if k.startswith("losses/")] + ["info/kl", "info/lr"]
    check(len(rows) == epochs and all(np.isfinite(r[k]) for r in rows for k in keys),
          f"{tag}: a loss, kl or lr is not finite")
    # the clamp bounds as float32 holds them (1e-6 is 9.99999997e-07)
    check(all(np.float32(1e-6) <= r["info/lr"] <= np.float32(1e-2) for r in rows),
          f"{tag}: lr outside [1e-6, 1e-2]")
    check(rows[-1]["info/frames"] == epochs * h * n,
          f"{tag}: info/frames {rows[-1]['info/frames']} != {epochs * h * n}")
    for e, r in enumerate(rows, 1):
        print(f"{tag} epoch={e} " + " ".join(f"{k}={r[k]:.6g}" for k in keys)
              + f" step_reward={r['rewards/step_mean']:.6g}", flush=True)
    return rows


def kernel_vs_plain_on(tag: str, es, st, referee: bool = False):
    """The kernel against its plain version on an env state and its per-env
    scenes; returns (per-field max abs diffs, packed inputs)."""
    n = st.num_envs
    packed = (pack_state(es.physics), pack_params(es.scene, n),
              es.applied_torque.T.contiguous())
    return kernel_vs_plain(tag, packed, st.solver, st.dt, referee), packed


def marked_train_iter(history: list, marks: list):
    """``ppo.train_iteration`` recording its metrics in ``history`` and a
    CUDA event at its start and after each of its phases in ``marks``."""

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    def train_iter(pcfg, static, env_params, ts):
        mark("start")
        metrics = ppo.train_iteration(pcfg, static, env_params, ts, on_phase=mark)
        history.append(metrics)
        return metrics

    return train_iter


def print_epoch_split(tag: str, marks: list, epochs: int, h: int, n: int) -> dict:
    """Epoch time (start to next start) and its split into rollout / GAE /
    update, epochs 2.. (1 = warm-up), next to the card's name and limit.
    Returns the medians (ms) by name, the epoch's under "epoch"."""
    per_epoch = [marks[i:i + 4] for i in range(0, len(marks), 4)]
    check(len(per_epoch) == epochs and all([m[0] for m in p] == ["start", "rollout", "gae", "update"]
                                            for p in per_epoch), f"{tag}: phase marks out of order")
    split = {name: [p[j - 1][1].elapsed_time(p[j][1]) for p in per_epoch[1:]]
             for j, name in ((1, "rollout"), (2, "gae"), (3, "update"))}
    epoch_ms = [a[0][1].elapsed_time(b[0][1]) for a, b in zip(per_epoch[1:], per_epoch[2:])]
    med = float(np.median(epoch_ms))
    print(f"{smi()} {tag} epoch_ms median={med:.3f} min={min(epoch_ms):.3f} "
          f"max={max(epoch_ms):.3f} n={len(epoch_ms)} all=" + ",".join(f"{x:.3f}" for x in epoch_ms),
          flush=True)
    for name, xs in split.items():
        print(f"{smi()} {tag} {name}_ms median={float(np.median(xs)):.3f} min={min(xs):.3f} "
              f"max={max(xs):.3f} n={len(xs)}", flush=True)
    print(f"{smi()} {tag} env_steps_per_s={h * n / (med / 1e3):.1f} "
          f"(32 x {n} / median epoch)", flush=True)
    return {"epoch": med, **{k: float(np.median(v)) for k, v in split.items()}}


# ---------------------------------------------------------------------------
# phase 6
# ---------------------------------------------------------------------------

D4_PRESET = "trifinger_difficulty_4_curriculum_dr"
D4_EPOCHS = 4  # a warm-up epoch, then 3 timed epochs


def phase_d4(dev, num_envs: int = 8192, epochs: int = D4_EPOCHS):
    """The D4 flagship recipe (DR, keypoint obs, success-gated curriculum)
    through Runner.train at full widths; returns the kernel's record."""
    cfg = parse_cli([f"gym={D4_PRESET}"])  # rlg = asymm, with the preset's rlg_overrides
    cfg["args"]["num_envs"] = num_envs
    cfg["args"]["seed"] = SEED
    cfg = update_cfg(cfg)
    marks, history = [], []
    with tempfile.TemporaryDirectory() as logdir:
        runner = Runner(copy.deepcopy(cfg["gym"]), cfg["rlg"]["params"], logdir=logdir,
                        seed=SEED, device=dev)
        pcfg, st = runner.ppo_cfg, runner.static
        widths = (st.obs_dim, st.state_dim, pcfg.units, pcfg.minibatch_size,
                  pcfg.cv_minibatch_size, pcfg.mini_epochs, pcfg.cv_mini_epochs, pcfg.horizon,
                  st.solver.substeps, st.solver.solver_iterations, st.solver.solver_type)
        check(widths == (89, 161, (400, 200, 100), 8192, 8192, 4, 4, 32, 4, 8, 1),
              f"phase 6 is not the D4 preset at full widths: {widths}")
        base = runner.env_params.scene_base
        check(st.dr_activate and st.use_keypoint_obs and st.curriculum_success_gated
              and float(base.wall_slope) > 0, "phase 6 lacks DR, keypoints, the gated "
              "curriculum or the cone arena")
        runner._train_iter = marked_train_iter(history, marks)

        # this slice's path, counted
        cuda_engine.launch_count = 0
        runner.reset()
        t0 = time.perf_counter()
        runner.train(max_epochs=epochs)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = cuda_engine.launch_count
        h, n = pcfg.horizon, st.num_envs
        check(launches == 1 + h * epochs, f"d4 launch_count {launches} != {1 + h * epochs}")
        rows = check_epoch_metrics("d4", history, epochs, h, n)

        # the curriculum level and the tolerances at that level
        for e, r in enumerate(rows, 1):
            lvl = r["env/curriculum_level"]
            pos = st.position_tolerance_init + lvl * (st.position_tolerance
                                                      - st.position_tolerance_init)
            ori = st.orientation_tolerance_init + lvl * (st.orientation_tolerance
                                                         - st.orientation_tolerance_init)
            ok = (0.0 <= lvl <= 1.0 and abs(r["env/position_tolerance"] - pos) <= 1e-6
                  and abs(r["env/orientation_tolerance"] - ori) <= 1e-6
                  and 0.0 <= r["env/strict_success_frac"] <= 1.0)
            print(f"d4 epoch={e} curriculum_level={lvl:.6g} "
                  f"position_tolerance={r['env/position_tolerance']:.6g} "
                  f"orientation_tolerance={r['env/orientation_tolerance']:.6g} "
                  f"strict_success_frac={r['env/strict_success_frac']:.6g} lerp_ok={ok}", flush=True)
            check(ok, f"d4 epoch {e}: level or tolerances off the lerp")

        # DR is live: per-env draws spread inside the configured ranges
        es = runner.ts.carry.env_state
        ranges = {k: (lo, hi) for k, lo, hi in st.dr_ranges}
        mass = es.scene.cube_mass / base.cube_mass
        size = es.scene.cube_half_extents / base.cube_half_extents
        spreads = {"cube_mass_scale": mass, "cube_size_scale": size,
                   "pd_gain_scale": es.pd_scale}
        bounds = dict(ranges, pd_gain_scale=st.dr_pd_gain_scale)
        for name, x in spreads.items():
            lo, hi = bounds[name]
            ok = (float(x.min()) >= lo - 1e-5 and float(x.max()) <= hi + 1e-5
                  and float(x.std()) > 0)
            print(f"d4 dr {name} min={float(x.min()):.6f} max={float(x.max()):.6f} "
                  f"std={float(x.std()):.6f} range=({lo}, {hi}) live={ok}", flush=True)
            check(ok, f"d4 DR {name} not live inside {lo, hi}")
        inertia = base.cube_inertia * (mass * size[:, 0] ** 2)[:, None]
        check(bool(torch.allclose(es.scene.cube_inertia, inertia, rtol=1e-5)),
              "d4 DR inertia is not mass * size^2")
        print(f"d4 epochs={epochs} launches={launches} wall_s={wall_s:.3f}", flush=True)

        # the kernel against its plain version on the trained DR state and scenes
        diffs, (s31, p40, t9) = kernel_vs_plain_on("d4", es, st, referee=True)
        timing = time_kernel("d4_dr", (s31, p40, t9), st.solver, st.dt)
        if runner.writer is not None:
            runner.writer.close()
    print_epoch_split("d4", marks, epochs, h, n)
    return {"launches": launches, "max_abs_err": max(diffs.values()), **timing}


# ---------------------------------------------------------------------------
# phase 7
# ---------------------------------------------------------------------------

POLICY_DIR = os.path.join(ROOT, "leibnizgym_tpu_torch", "resources", "policies")
# policy, gym preset, overrides it was trained under, and the JAX package's
# recorded eval of that recipe (raw, censoring-corrected, median steps):
# results/d4dr_cone_s42_eval_r5.json (RESULTS.md:343), results/d4_eval_r4.json
# (RESULTS.md:55-60), results/d4rot_scratch_eval_r5.json (RESULTS.md:374-378)
REPLAYS = (
    ("d4_dr_cone_best_curriculum", "trifinger_difficulty_4_curriculum_dr", (),
     (0.974, 0.9982, 19.0)),
    ("d4_best_curriculum", "trifinger_difficulty_4_curriculum",
     ("gym.arena.profile=cylinder",), (0.9763, 0.999, 18.0)),
    ("d4_rotating_best_curriculum", "trifinger_difficulty_4_curriculum_rotating", (),
     (0.9748, 0.9989, 18.0)),
)
REPLAY_ENVS, REPLAY_STEPS = 1024, 750  # one full episode
SOLVE_GATE, MIN_SOLVED = 0.90, 200  # tests/test_shipped_policies.py:71-80


def phase_replay(dev):
    """Each shipped policy, deterministic, at level 1.0, for one episode
    through the port's eval; returns [(name, window rate, stats)]."""
    results = []
    for name, gym, overrides, (j_raw, j_cor, j_med) in REPLAYS:
        cfg = update_cfg(parse_cli([f"gym={gym}", f"args.num_envs={REPLAY_ENVS}",
                                    "args.play=True", f"args.seed={SEED}", *overrides]))
        with tempfile.TemporaryDirectory() as logdir:
            runner = Runner(cfg["gym"], cfg["rlg"]["params"], logdir=logdir, seed=SEED,
                            device=dev)
            runner.reset()
            runner.restore(os.path.join(POLICY_DIR, name + ".npz"))
            st = runner.static
            cuda_engine.launch_count = 0
            t0 = time.perf_counter()
            record = record_goals(runner, REPLAY_STEPS, level=1.0, deterministic=True, seed=SEED)
            wall_s = time.perf_counter() - t0
            launches = cuda_engine.launch_count
            if runner.writer is not None:
                runner.writer.close()
        check(launches == 1 + REPLAY_STEPS, f"{name}: launch_count {launches} != "
              f"{1 + REPLAY_STEPS}")
        stats = goal_solve_stats(*record, st.episode_length, st.position_tolerance,
                                 st.orientation_tolerance)
        solved, attempts, rate = window_solve_rate(record[0])
        corrected = stats.get("censoring_corrected", {}).get("corrected_solve_rate")
        print(f"replay {name} gym={gym} dr={st.dr_activate} rotation={st.goal_rotation_active} "
              f"arena_slope={float(runner.env.params.scene_base.wall_slope):.3f} "
              f"envs={st.num_envs} steps={REPLAY_STEPS} launches={launches} wall_s={wall_s:.3f} "
              f"goals={stats['goals_attempted']} solved={solved} gate_attempts={attempts} "
              f"gate_rate={rate:.6f} raw={stats['goal_solve_rate']} corrected={corrected} "
              f"median_steps={stats['solve_time_steps']['median']} "
              f"jax_recorded raw={j_raw} corrected={j_cor} median_steps={j_med}", flush=True)
        check(solved >= MIN_SOLVED and rate >= SOLVE_GATE,
              f"{name}: per-goal solve {rate:.4f} ({solved}/{attempts}) below {SOLVE_GATE}")
        results.append((name, rate, stats))
    return results


# ---------------------------------------------------------------------------
# phase 8
# ---------------------------------------------------------------------------

BF16_EPOCHS = 4  # a warm-up epoch, then 3 timed epochs
# The bfloat16 towers against their float32 forward on the same weights:
# bfloat16 keeps 8 mantissa bits, so each layer rounds its input, weight and
# output by up to 2^-9 relative; over four layers and the head the outputs
# moved by 0.53% (mu) and 0.75% / 0.66% (values) of their largest magnitude
# on random D1-width towers on the CPU. Bound: 2% of the largest magnitude.
BF16_REL = 2e-2


def d1_config(num_envs: int, **agent):
    """The D1 preset with the asymmetric agent config at ``num_envs``, seed
    SEED, with ``agent`` set in the agent's config."""
    cfg = default_config()  # gym = trifinger_difficulty_1, rlg = asymm
    cfg["args"]["num_envs"] = num_envs
    cfg["args"]["seed"] = SEED
    cfg = update_cfg(cfg)
    cfg["rlg"]["params"]["config"].update(agent)
    return cfg


def check_d1_widths(tag: str, runner):
    pcfg, st = runner.ppo_cfg, runner.static
    widths = (st.obs_dim, st.state_dim, pcfg.units, pcfg.minibatch_size,
              pcfg.cv_minibatch_size, pcfg.mini_epochs, pcfg.cv_mini_epochs, pcfg.horizon)
    check(widths == (41, 113, (400, 200, 100), 8192, 8192, 4, 4, 32),
          f"{tag} is not the D1 preset at full widths: {widths}")


def bf16_vs_f32(runner, n: int = 8192) -> dict:
    """The trained towers' bfloat16 forward against their float32 forward on
    a seeded batch: max |diff| over the largest |float32 output|, per
    output."""
    rng = np.random.default_rng(SEED)
    dev = runner.device
    obs = torch.as_tensor(rng.uniform(-5, 5, (n, 41)).astype(np.float32), device=dev)
    states = torch.as_tensor(rng.uniform(-5, 5, (n, 113)).astype(np.float32), device=dev)
    out = {}
    with torch.no_grad():
        for names, tower, x in ((("mu", "log_std", "value"), runner.ts.actor_critic, obs),
                                (("cv_value",), runner.ts.central_value, states)):
            f32 = copy.deepcopy(tower)
            f32.dtype = torch.float32
            ours, theirs = tower(x), f32(x)
            if torch.is_tensor(ours):
                ours, theirs = (ours,), (theirs,)
            for name, a, b in zip(names, ours, theirs):
                check(a.dtype == torch.float32, f"bf16 {name} is not float32")
                out[name] = float((a - b).abs().max() / b.abs().max())
    return out


def phase_bf16(dev, f32_split: dict, num_envs: int = 8192, epochs: int = BF16_EPOCHS):
    """Phase 5's preset with bfloat16 networks through Runner.train."""
    cfg = d1_config(num_envs, mixed_precision=True)
    marks, history = [], []
    with tempfile.TemporaryDirectory() as logdir:
        runner = Runner(copy.deepcopy(cfg["gym"]), cfg["rlg"]["params"], logdir=logdir,
                        seed=SEED, device=dev)
        pcfg, st = runner.ppo_cfg, runner.static
        check_d1_widths("phase 8", runner)
        runner._train_iter = marked_train_iter(history, marks)

        # this slice's main path, counted
        cuda_engine.launch_count = 0
        runner.reset()
        check(pcfg.network_dtype == "bfloat16" and runner.ts.actor_critic.dtype == torch.bfloat16
              and runner.ts.central_value.dtype == torch.bfloat16, "phase 8 towers are not bf16")
        start = {k: v.clone() for k, v in runner._ckpt_payload()["ac_state_dict"].items()}
        t0 = time.perf_counter()
        runner.train(max_epochs=epochs)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = cuda_engine.launch_count
        h, n = pcfg.horizon, st.num_envs
        check(launches == 1 + h * epochs, f"bf16 launch_count {launches} != {1 + h * epochs}")
        check_epoch_metrics("bf16", history, epochs, h, n)
        trained = runner._ckpt_payload()
        check(all(v.dtype == torch.float32 for v in trained["ac_state_dict"].values()),
              "bf16 parameters are not float32")
        check(any(not torch.equal(start[k], v) for k, v in trained["ac_state_dict"].items()),
              "bf16: the parameters did not move")
        fresh = Runner(copy.deepcopy(cfg["gym"]), cfg["rlg"]["params"], logdir=logdir,
                       seed=SEED + 1, device=dev)
        fresh.restore(os.path.join(runner.nn_dir, "final"))
        restored = fresh._ckpt_payload()
        same = all(torch.equal(restored[part][k], v) for part in ("ac_state_dict", "cv_state_dict")
                   for k, v in trained[part].items())
        check(same and restored["epoch"] == epochs, "bf16 final checkpoint did not restore exactly")
        rel = bf16_vs_f32(runner)
        ok = max(rel.values()) <= BF16_REL
        print(f"bf16 epochs={epochs} launches={launches} wall_s={wall_s:.3f} "
              f"restore_bit_identical={same} bf16_vs_f32 " + " ".join(
                  f"{k}={v:.3e}" for k, v in rel.items()) + f" bound={BF16_REL} within_tol={ok}",
              flush=True)
        check(ok, "bf16 towers vs their float32 forward")
        for w in (runner, fresh):
            if w.writer is not None:
                w.writer.close()
    split = print_epoch_split("bf16", marks, epochs, h, n)
    print(f"{smi()} bf16_vs_f32 " + " ".join(
        f"{k}_ms bf16={split[k]:.3f} f32={f32_split[k]:.3f} ratio={split[k] / f32_split[k]:.3f}"
        for k in split), flush=True)
    return {"launches": launches}


# ---------------------------------------------------------------------------
# phase 9
# ---------------------------------------------------------------------------

# A finite but degenerate state: the cube flung at 1e30 m/s along each axis.
# The first substep moves it to ~5e27 m; the next one's contact queries
# square that past float32's range, so the plain step goes non-finite at
# substep 1 (measured on the CPU: the same for 1e25 to 1e37).
DEGENERATE_LINVEL = 1e30
NAN_ENV = 4321
NAN_KEYS = ("obs_fin", "obs_max", "states_fin", "states_max", "act_fin", "act_max", "rew_fin",
            "rew_max", "val_fin", "val_max", "neglogp_max", "logstd_min", "logstd_max",
            "envstate_fin", "adv_fin", "adv_max", "ret_max", "grad_fin", "grad_max",
            "kl_mb_fin", "kl_first_bad", "params_fin")


def phase_nan(dev, num_envs: int = 8192):
    """Phase 5's preset with nan_telemetry; the injected blow-up, the halt,
    the dump, the replay and the microscope on the card."""
    cfg = d1_config(num_envs, nan_telemetry=True)
    history, snapshot = [], {}
    with tempfile.TemporaryDirectory() as logdir:
        runner = Runner(copy.deepcopy(cfg["gym"]), cfg["rlg"]["params"], logdir=logdir,
                        seed=SEED, device=dev)
        check_d1_widths("phase 9", runner)
        check(runner.ppo_cfg.host_pipeline_depth > 1, "phase 9 should configure depth > 1")

        def train_iter(pcfg, static, env_params, ts):
            metrics = ppo.train_iteration(pcfg, static, env_params, ts)
            history.append(metrics)
            if ts.epoch == 2:
                snapshot["ac"] = {k: v.clone() for k, v in ts.actor_critic.state_dict().items()}
                ts.carry.env_state.physics.cube_linvel[NAN_ENV] = DEGENERATE_LINVEL
            return metrics

        runner._train_iter = train_iter
        cuda_engine.launch_count = 0
        runner.reset()
        runner.train(max_epochs=6)
        torch.cuda.synchronize()
        train_launches = cuda_engine.launch_count
        h = runner.ppo_cfg.horizon
        check(len(history) == 3, f"nan: {len(history)} epochs dispatched, not 3 (depth 1, "
              "halt at epoch 3)")
        check(train_launches == 1 + 3 * h, f"nan launch_count {train_launches} != {1 + 3 * h}")
        for e, m in enumerate(history[:2], 1):
            row = {k: float(m.get("nan/" + k, float("nan"))) for k in NAN_KEYS}
            ok = (all("nan/" + k in m for k in NAN_KEYS)
                  and all(v == 1.0 for k, v in row.items() if k.endswith("_fin"))
                  and row["kl_first_bad"] == -1.0)
            print(f"nan epoch={e} " + " ".join(f"{k}={v:.4g}" for k, v in row.items())
                  + f" clean={ok}", flush=True)
            check(ok, f"nan telemetry of clean epoch {e}")
        bad = {k: float(v) for k, v in history[2].items() if k.startswith("nan/")}
        print("nan epoch=3 " + " ".join(f"{k[4:]}={v:.4g}" for k, v in bad.items()), flush=True)
        halt = torch.load(os.path.join(runner.nn_dir, "nan_halt"), weights_only=True)
        check(halt["epoch"] == 3, f"nan_halt holds epoch {halt['epoch']}, not 3")
        dump = torch.load(os.path.join(runner.logdir, nan_replay.DUMP), weights_only=True)
        check(dump["epoch"] == 2 and all(torch.equal(dump["ac_state_dict"][k], v.cpu())
                                         for k, v in snapshot["ac"].items()),
              "nan_prev_ts.pt does not hold epoch 2's state")

        # the tools on the card; the microscope's walk launches the kernel
        cuda_engine.launch_count = 0
        npz = os.path.join(logdir, "nan_microscope.npz")
        found = nan_replay.replay(runner.logdir, steps=4, out=npz, device=dev)
        check(found is not None and found["step"] == 0 and found["env_index"] == NAN_ENV,
              f"nan_replay found {found}, not step 0 env {NAN_ENV}")
        seen = nan_microscope.microscope(npz, runner.logdir, device=dev) if found else None
        first = (seen or {}).get("first_bad_substep", {})
        fields = (seen or {}).get("nonfinite_at_first_bad", {})
        tools_launches = cuda_engine.launch_count
        same_substep = (seen is not None and first.get("kernel") is not None
                        and first.get("kernel") == first.get("plain"))
        same_fields = same_substep and fields.get("kernel") == fields.get("plain")
        print(f"nan halt_epoch={halt['epoch']} dump_epoch={dump['epoch']} replay={found} "
              f"microscope_first_bad_substep={first} nonfinite_fields={fields} "
              f"tools_launches={tools_launches} same_substep={same_substep} "
              f"same_fields={same_fields}", flush=True)
        check(same_fields, "nan microscope: the kernel and the plain version differ on the "
              "blow-up (substep or fields)")
        if runner.writer is not None:
            runner.writer.close()
    return {"launches": train_launches + tools_launches}


# ---------------------------------------------------------------------------
# phase 10
# ---------------------------------------------------------------------------

BENCH_COUNTS = (1024, 4096, 8192, 16384)
BENCH_LEN = 100
# the keys of the YAML of the repo's scripts/benchmark.py (its payload)
BENCH_KEYS = ["bench_len", "device", "env_steps_per_sec", "substeps"]
CHAIN_ENVS, CHAIN_CHECK, CHAIN_STEPS = 8192, 64, 5
ROBOTS = os.path.join(ROOT, "resources", "assets", "robots")
# Chain variants, float32 on the card against float64 on the CPU, max abs
# after CHAIN_STEPS steps: KERNEL_TOL's joint bounds. Float32 against
# float64 on the CPU measured ~1e-6 in both over 5 steps at the robots'
# torque range (0.4 N m), so the bound leaves ~100x for the card's own
# rounding (cuBLAS 3x3 products, another summation order).
CHAIN_TOL = {"q": 1e-4, "qd": 1e-3}


def phase_tools(dev):
    """The tools path; returns the kernel launches of its counted runs."""
    with tempfile.TemporaryDirectory() as tmp:
        launches = tools_trajectory_parity(dev, tmp) + tools_benchmark(dev, tmp)
    launches += tools_random_action(dev)
    tools_chain_variants(dev)
    return {"launches": launches}


def tools_trajectory_parity(dev, tmp):
    ap = trajectory_parity.parser()
    card_args = ap.parse_args(["dump", "--out", os.path.join(tmp, "card.npz")])
    cpu_args = ap.parse_args(["dump", "--device", "cpu", "--out", os.path.join(tmp, "cpu.npz")])
    n, steps = card_args.num_envs, card_args.steps
    static = trajectory_parity.make_env(cpu_args).static
    gen = torch.Generator().manual_seed(SEED)
    draws = (tenv.draw_init_randoms(static, gen, n, "cpu"),
             [tenv.draw_step_randoms(static, gen, n, "cpu") for _ in range(steps)])
    actions = [torch.rand((n, static.action_dim), generator=gen) * 2.0 - 1.0
               for _ in range(steps)]
    cuda_engine.launch_count = 0
    t = time.perf_counter()
    meta = trajectory_parity.dump(card_args, actions, draws)
    torch.cuda.synchronize()
    card_s, launches = time.perf_counter() - t, cuda_engine.launch_count
    check(launches == 1 + steps, f"trajectory dump launch_count {launches} != {1 + steps}")
    check(meta["device"] == torch.cuda.get_device_name(0), f"dump meta device {meta}")
    t = time.perf_counter()
    trajectory_parity.dump(cpu_args, actions, draws)
    cpu_s = time.perf_counter() - t

    # gate: each recorded card state stepped once by the plain version lands
    # on the next recorded one (the action of the next step, as phase 3)
    d = np.load(card_args.out, allow_pickle=True)
    env = trajectory_parity.make_env(card_args)
    st, prm = env.static, env.params
    t_ = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    fields = ("q", "qd", "cube_pos", "cube_quat", "cube_linvel", "cube_angvel")
    flat = lambda k, a, b: t_(d[k][a:b].reshape((b - a) * n, -1))  # noqa: E731
    prev = PhysicsState(*(flat(k, 0, steps - 1) for k in fields))
    nxt = PhysicsState(*(flat(k, 1, steps) for k in fields))
    m = prev.q.shape[0]
    tau = tenv.compute_torque(st, prm, flat("action", 1, steps), prev.q, prev.qd)
    packed = (pack_state(prev), pack_params(prm.scene_base.broadcast(m), m),
              tau.T.contiguous())
    kernel_vs_plain(f"trajectory_parity recorded_steps={steps - 1} envs={n}", packed,
                    st.solver, st.dt, referee=True, result=(pack_state(nxt), None))

    # the free run against the CPU's, ungated
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = trajectory_parity.compare(argparse.Namespace(
            file_a=card_args.out, file_b=cpu_args.out, tol=2e-4))
    verdict = [line for line in buf.getvalue().splitlines() if line.startswith("verdict")]
    worst = {line.split(":")[0]: line.split()[2] for line in buf.getvalue().splitlines()
             if line.split(":")[0] in ("q", "cube_pos", "cube_quat", "cube_angvel")}
    print(f"{smi()} trajectory_parity envs={n} steps={steps} launches={launches} "
          f"card_dump_s={card_s:.2f} cpu_plain_dump_s={cpu_s:.2f} compare_rc={rc} "
          f"{verdict[0] if verdict else 'verdict: none'} worst_by_field={worst}", flush=True)
    return launches


def tools_benchmark(dev, tmp):
    counts = {}
    run = benchmark.bench_one

    def counted(n, *args, **kw):  # launches of each env count of the sweep
        before = cuda_engine.launch_count
        sps = run(n, *args, **kw)
        counts[n] = cuda_engine.launch_count - before
        return sps

    path = os.path.join(tmp, "bench.yaml")
    cuda_engine.launch_count = 0
    benchmark.bench_one = counted
    try:
        payload = benchmark.main(["--num_envs_sweep", *map(str, BENCH_COUNTS), "--bench_len",
                                  str(BENCH_LEN), "--substeps", "2", "--bench_file", path])
    finally:
        benchmark.bench_one = run
    torch.cuda.synchronize()
    launches = cuda_engine.launch_count
    with open(path) as f:
        written = yaml.safe_load(f)
    check(sorted(written) == BENCH_KEYS and written == payload,
          f"benchmark YAML keys {sorted(written)} != {BENCH_KEYS}")
    check(written["device"] == torch.cuda.get_device_name(0), f"benchmark device {written}")
    check(all(counts.get(n) == 1 + 2 * BENCH_LEN for n in BENCH_COUNTS),
          f"benchmark launches per count {counts} != {1 + 2 * BENCH_LEN}")
    print(f"{smi()} benchmark substeps=2 bench_len={BENCH_LEN} launches_per_count={counts} "
          + " ".join(f"env_steps_per_s_{n}={v}" for n, v in
                     written["env_steps_per_sec"].items()), flush=True)
    return launches


def tools_random_action(dev, num_envs: int = 8192):
    cuda_engine.launch_count = 0
    env = trifinger_random_action.make_env(num_envs, device=dev, verbose=False)
    gen = torch.Generator(device=dev).manual_seed(1)
    sps = trifinger_random_action.chunk(env, gen)
    launches = cuda_engine.launch_count
    chunk = trifinger_random_action.CHUNK
    check(launches == 1 + chunk, f"random action launch_count {launches} != {1 + chunk}")
    check(bool(torch.isfinite(env.state.physics.q).all()), "random action state not finite")
    print(f"{smi()} random_action envs={num_envs} chunk={chunk} launches={launches} "
          f"env_steps_per_s={sps:.1f}", flush=True)
    return launches


def tools_chain_variants(dev):
    for rel in sorted(os.listdir(ROBOTS)):
        chain = chain_from_urdf(os.path.join(ROBOTS, rel))
        f = chain.num_fingers
        rng = np.random.default_rng(SEED)
        lo, hi = np.tile(chain.joint_lower, f), np.tile(chain.joint_upper, f)
        q0 = rng.uniform(lo, hi, (CHAIN_ENVS, 3 * f))
        qd0 = rng.uniform(-3.0, 3.0, (CHAIN_ENVS, 3 * f))
        tau = rng.uniform(-0.4, 0.4, (CHAIN_STEPS, CHAIN_ENVS, 3 * f))
        kw = dict(joint_damping=0.05, armature=0.003)
        out = {}
        for who, device, dtype, envs in (("card", dev, torch.float32, CHAIN_ENVS),
                                         ("cpu", "cpu", torch.float64, CHAIN_CHECK)):
            t = lambda x: torch.as_tensor(x[..., :envs, :], device=device, dtype=dtype)  # noqa: E731,B023
            state = generic_chain.ChainState(t(q0), t(qd0))
            for k in range(CHAIN_STEPS):
                state = generic_chain.chain_physics_step(state, t(tau[k]), chain, **kw)
            out[who] = state
        step = lambda: generic_chain.chain_physics_step(  # noqa: E731
            out["card"], torch.as_tensor(tau[0], device=dev, dtype=torch.float32), chain, **kw)
        ms = cuda_ms(step, 5)
        err = {k: float((getattr(out["card"], k)[:CHAIN_CHECK].double().cpu()
                         - getattr(out["cpu"], k)).abs().max()) for k in CHAIN_TOL}
        ok = all(err[k] <= CHAIN_TOL[k] for k in err)
        ok &= all(bool(torch.isfinite(x).all()) for x in out["card"])
        print(f"{smi()} chain {rel} fingers={f} envs={CHAIN_ENVS} steps={CHAIN_STEPS} "
              f"ms_per_step={ms:.3f} card_f32_vs_cpu_f64_first_{CHAIN_CHECK} "
              + " ".join(f"{k}={v:.3e}" for k, v in err.items()) + f" within_tol={ok}",
              flush=True)
        check(ok, f"chain variant {rel}: card float32 vs CPU float64")


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
    info, occ = cuda_engine.build_info, cuda_engine.occupancy()
    print(f"build {os.path.relpath(info['library'], ROOT)} seconds={time.perf_counter() - t0:.2f} "
          f"registers={info.get('registers')} stack_frame_bytes={info.get('stack_frame_bytes')} "
          f"spill_store_bytes={info.get('spill_store_bytes')} "
          f"spill_load_bytes={info.get('spill_load_bytes')} "
          f"static_smem_bytes={info.get('static_smem_bytes')} "
          f"dynamic_smem_bytes_per_block={occ['dynamic_smem_bytes']} "
          f"envs_per_block={occ['envs_per_block']} "
          f"resident_blocks_per_sm={occ['blocks_per_sm']}", flush=True)
    # every env of the 8192 of the main path resident at once
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = -(-8192 // occ["envs_per_block"])
    check(occ["blocks_per_sm"] * sms >= blocks,
          f"8192 envs need {blocks} blocks, {occ['blocks_per_sm']} x {sms} resident")

    def timed(name, phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        print(f"{name} seconds={time.perf_counter() - t:.1f} "
              f"since_start={time.perf_counter() - t0:.1f}", flush=True)
        return out

    timed("phase 2", phase_kernel_vs_plain, dev)
    timed("phase 3", phase_golden, dev)
    records = {"slice": timed("phase 4", phase_slice, dev),
               "train": timed("phase 5", phase_training, dev),
               "d4": timed("phase 6", phase_d4, dev)}
    timed("phase 7", phase_replay, dev)
    bf16 = timed("phase 8", phase_bf16, dev, records["train"].pop("split"))
    nan = timed("phase 9", phase_nan, dev)
    tools = timed("phase 10", phase_tools, dev)

    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
        return 1
    print(smi(), flush=True)
    # phase 6 gives the times and the bound; the launches are every counted
    # path's (phases 4-6 and 8-10); the error is the worst of phases 4-6
    paths = {"phase 4": records["slice"]["launches"], "phase 5": records["train"]["launches"],
             "phase 6": records["d4"]["launches"], "phase 8": bf16["launches"],
             "phase 9": nan["launches"], "phase 10": tools["launches"]}
    print("launches " + " ".join(f"{k.replace(' ', '_')}={v}" for k, v in paths.items()),
          flush=True)
    record = dict(records["d4"], launches=sum(paths.values()),
                  max_abs_err=max(r["max_abs_err"] for r in records.values()))
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
