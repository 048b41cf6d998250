"""What decides ``correct`` in a training cell: the program's epochs, driven
through ``Runner.train`` as the window drives it, held to the plain
reference (``perfbench/reference``).

The benchmark makes every input: the starting weights (``weights.py``), and
for each compared epoch the action noise and the env draws (and for the
checked epochs the minibatch permutations), which it hands to the program's
epoch as the epoch function takes them. The first reset is the program's
own, from the seed the Runner gets; the reference draws the same numbers
from the same seed.

Three stages, each judged by itself (the reference cannot follow 8192 envs
through the plain physics in the time of a run: ~2 s an env step on the
card):

- The first rollout, from the reset, on a sample of rows drawn from the
  seed: the reference resets those envs from the reset's draws and steps
  them through the first epoch's first ``rollout_check_steps`` steps (22 of
  its 32: the reference's time in a run stays under the window's) on the
  CPU in float64, from the same weights and draws. The first epoch runs the epoch's bodies eagerly
  (the warm-up before the capture).
- The replayed rollout of the window epoch in which the episodes end (the
  first epoch of the window that holds a time-out: at 750-step episodes
  and 32-step epochs, epoch 23, whose step 14 resets every env and, at D4
  + DR, redraws its scene): at the epoch's start the benchmark copies the
  sampled rows' env state, carry and curriculum level and the networks'
  weights on the device, and at its rollout's end the rows of the
  trajectory; the reference steps the rows from that state through the
  epoch's first ``rollout_check_steps`` steps on the CPU in float64, with
  the same draws. The epoch is a replay
  of the CUDA graphs the window replays.
- The update of each checked epoch (the first three, in set-up: the first
  eager, the others replays), from the program's own state at the epoch's
  start (the benchmark's starting weights and a fresh optimizer before the
  first; after it, the program's parameters, Adam state and learning rate
  as the previous epoch left them), on the program's trajectory and the
  benchmark's noise and permutations: the reference recomputes the old
  policy, the values and the actions, GAE and the advantage normalisation,
  then every actor-critic and central-value step of the epoch (loss,
  gradients, clip, Adam, adaptive learning rate) in float64 on the card.
  The first ``EARLY_STEPS`` steps' critic losses, KLs and central-value
  losses are compared step by step, and the parameters' change over the
  whole epoch leaf by leaf.

Rollouts are judged per row, by each row's widest gap over the steps and
components, and the number compared is a high quantile (``ROW_QUANTILE``)
of those over the rows: contacts make a few rows part by their nature,
whichever side rounds; a fault in more than a tenth of the rows shows.
Whether a row's dones differ anywhere is counted apart.

Why the early steps' losses, and each epoch from the program's state: the
PPO update at these sizes amplifies rounding (two float32 runs that differ
in the order of one sum part by 1e-4 at the end of an epoch and by 10-70%
in the third). The adaptive learning rate therefore follows the program's
KL, so that both sides step at the same rate.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Dict, List, Optional

import torch

from perfbench.reference import env as renv
from perfbench.reference import networks as rnets
from perfbench.reference import ppo as rppo
from perfbench.reference.task import make_task
from perfbench import weights

TRAJ_FIELDS = ("obs", "states", "action", "reward", "done")
ROLLOUT_FIELDS = ("obs", "action", "reward", "done")
EARLY_STEPS = 3
ROW_QUANTILE = 0.9
GRAD_FLOOR = 1e-3  # leaves under this share of the median leaf's gradient are left out
ROLLOUT_TIMEOUT_S = 240  # a worker that dies leaves its rollout pending: fail, not hang


def host(x: torch.Tensor) -> torch.Tensor:
    """A copy on the host (``.cpu()`` of a CPU tensor is the tensor itself,
    which the program then changes in place)."""
    return x.detach().to("cpu", copy=True)


def rows_of(x, rows: torch.Tensor):
    """The ``rows`` of every leaf of a draws tree (tuples of (n, ...)
    tensors and Nones)."""
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return tuple(rows_of(v, rows) for v in x)
    return x.index_select(0, rows.to(x.device))


def to(x, device, dtype=None):
    """A draws tree on ``device`` (floating leaves in ``dtype`` when given)."""
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return tuple(to(v, device, dtype) for v in x)
    if dtype is not None and x.is_floating_point():
        return x.to(device=device, dtype=dtype)
    return x.to(device)


def state_rows(state, rows: torch.Tensor, n: int) -> Dict[str, torch.Tensor]:
    """The ``rows`` of every tensor of an env state, under the flat names of
    the reference's ``env_state_tensors`` (``physics_q``, ``goal_pose_cm``):
    component-major ``*_cm`` fields along their last axis, the others along
    their first; a tensor without an env axis is copied whole."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        leaves = ({f"{f.name}_{g.name}": getattr(v, g.name) for g in dataclasses.fields(v)}
                  if dataclasses.is_dataclass(v) else {f.name: v})
        for name, x in leaves.items():
            axis = x.dim() - 1 if name.endswith("_cm") else 0
            if x.dim() and x.shape[axis] == n:
                out[name] = x.index_select(axis, rows)
            else:
                out[name] = x.detach().clone()
    return out


def reference_networks(cfg: rppo.PPOConfig, static, dtype, device):
    """The reference's actor-critic and central value (None without one) in
    ``dtype`` on ``device``, weights not yet set."""
    ac, cv = rppo.make_networks(cfg, static, "cpu", torch.Generator().manual_seed(0))
    ac = ac.to(device=device, dtype=dtype)
    cv = cv.to(device=device, dtype=dtype) if cv is not None else None
    return ac, cv


def first_timeout_epoch(config: dict, horizon: int, start: int) -> int:
    """The first epoch from ``start`` on whose steps hold an episode's
    time-out (episodes start together at the reset, and a time-out ends
    step ``k * episode_length - 1``); ``start`` without time-outs."""
    length = int(config["gym"].get("episode_length") or 0)
    if length <= 0:
        return start
    k = 1
    while (k * length - 1) // horizon < start:
        k += 1
    return (k * length - 1) // horizon


class Recorder:
    """Set-up side of the check: makes the inputs of the compared epochs
    and keeps, on the host, what the program produced in them."""

    def __init__(self, config: dict, num_envs: int, seed: int, device, epochs: int,
                 rows: int, steps: int, window_start: int):
        self.config, self.n, self.seed, self.device = config, num_envs, seed, device
        agent = copy.deepcopy(config["rlg_params"])
        self.cfg = rppo.PPOConfig.from_rlg_params(agent, num_envs)
        self.static, _ = make_task(config["gym"], device, torch.float32, num_envs=num_envs)
        self.gen = torch.Generator(device=device).manual_seed(seed ^ 0x5DEECE66D)
        pick = torch.Generator().manual_seed(seed)
        self.rows = torch.sort(torch.randperm(num_envs, generator=pick)[:rows]).values
        self.steps = min(steps, self.cfg.horizon)
        self._rows_dev = self.rows.to(device)
        self.epochs_to_check = epochs
        self.replay_epoch = first_timeout_epoch(config, self.cfg.horizon, window_start)
        self.epochs: List[dict] = []
        self.replay: Optional[dict] = None
        ac, cv = reference_networks(self.cfg, self.static, torch.float32, "cpu")
        wgen = torch.Generator(device=device).manual_seed(seed ^ 0x2545F491)
        self.init = {"ac": weights.initial_state_dict(ac, wgen, device),
                     "cv": weights.initial_state_dict(cv, wgen, device) if cv is not None else None}
        self._traj = None

    @property
    def done(self) -> bool:
        return len(self.epochs) >= self.epochs_to_check

    def load_weights(self, ts) -> None:
        """The benchmark's starting weights into the program's learner."""
        ts.actor_critic.load_state_dict(self.init["ac"])
        if ts.central_value is not None:
            ts.central_value.load_state_dict(self.init["cv"])

    def _rollout_draws(self):
        st, n, h = self.static, self.n, self.cfg.horizon
        noise = torch.randn((h, n, st.action_dim), generator=self.gen, device=self.device)
        env_draws = [renv.draw_step_randoms(st, self.gen, n, self.device, torch.float32)
                     for _ in range(h)]
        return noise, env_draws

    def draws(self) -> dict:
        """The next checked epoch's action noise, env draws and permutations,
        in the epoch function's keyword layout."""
        cfg, st, n, h = self.cfg, self.static, self.n, self.cfg.horizon
        noise, env_draws = self._rollout_draws()
        perms = rppo.draw_permutations(cfg, h, n, cfg.central_value and st.asymmetric_obs,
                                       self.gen, self.device)
        rec = {"noise": host(noise), "perms": [host(p) for p in perms]}
        if not self.epochs:
            rec["env_draws_rows"] = [to(rows_of(d, self.rows), "cpu") for d in env_draws]
        self._pending = rec
        return {"noise": noise, "env_draws": env_draws, "perms": perms}

    def on_rollout(self, traj) -> None:
        """The program's trajectory of the running epoch (its buffers are
        read after the epoch)."""
        self._traj = traj

    def after(self, ts, epoch_fn) -> None:
        """Copy what the checked epoch produced to the host: its trajectory,
        the carry it handed on, each minibatch step's loss terms (the epoch
        object's step buffers), and the learner's state after it."""
        rec = self._pending
        rec.update({k: host(getattr(self._traj, k)) for k in TRAJ_FIELDS})
        terms = host(epoch_fn.ac_terms)
        rec["steps"] = {"c_loss": terms[2], "kl": terms[4],
                        "cv_loss": (host(epoch_fn.cv_losses) if ts.central_value is not None
                                    else None)}
        rec["last_obs"] = host(ts.carry.obs)
        rec["last_states"] = host(ts.carry.states)
        nets = [("ac", ts.actor_critic, ts.ac_opt)]
        if ts.central_value is not None:
            nets.append(("cv", ts.central_value, ts.cv_opt))
        # the state the next epoch starts from
        rec["end_state"] = {
            "params": {tag: {k: host(v) for k, v in net.state_dict().items()}
                       for tag, net, _ in nets},
            "opt": {tag: {"count": host(opt.count), "mu": [host(m) for m in opt.mu],
                          "nu": [host(v) for v in opt.nu]} for tag, _, opt in nets},
            "lr": host(ts.lr)}
        self.epochs.append(rec)
        self._traj = None

    # the window's replayed epoch: copies on the device, no host read inside
    # the window

    def replay_start(self, ts, env_params) -> dict:
        """At the replayed epoch's start: the sampled rows' env state and
        carry, the curriculum level and the networks' weights, copied on the
        device; returns the epoch's noise and env draws for the program."""
        rows, carry = self._rows_dev, ts.carry
        noise, env_draws = self._rollout_draws()
        self.replay = {
            "env": state_rows(carry.env_state, rows, self.n),
            "carry": {k: getattr(carry, k).index_select(0, rows)
                      for k in ("obs", "states", "ep_return", "ep_len")},
            "level": env_params.curriculum_level.detach().clone(),
            "params": {"ac": {k: v.detach().clone()
                              for k, v in ts.actor_critic.state_dict().items()},
                       "cv": ({k: v.detach().clone()
                               for k, v in ts.central_value.state_dict().items()}
                              if ts.central_value is not None else None)},
            "noise": noise.index_select(1, rows),
            "env_draws": [rows_of(d, rows) for d in env_draws],
        }
        return {"noise": noise, "env_draws": env_draws}

    def replay_rollout(self, traj) -> None:
        """At the replayed epoch's rollout end: the rows of its trajectory."""
        self.replay["traj"] = {k: getattr(traj, k).index_select(1, self._rows_dev)
                               for k in ROLLOUT_FIELDS}

    def replay_to_host(self) -> None:
        """After the window: the replayed epoch's copies onto the host."""
        def move(x):
            if isinstance(x, dict):
                return {k: move(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(move(v) for v in x)
            return None if x is None else host(x)

        self.replay = move(self.replay)


# ---------------------------------------------------------------------------
# The reference's side
# ---------------------------------------------------------------------------


def _reference_rollout(inputs: dict) -> Dict[str, torch.Tensor]:
    """The rollout of the sampled rows by the reference, in float64 on the
    CPU, from ``inputs`` (``rollout_inputs`` or ``replay_inputs``): (h,
    rows, ...) observations, actions, shaped rewards and dones."""
    dtype, device = torch.float64, "cpu"
    m = len(inputs["rows"])
    cfg = dataclasses.replace(inputs["cfg"], horizon=inputs["steps"])
    static, env_params = make_task(inputs["gym"], device, dtype, num_envs=m,
                                   num_envs_global=inputs["n"])
    if "reset" in inputs:
        env_state, obs = renv.env_reset(static, env_params, *to(inputs["reset"], device, dtype))
        carry = rppo.RolloutCarry.start(env_state, obs, static.state_dim, cfg)
    else:
        env_params = dataclasses.replace(
            env_params, curriculum_level=inputs["level"].to(device=device, dtype=dtype))
        env_state = renv.env_state_from_tensors(
            {k: to(v, device, dtype) for k, v in inputs["env"].items()})
        carry = rppo.RolloutCarry(env_state, **{k: to(v, device, dtype)
                                                for k, v in inputs["carry"].items()})
    ac, cv = reference_networks(cfg, static, dtype, device)
    ac.load_state_dict(inputs["params"]["ac"])
    if cv is not None:
        cv.load_state_dict(inputs["params"]["cv"])
    with torch.no_grad():
        _, traj = rppo.rollout(cfg, static, env_params, carry, ac, cv,
                               noise=inputs["noise"][:cfg.horizon].to(dtype),
                               env_draws=[to(d, device, dtype)
                                          for d in inputs["draws"][:cfg.horizon]])
    return {k: getattr(traj, k) for k in ROLLOUT_FIELDS}


def _host_tree(x):
    if isinstance(x, dict):
        return {k: _host_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host_tree(v) for v in x)
    return host(x) if torch.is_tensor(x) else x


def rollout_inputs(rec: Recorder) -> dict:
    """What the reference needs to follow the first rollout's rows from the
    reset, on the host: the reset's draws of those rows (the program's
    reset draws them from the seed on the device, and so does this), the
    starting weights and the epoch's draws."""
    full_static, _ = make_task(rec.config["gym"], rec.device, torch.float32, num_envs=rec.n)
    gen = torch.Generator(device=rec.device).manual_seed(rec.seed)
    init = renv.draw_init_randoms(full_static, gen, rec.n, rec.device, torch.float32)
    first = rec.epochs[0]
    return _host_tree({"gym": rec.config["gym"], "n": rec.n, "rows": rec.rows, "cfg": rec.cfg,
                       "steps": rec.steps, "reset": rows_of(init, rec.rows), "params": rec.init,
                       "noise": first["noise"].index_select(1, rec.rows),
                       "draws": first["env_draws_rows"]})


def replay_inputs(rec: Recorder) -> dict:
    """What the reference needs to follow the replayed epoch's rows: the
    copies taken at its start."""
    snap = rec.replay
    return {"gym": rec.config["gym"], "n": rec.n, "rows": rec.rows, "cfg": rec.cfg,
            "steps": rec.steps, "draws": snap["env_draws"],
            **{k: snap[k] for k in ("env", "carry", "level", "params", "noise")}}


def _rollout_job(inputs: dict):
    """A worker process's rollout: float64 on the CPU, one thread; with the
    seconds it took."""
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    return _reference_rollout(inputs), time.perf_counter() - t0


def reference_side(rec: Recorder, update_device) -> dict:
    """The reference's outputs in the layout ``numbers`` takes, and the
    seconds its parts took (``seconds``): both rollouts in float64 on the
    CPU, each in a process of its own (the plain physics takes ~0.7-1.3 s a
    step there, most of it the host's per-operation cost), while this
    process runs the update on the card."""
    import multiprocessing

    jobs = [rollout_inputs(rec), replay_inputs(rec)]
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(len(jobs)) as pool:
        pending = pool.map_async(_rollout_job, jobs)
        update = reference_update(rec, device=update_device)
        t_update = time.perf_counter() - t0
        results = pending.get(timeout=ROLLOUT_TIMEOUT_S)
        pool.close()
        pool.join()
    stages = ("rollout", "replay")
    seconds = {f"{k}_s": s for k, (_, s) in zip(stages, results)}
    seconds.update(update_s=t_update, all_s=time.perf_counter() - t0)
    return dict({k: r for k, (r, _) in zip(stages, results)}, update=update, seconds=seconds)


def _half(x: torch.Tensor, n: int) -> torch.Tensor:
    """The first half of a minibatch's envs (the fault that leaves half of
    the batch out)."""
    if x.dim() >= 2 and x.shape[1] == n:
        return x.narrow(1, 0, n // 2)
    return x.narrow(0, 0, x.shape[0] // 2)


def _recording(opt: rppo.ClippedAdam, into: dict):
    """``opt.step`` that also keeps each leaf's gradient norm of the step it
    takes first (into ``into``, by name)."""
    step = opt.step

    def recording(grads, lr, want_norm=False):
        if not into:
            into.update({k: float(torch.linalg.vector_norm(g))
                         for k, g in zip(opt.names, grads)})
        return step(grads, lr, want_norm)

    return recording


def reference_update(rec: Recorder, dtype=torch.float64, device="cuda", tf32: bool = False,
                     half_batch: bool = False, frozen_after: Optional[int] = None) -> dict:
    """Each checked epoch's actor-critic and central-value steps by the
    reference, from the program's state at the epoch's start, on the
    program's trajectory: the first ``EARLY_STEPS`` steps' critic losses,
    KLs and central-value losses, the parameters after the epoch and each
    leaf's gradient norm at the epoch's first step, on the host.

    The adaptive learning rate follows the program's state: after each
    actor-critic step it adapts to the KL the program's step reported, not
    to the reference's own. The schedule is a step function of the KL (x1.5
    under half the threshold, /1.5 over twice it): a KL within rounding of
    either edge would otherwise send the two sides down different learning
    rates, and the KLs are compared step by step as a number of their own.

    ``half_batch`` and ``frozen_after`` plant faults, for the readings: each
    minibatch step on the first half of its envs, and steps from that index
    on that leave the parameters as they were (a learning rate of 0)."""
    cfg = rec.cfg
    ac, cv = reference_networks(cfg, rec.static, dtype, device)
    asym = cv is not None
    cv_frozen = dataclasses.replace(cfg, cv_learning_rate=0.0)
    h, n = cfg.horizon, rec.n
    cut = (lambda x: _half(x, n)) if half_batch else (lambda x: x)  # noqa: E731
    live = (lambda i: True) if frozen_after is None else (lambda i: i < frozen_after)  # noqa: E731
    out = {"steps": [], "params": [], "grad_norms": []}
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        for k, ep in enumerate(rec.epochs):
            ac_opt, cv_opt = rppo.make_optimizers(cfg, ac, cv)
            grads = {"ac": {}, "cv": {}}
            ac_opt.step = _recording(ac_opt, grads["ac"])
            if asym:
                cv_opt.step = _recording(cv_opt, grads["cv"])
            if k == 0:
                ac.load_state_dict(rec.init["ac"])
                if asym:
                    cv.load_state_dict(rec.init["cv"])
                lr = torch.tensor(cfg.learning_rate, dtype=dtype, device=device)
            else:
                start = rec.epochs[k - 1]["end_state"]
                for tag, net, opt in (("ac", ac, ac_opt), ("cv", cv, cv_opt)):
                    if net is None:
                        continue
                    net.load_state_dict(start["params"][tag])
                    with torch.no_grad():
                        for dst, src in zip(opt.mu + opt.nu,
                                            start["opt"][tag]["mu"] + start["opt"][tag]["nu"]):
                            dst.copy_(src)
                        opt.count.copy_(start["opt"][tag]["count"])
                lr = start["lr"].to(device=device, dtype=dtype)
            get = lambda name: ep[name].to(device=device, dtype=dtype)  # noqa: E731
            obs, states = get("obs"), get("states")
            with torch.no_grad():
                mu, log_std, value = rppo.policy_and_value(ac, cv, obs, states)
                _, _, last_value = rppo.policy_and_value(ac, cv, get("last_obs"),
                                                         get("last_states"))
            action = mu + torch.exp(log_std) * get("noise")
            traj = rppo.Trajectory(
                obs=obs, states=states, action=action, mu=mu, log_std=log_std,
                neglogp=rnets.gaussian_neglogp(mu, log_std, action), value=value,
                reward=get("reward"), done=get("done"), fin_ret=None, fin_n=None,
                fin_suc=None, info={})
            advs, returns = rppo.advantages(cfg, traj, last_value)
            perms = [p.to(device) for p in ep["perms"]]
            ac_idx, cv_idx = rppo.minibatch_indices(cfg, h, n, asym, perms)
            data, cv_data = rppo.minibatch_sources(cfg, traj, advs, returns, asym)
            kl_prog = ep["steps"]["kl"].to(device=device, dtype=dtype)
            c_losses, kls = [], []
            for step, idx in enumerate(ac_idx):
                mb = {key: cut(v.index_select(0, idx)) for key, v in data.items()}
                _, terms = rppo.actor_critic_step(cfg, ac, ac_opt, lr * float(live(step)), mb)
                if cfg.lr_schedule == "adaptive":
                    lr = rppo.adapt_lr(cfg, lr, kl_prog[step])
                if step < EARLY_STEPS:
                    c_losses.append(terms[2])
                    kls.append(terms[4])
            cv_losses = []
            if asym:
                s, r = cv_data
                for step, idx in enumerate(cv_idx):
                    loss = rppo.central_value_step(cfg if live(step) else cv_frozen, cv, cv_opt,
                                                   cut(s.index_select(0, idx)),
                                                   cut(r.index_select(0, idx)))
                    if step < EARLY_STEPS:
                        cv_losses.append(loss)
            out["steps"].append({
                "c_loss": host(torch.stack(c_losses)), "kl": host(torch.stack(kls)),
                "cv_loss": host(torch.stack(cv_losses)) if asym else None})
            out["params"].append({tag: {key: host(v) for key, v in net.state_dict().items()}
                                  for tag, net in (("ac", ac), ("cv", cv)) if net is not None})
            out["grad_norms"].append({tag: g for tag, g in grads.items() if g})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    return out


# ---------------------------------------------------------------------------
# The numbers compared
# ---------------------------------------------------------------------------


def _step_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap over steps between the program's and the reference's
    value, over the larger of the reference's and the median step's."""
    ref = ref.double()
    floor = torch.clamp(ref.abs(), min=max(float(ref.abs().median()), 1e-30))
    return float(((prog.double() - ref).abs() / floor).max())


def row_gaps(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each row's widest gap over steps and components; (h, rows, ...)
    inputs, (rows,) out."""
    gap = (prog.double() - ref.double()).abs().reshape(prog.shape[0], prog.shape[1], -1)
    return gap.amax(dim=(0, 2))


def rollout_gaps(prog: Dict[str, torch.Tensor],
                 ref: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each row's widest gap of observations, actions and shaped rewards
    (these over the reference's median |shaped reward|), and whether its
    dones differ (1) or not (0)."""
    r_ref = ref["reward"].double()
    r_scale = float(r_ref.abs().median()) or 1.0
    return {"obs": row_gaps(prog["obs"], ref["obs"]),
            "action": row_gaps(prog["action"], ref["action"]),
            "reward": row_gaps(prog["reward"], r_ref) / r_scale,
            "done": (prog["done"] != ref["done"]).any(0).double()}


def _quantile(x: torch.Tensor) -> float:
    return float(torch.quantile(x, ROW_QUANTILE))


def param_change_gaps(rec: Recorder, prog_params: List[dict], ref: dict) -> List[float]:
    """For each checked epoch and each leaf whose gradient at the epoch's
    first step reaches ``GRAD_FLOOR`` of its network's median leaf's (in the
    reference): the gap between the norms of the program's and the
    reference's change of the leaf over the epoch, over the larger of the
    reference's and its network's median leaf's."""
    gaps = []
    for k, (prog_end, ref_end) in enumerate(zip(prog_params, ref["params"])):
        start = rec.init if k == 0 else rec.epochs[k - 1]["end_state"]["params"]
        for tag, ref_leaves in ref_end.items():
            g = ref["grad_norms"][k][tag]
            g_med = float(torch.tensor(list(g.values())).median())
            kept = [name for name in ref_leaves if g.get(name, 0.0) >= GRAD_FLOOR * g_med]

            def change(end, name):
                return float(torch.linalg.vector_norm(
                    end[name].double() - start[tag][name].to("cpu").double()))

            d_ref = {name: change(ref_leaves, name) for name in kept}
            med = float(torch.tensor(list(d_ref.values())).median())
            gaps += [abs(change(prog_end[tag], name) - d_ref[name]) / max(d_ref[name], med, 1e-30)
                     for name in kept]
    return gaps


def numbers(rec: Recorder, prog: dict, ref: dict) -> Dict[str, float]:
    """Every number compared, by name. ``prog`` is the program's side
    (``program_side``), or a control's or a fault's in its place; ``ref``
    the reference's (``reference_side``)."""
    out = {}
    for stage in ("rollout", "replay"):
        gaps = rollout_gaps(prog[stage], ref[stage])
        for key in ("obs", "action", "reward"):
            out[f"{stage}_{key}_gap"] = _quantile(gaps[key])
        out[f"{stage}_done_rows"] = float(gaps["done"].mean())
    loss_gap = kl_gap = 0.0
    for ps, rs in zip(prog["update"]["steps"], ref["update"]["steps"]):
        for key in ("c_loss", "cv_loss"):
            if rs[key] is not None:
                loss_gap = max(loss_gap, _step_gap(ps[key][:EARLY_STEPS], rs[key]))
        # in nats: a KL of a step whose update was small is a difference of
        # terms of order 1, which float32 rounds to ~1e-7 nats
        kl_gap = max(kl_gap, float((ps["kl"][:EARLY_STEPS].double() - rs["kl"]).abs().max()))
    out["step_loss_gap"] = loss_gap
    out["kl_gap_nats"] = kl_gap
    out["param_change_gap"] = max(param_change_gaps(rec, prog["update"]["params"],
                                                    ref["update"]))
    return out


def program_side(rec: Recorder) -> dict:
    """The program's outputs in the layout ``numbers`` takes."""
    rows = rec.rows
    return {
        "rollout": {k: rec.epochs[0][k][:rec.steps].index_select(1, rows)
                    for k in ROLLOUT_FIELDS},
        "replay": {k: v[:rec.steps] for k, v in rec.replay["traj"].items()},
        "update": {"steps": [ep["steps"] for ep in rec.epochs],
                   "params": [ep["end_state"]["params"] for ep in rec.epochs]},
    }


def compare(rec: Recorder, update_device):
    """The numbers of a run, the program against the reference, and the
    seconds the reference's parts took."""
    ref = reference_side(rec, update_device)
    return numbers(rec, program_side(rec), ref), ref["seconds"]
