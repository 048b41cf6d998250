"""Rank functions that ``tests/test_torch_parallel*.py`` run through
``leibnizgym_tpu_torch.parallel.launch`` (one process per rank, gloo on
the CPU). They import torch and the port only; each returns tensors,
numbers and dicts, which come back to the test."""

from __future__ import annotations

import copy
import dataclasses
import os

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from leibnizgym_tpu_torch.config.presets import default_config, update_cfg
from leibnizgym_tpu_torch.envs.trifinger.env import TrifingerEnv, env_state_tensors
from leibnizgym_tpu_torch.learning import graphs, ppo

torch.set_num_threads(1)

TRAJ_KEYS = ("obs", "states", "action", "mu", "reward", "done", "value")

_RANDOM = {"rand", "randn", "randperm", "randint", "normal", "normal_", "uniform",
           "uniform_", "random_", "bernoulli", "bernoulli_", "multinomial", "exponential_"}


class CaptureGuard(TorchDispatchMode):
    """Fails on the operations a CUDA-graph capture cannot hold: a tensor
    made from host data (``lift_fresh``), a read back to the host
    (``_local_scalar_dense``) or a random draw."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in ("lift_fresh", "_local_scalar_dense") or name in _RANDOM:
            raise AssertionError(f"{func} inside a captured body")
        return func(*args, **(kwargs or {}))


class GuardedEpoch(graphs.GraphedEpoch):
    """The epoch's graph bodies under ``CaptureGuard``."""

    def _run(self, on_phase, replay):
        with CaptureGuard():
            super()._run(on_phase, replay)


class GuardedPolicy(graphs.GraphedPolicy):
    """The policy's graph body under ``CaptureGuard``."""

    def _body(self, obs, noise):
        with CaptureGuard():
            return super()._body(obs, noise)


@torch.no_grad()
def eager_policy(cfg, actor_critic, obs, deterministic, n_draw, shard=None, generator=None):
    """The play policy as ``Runner.make_policy`` ran it eagerly: the clipped
    obs through the actor, the noise of the global block's rows drawn after
    the forward, the action clipped."""
    from leibnizgym_tpu_torch.parallel.mesh import shard_batch

    mu, log_std, _ = actor_critic(torch.clamp(obs, -cfg.clip_obs, cfg.clip_obs))
    action = mu
    if not deterministic:
        action = mu + torch.exp(log_std) * shard_batch(torch.randn(
            (n_draw, mu.shape[1]), generator=generator, device=mu.device), shard)
    return torch.clamp(action, -cfg.clip_actions, cfg.clip_actions)


def d1_config(num_envs: int, agent: dict) -> dict:
    """The D1 preset with the asymmetric agent at tiny shapes: 2 substeps,
    horizon 4, the agent overrides ``agent``."""
    cfg = default_config()
    cfg["args"].update(num_envs=num_envs, seed=0)
    cfg = update_cfg(cfg)
    cfg["gym"]["sim"]["substeps"] = 2
    cfg["rlg"]["params"]["config"].update(
        steps_num=4, mini_epochs=2, **{k: v for k, v in agent.items() if not k.startswith("cv_")})
    cfg["rlg"]["params"]["config"]["central_value_config"].update(
        mini_epochs=2, **{k[3:]: v for k, v in agent.items() if k.startswith("cv_")})
    return cfg


def train_epochs(num_envs: int, epochs: int, agent: dict, shard=None) -> dict:
    """``epochs`` epochs of ``train_iteration`` on the D1 config, as one rank
    of the current process group when ``shard`` is given (True: this
    process's shard), else alone. Returns per epoch the scalar metrics, the
    per-env vectors, the rollout's trajectory and the collectives issued,
    then the learner's tensors."""
    from leibnizgym_tpu_torch.parallel.mesh import data_shard

    cfg = d1_config(num_envs, agent)
    pcfg = ppo.PPOConfig.from_rlg_params(cfg["rlg"]["params"], num_envs)
    shard = data_shard(num_envs) if shard else None
    env = TrifingerEnv(copy.deepcopy(cfg["gym"]), device="cpu", verbose=False, shard=shard)
    ts = ppo.init_train_state(pcfg, env.static, env.params, seed=0, shard=shard)
    rollout, trajs = ppo.rollout, []

    def recording(*args, **kw):
        carry, traj = rollout(*args, **kw)
        trajs.append({k: getattr(traj, k).clone() for k in TRAJ_KEYS})
        return carry, traj

    ppo.rollout = recording
    out = {"epochs": []}
    try:
        for _ in range(epochs):
            if shard is not None:
                shard.counts.clear()
            m = ppo.train_iteration(pcfg, env.static, env.params, ts)
            out["epochs"].append({
                "scalars": {k: float(v) for k, v in m.items()
                            if not torch.is_tensor(v) or v.dim() == 0},
                "finished_returns": m["episodes/finished_returns"].clone(),
                "finished_n": m["episodes/finished_n"].clone(),
                "traj": trajs[-1],
                "counts": dict(shard.counts) if shard is not None else {},
                "mb_steps": [ts.ac_opt.count, ts.cv_opt.count],
            })
    finally:
        ppo.rollout = rollout
    out["learner"] = {f"ac.{k}": v.clone() for k, v in ts.actor_critic.state_dict().items()}
    out["learner"].update({f"cv.{k}": v.clone() for k, v in ts.central_value.state_dict().items()})
    out["lr"] = float(ts.lr)
    return out


@dataclasses.dataclass(frozen=True)
class Static:
    """The EnvStatic fields the learner reads."""

    num_envs: int
    obs_dim: int
    state_dim: int
    action_dim: int
    asymmetric_obs: bool


@dataclasses.dataclass
class StubState:
    t: int
    reset_buf: torch.Tensor
    successes: torch.Tensor


def _stub_env_step(table):
    """``env_step`` replaced by a lookup of this rank's rows of a recorded
    trajectory table (as ``test_torch_ppo_update.py``'s stub)."""

    def env_step(static, params, state, action, draws):
        t = state.t
        new = StubState(t + 1, table["reset"][t], table["successes"][t])
        info = {"env/action_mean": torch.mean(action), "env/step": torch.full((), float(t))}
        return new, table["obs"][t], table["states"][t], table["reward"][t], table["done"][t], info

    return env_step


def stub_update(cfg: dict, static: dict, learner: dict, table: dict, noise, perms,
                modes=("eager",)) -> dict:
    """For each of ``modes``, one epoch as this rank of the process group on
    its rows of a recorded trajectory ``table`` (global (h, N, ...) arrays),
    from the converted ``learner`` (state dicts, Adam states, lr, epoch,
    frame, the global carry), fed the global action ``noise`` and the
    permutations ``perms``: "eager" through ``train_iteration``, "graphed"
    through the graph bodies under ``CaptureGuard``. Returns by mode the
    metrics, every actor step's (KL, lr), and the learner and carry after
    the epoch."""
    return {mode: _stub_update(cfg, static, learner, table, noise, perms, mode)
            for mode in modes}


def _stub_update(cfg, static, learner, table, noise, perms, mode):
    from leibnizgym_tpu_torch.parallel.mesh import data_shard

    pcfg = ppo.PPOConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()})
    shard = data_shard(static["num_envs"])
    st = Static(**dict(static, num_envs=shard.n_local))
    ac, cv = ppo.make_networks(pcfg, st)
    ac.load_state_dict(learner["ac"])
    if cv is not None:
        cv.load_state_dict(learner["cv"])
    local = {k: shard.take(v, 1) for k, v in table.items()}
    carry = ppo.RolloutCarry(
        StubState(0, torch.zeros(shard.n_local, dtype=torch.bool),
                  torch.zeros(shard.n_local, dtype=torch.int32)),
        *(shard.take(learner["carry"][k]).clone()  # the epoch writes the carry in place
          for k in ("obs", "states", "ep_return", "ep_len")))
    ts = ppo.TrainState.create(pcfg, ac, cv, carry, torch.Generator().manual_seed(0), shard)
    ts.ac_opt.load_state_dict(learner["ac_opt"])
    if cv is not None:
        ts.cv_opt.load_state_dict(learner["cv_opt"])
    ts.lr, ts.epoch, ts.frame = learner["lr"].clone(), learner["epoch"], learner["frame"]

    steps, step, env_step = [], ppo.actor_critic_step, ppo.env_step

    def recording_step(cfg, ac, opt, lr, mb, shard=None):
        new_lr, terms = step(cfg, ac, opt, lr, mb, shard)
        steps.append((terms[4].clone(), new_lr.clone()))  # no host read in a body
        return new_lr, terms

    epoch = ppo.train_iteration if mode == "eager" else GuardedEpoch()
    ppo.env_step, ppo.actor_critic_step = _stub_env_step(local), recording_step
    try:
        m = epoch(pcfg, st, None, ts, noise=noise, env_draws=[None] * pcfg.horizon,
                  perms=perms)
    finally:
        ppo.env_step, ppo.actor_critic_step = env_step, step
    steps = [(float(kl), float(lr)) for kl, lr in steps]
    opts = {"ac": ts.ac_opt.state_dict()}
    if cv is not None:
        opts["cv"] = ts.cv_opt.state_dict()
    return {
        "metrics": {k: v.clone() if torch.is_tensor(v) else v for k, v in m.items()},
        "steps": steps,
        "ac": ac.state_dict(), "cv": cv.state_dict() if cv is not None else None,
        "opts": opts, "epoch": ts.epoch, "frame": ts.frame,
        "carry": {k: getattr(ts.carry, k) for k in ("obs", "states", "ep_return", "ep_len")},
    }


def learner_payload(runner) -> dict:
    """The runner's checkpoint payload, with every tensor cloned to the CPU."""
    def cpu(x):
        if torch.is_tensor(x):
            return x.detach().cpu().clone()
        if isinstance(x, dict):
            return {k: cpu(v) for k, v in x.items()}
        return x

    return cpu(runner._ckpt_payload())


def runner_train_restore(num_envs: int, epochs: int, logdir: str, restore: str) -> dict:
    """A ``Runner`` of the D1 config as a rank of the process group: train
    ``epochs`` epochs (rank 0 writes ``nn/final``), then restore the
    checkpoint ``restore``. Returns the trained and the restored payloads,
    and the final checkpoint's path (None on other ranks)."""
    from leibnizgym_tpu_torch.learning.runner import Runner

    cfg = d1_config(num_envs, {})
    runner = Runner(copy.deepcopy(cfg["gym"]), cfg["rlg"]["params"], logdir=logdir, seed=0,
                    device="cpu")
    assert runner.shard is not None and runner.static.num_envs == runner.shard.n_local
    runner.train(max_epochs=epochs)
    trained = learner_payload(runner)
    final = os.path.join(runner.nn_dir, "final") if runner.is_main else None
    runner.restore(restore)
    return {"trained": trained, "restored": learner_payload(runner), "final": final}


# the cases of ``graph_bodies``: the agent overrides of each
GRAPH_CASES = {
    "time_sliced": {},  # minibatch = N: num_mb = 4 divides the horizon
    "global_shuffle": {"minibatch_size": 10, "cv_minibatch_size": 10},  # num_mb = 3
    "nan_telemetry": {"nan_telemetry": True},
}


def _train_state_tensors(ts) -> dict:
    """Every tensor an epoch changes: parameters, Adam moments and counts,
    lr, the rollout carry and env state."""
    out = {f"ac.{k}": v for k, v in ts.actor_critic.state_dict().items()}
    out.update({f"cv.{k}": v for k, v in ts.central_value.state_dict().items()})
    for tag, opt in (("ac_opt", ts.ac_opt), ("cv_opt", ts.cv_opt)):
        out.update({f"{tag}.mu.{n}": m for n, m in zip(opt.names, opt.mu)})
        out.update({f"{tag}.nu.{n}": m for n, m in zip(opt.names, opt.nu)})
        out[f"{tag}.count"] = opt.count
    out["lr"] = ts.lr
    out.update({f"carry.{k}": v for k, v in env_state_tensors(ts.carry.env_state).items()})
    out.update({f"carry.{k}": getattr(ts.carry, k)
                for k in ("obs", "states", "ep_return", "ep_len")})
    return out


def _unequal(a: dict, b: dict) -> list:
    """The keys whose values are not bitwise equal (or not in both)."""
    keys = sorted(set(a) ^ set(b))
    for k in sorted(set(a) & set(b)):
        x, y = a[k], b[k]
        same = torch.equal(x, y) if torch.is_tensor(x) else x == y
        if not same:
            keys.append(k)
    return keys


def _global_draws(pcfg, static, n_global: int, seed: int) -> dict:
    """One epoch's global action noise, env draws and permutations, from a
    CPU generator seeded alike on every rank."""
    from leibnizgym_tpu_torch.envs.trifinger.env import draw_step_randoms

    g = torch.Generator().manual_seed(seed)
    h = pcfg.horizon
    noise = torch.randn((h, n_global, static.action_dim), generator=g)
    env_draws = [draw_step_randoms(static, g, n_global, "cpu") for _ in range(h)]
    perms = ppo.draw_permutations(pcfg, h, n_global, True, g, "cpu")
    return {"noise": noise, "env_draws": env_draws, "perms": perms}


def graph_bodies(num_envs: int, epochs: int = 3) -> dict:
    """As this rank of the process group, for each of ``GRAPH_CASES`` on the
    D1 config (1 substep of 2 solver iterations): ``epochs`` epochs of the graph bodies (``GuardedEpoch``) and
    of ``train_iteration`` on twin learners, epoch 1 from the generator, the
    rest from injected global draws, epoch 1's checkpoint restored in place
    into both before the last. Returns per case and epoch the keys of the
    metrics and of the learner and carry that differ, both paths'
    collectives and the ``nan/*`` keys; then the play policy's graph body
    (``GuardedPolicy``) against the eager policy, deterministic and with
    noise, on three calls each: whether each call's actions were equal."""
    import copy

    from leibnizgym_tpu_torch.parallel.mesh import data_shard

    shard = data_shard(num_envs)
    out = {}
    for case, agent in GRAPH_CASES.items():
        cfg = d1_config(num_envs, agent)
        cfg["gym"]["sim"]["substeps"] = 1  # the physics is not what is compared here
        cfg["gym"]["sim"]["physx"]["num_position_iterations"] = 2
        pcfg = ppo.PPOConfig.from_rlg_params(cfg["rlg"]["params"], num_envs)
        env = TrifingerEnv(copy.deepcopy(cfg["gym"]), device="cpu", verbose=False, shard=shard)
        eager = ppo.init_train_state(pcfg, env.static, env.params, seed=0, shard=shard)
        graphed = ppo.init_train_state(pcfg, env.static, env.params, seed=0, shard=shard)
        epoch, rows, saved = GuardedEpoch(), [], None
        for e in range(1, epochs + 1):
            if e == epochs:  # epoch 1's learner, restored in place
                for ts in (eager, graphed):
                    ts.actor_critic.load_state_dict(saved["ac"])
                    ts.central_value.load_state_dict(saved["cv"])
                    ts.ac_opt.load_state_dict(saved["ac_opt"])
                    ts.cv_opt.load_state_dict(saved["cv_opt"])
                    ts.lr.copy_(saved["lr"])
            draws = {} if e == 1 else _global_draws(pcfg, env.static, num_envs, e)
            counts = {}
            for mode, ts, fn in (("eager", eager, ppo.train_iteration),
                                 ("graphed", graphed, epoch)):
                shard.counts.clear()
                m = fn(pcfg, env.static, env.params, ts, **copy.deepcopy(draws))
                counts[mode] = (m, dict(shard.counts))
            (me, ce), (mg, cg) = counts["eager"], counts["graphed"]
            rows.append({
                "metrics_unequal": _unequal(me, mg),
                "state_unequal": _unequal(_train_state_tensors(eager),
                                          _train_state_tensors(graphed)),
                "counts_eager": ce, "counts_graphed": cg,
                "nan_keys": sorted(k for k in mg if k.startswith("nan/")),
                "ac_count": int(graphed.ac_opt.count),
            })
            if e == 1:
                saved = {"ac": copy.deepcopy(eager.actor_critic.state_dict()),
                         "cv": copy.deepcopy(eager.central_value.state_dict()),
                         "ac_opt": copy.deepcopy(eager.ac_opt.state_dict()),
                         "cv_opt": copy.deepcopy(eager.cv_opt.state_dict()),
                         "lr": eager.lr.clone()}
        out[case] = {"epochs": rows, "ac_steps": epoch.ac_steps, "cv_steps": epoch.cv_steps}

    policy = {}
    obs0 = graphed.carry.obs
    for deterministic in (True, False):
        guarded = GuardedPolicy(pcfg, graphed.actor_critic, num_envs, deterministic, shard)
        g_eager, g_graph = (torch.Generator().manual_seed(3) for _ in range(2))
        same = []
        for t in range(3):
            obs = obs0 * (1.0 + 2.0 * t)  # some beyond the obs clip
            want = eager_policy(pcfg, graphed.actor_critic, obs, deterministic, num_envs, shard,
                                g_eager)
            got = guarded(obs, g_graph)
            same.append(bool(torch.equal(want, got)) and bool((want != 0).any()))
        policy["deterministic" if deterministic else "stochastic"] = same
    out["policy"] = policy
    return out


def rank_value(x: float) -> dict:
    """This rank's place in the group and the sum over the ranks of
    ``x * (rank + 1)``."""
    import torch.distributed as dist

    t = torch.tensor([x * (dist.get_rank() + 1)])
    dist.all_reduce(t)
    return {"rank": dist.get_rank(), "world": dist.get_world_size(), "sum": float(t)}


def fail_on_rank(rank: int) -> None:
    """Rank ``rank`` raises; every other child waits in a collective that
    the failed rank never joins."""
    import torch.distributed as dist

    if dist.get_rank() == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    dist.all_reduce(torch.ones(1))


def per_process_runner(num_envs: int, epochs: int, logdir: str, graphed: bool) -> dict:
    """A ``Runner`` of the D1 config (horizon 4, 2 + 2 mini-epochs) trained
    ``epochs`` epochs as one rank of the current process group (alone
    without one), at rl_games' per-process sizes: ``num_envs`` envs and a
    minibatch of ``num_envs`` rows on each of W ranks, so the port's global
    ``num_instances`` = ``num_actors`` = minibatch = W x ``num_envs``.
    ``graphed``: the epoch is ``GraphedEpoch``'s bodies (eager off the
    card). Returns the minibatch layout, each epoch's collectives as the
    ``epoch`` span has them and as the shard's counts changed over the
    epoch function's call, the ranks of the spans the call recorded, and
    the learner (parameters, Adam states, lr)."""
    import collections

    import torch.distributed as dist

    from leibnizgym_tpu_torch.learning.runner import Runner
    from leibnizgym_tpu_torch.utils import trace

    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world * num_envs
    cfg = d1_config(n, {"minibatch_size": n, "cv_minibatch_size": n})
    runner = Runner(copy.deepcopy(cfg["gym"]), cfg["rlg"]["params"], logdir=logdir, seed=0,
                    device="cpu")
    pcfg, shard = runner.ppo_cfg, runner.shard
    if graphed:
        runner._train_iter = graphs.GraphedEpoch()
    epoch_fn, issued = runner._train_iter, []

    def counted(*args, **kwargs):
        before = collections.Counter(shard.counts) if shard is not None else None
        metrics = epoch_fn(*args, **kwargs)
        issued.append(dict(shard.counts - before) if shard is not None else None)
        return metrics

    runner._train_iter = counted
    known = {s.id for s in trace.records()}
    runner.train(max_epochs=epochs)
    spans = [s for s in trace.records() if s.id not in known]
    ts = runner.ts
    learner = list(ts.learner_tensors())
    for opt in (ts.ac_opt, ts.cv_opt):
        learner += list(opt.mu) + list(opt.nu) + [opt.count]
    return {
        "rank": dist.get_rank() if dist.is_initialized() else None,
        "layout": [list(ppo.minibatch_layout(pcfg.shuffle_minibatches, pcfg.horizon, n, size))
                   for size in (pcfg.minibatch_size, pcfg.cv_minibatch_size)],
        "issued": issued,
        "span_collectives": [s.attrs.get("collectives") for s in spans if s.name == "epoch"],
        "span_ranks": sorted({s.rank for s in spans}),
        "learner": [x.detach().clone() for x in learner],
    }
