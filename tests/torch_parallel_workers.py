"""Rank functions that ``tests/test_torch_parallel*.py`` run through
``leibnizgym_tpu_torch.parallel.launch`` (one process per rank, gloo on
the CPU). They import torch and the port only; each returns tensors,
numbers and dicts, which come back to the test."""

from __future__ import annotations

import copy
import dataclasses
import os

import torch

from leibnizgym_tpu_torch.config.presets import default_config, update_cfg
from leibnizgym_tpu_torch.envs.trifinger.env import TrifingerEnv
from leibnizgym_tpu_torch.learning import ppo

torch.set_num_threads(1)

TRAJ_KEYS = ("obs", "states", "action", "mu", "reward", "done", "value")


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
        info = {"env/action_mean": torch.mean(action), "env/step": torch.tensor(float(t))}
        return new, table["obs"][t], table["states"][t], table["reward"][t], table["done"][t], info

    return env_step


def stub_update(cfg: dict, static: dict, learner: dict, table: dict, noise, perms) -> dict:
    """One epoch of ``train_iteration`` as this rank of the process group on
    its rows of a recorded trajectory ``table`` (global (h, N, ...) arrays),
    from the converted ``learner`` (state dicts, Adam states, lr, epoch,
    frame, the global carry), fed the global action ``noise`` and the
    permutations ``perms``. Returns the metrics, every actor step's (KL,
    lr), and the learner and carry after the epoch."""
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
        *(shard.take(learner["carry"][k]) for k in ("obs", "states", "ep_return", "ep_len")))
    ts = ppo.TrainState.create(pcfg, ac, cv, carry, torch.Generator().manual_seed(0), shard)
    ts.ac_opt.load_state_dict(learner["ac_opt"])
    if cv is not None:
        ts.cv_opt.load_state_dict(learner["cv_opt"])
    ts.lr, ts.epoch, ts.frame = learner["lr"].clone(), learner["epoch"], learner["frame"]

    steps, step, env_step = [], ppo.actor_critic_step, ppo.env_step

    def recording_step(cfg, ac, opt, lr, mb, shard=None):
        new_lr, terms = step(cfg, ac, opt, lr, mb, shard)
        steps.append((float(terms[4]), float(new_lr)))
        return new_lr, terms

    ppo.env_step, ppo.actor_critic_step = _stub_env_step(local), recording_step
    try:
        m = ppo.train_iteration(pcfg, st, None, ts, noise=noise,
                                env_draws=[None] * pcfg.horizon, perms=perms)
    finally:
        ppo.env_step, ppo.actor_critic_step = env_step, step
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
