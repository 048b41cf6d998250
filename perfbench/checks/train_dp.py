"""The check of a data-parallel training cell: ``checks/train.py``'s three
stages at the global batch, each rank holding its own part.

Every rank builds the same ``ShardRecorder`` from the seed, over the global
env count N: the same sampled rows, starting weights, and global draw
blocks and permutations, which it hands to its epoch function (the epoch
keeps the rank's rows of the draws, ``parallel/mesh.py`` rule 1). What a
rank records is its own part: the checked epochs' trajectory and carry of
its envs, its minibatch steps' loss terms, its learner; at the replayed
epoch the env state, carry and trajectory of the sampled rows it holds.
After the window rank 0 gathers every rank's records (``merge``) into one
``Recorder`` over all N envs, which ``checks/train.py`` ``compare`` holds
to the plain reference run as one process at the global batch:

- the rollouts: the rows' trajectories and states, joined in rank order
  (the rows are sorted, and the ranks hold consecutive blocks of envs);
- the updates: the trajectory of all N envs; each step's critic and
  central-value losses, which a rank computes over its own rows of the
  minibatch, are averaged over the ranks (equal shares: the global
  minibatch's mean); the KL is rank 0's, which every rank holds alike after
  its step's all-reduce; the learner after each epoch is rank 0's.

``rank_learner_mismatch`` counts the ranks whose learner (both networks'
parameters, both Adam states and the learning rate) after the window is
not bitwise rank 0's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from perfbench.checks import train as check


def env_axes(state, n: int) -> Dict[str, Optional[int]]:
    """The env axis of every tensor of an env state under the flat names of
    ``check.state_rows``, by its rule; None for a tensor without one."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        leaves = ({f"{f.name}_{g.name}": getattr(v, g.name) for g in dataclasses.fields(v)}
                  if dataclasses.is_dataclass(v) else {f.name: v})
        for name, x in leaves.items():
            axis = x.dim() - 1 if name.endswith("_cm") else 0
            out[name] = axis if x.dim() and x.shape[axis] == n else None
    return out


class ShardRecorder(check.Recorder):
    """A ``check.Recorder`` over the global ``num_envs`` on a rank that holds
    envs ``[lo, hi)``: it draws and hands out the global blocks, and
    records its own envs (module docstring)."""

    def __init__(self, config: dict, num_envs: int, seed: int, device, epochs: int,
                 rows: int, steps: int, window_start: int, lo: int, hi: int):
        super().__init__(config, num_envs, seed, device, epochs, rows, steps, window_start)
        self.n_local = hi - lo
        self.local = self.rows[(self.rows >= lo) & (self.rows < hi)] - lo
        self._local_dev = self.local.to(device)
        self.env_axes = None

    def replay_start(self, ts, env_params) -> dict:
        """As ``check.Recorder.replay_start``, of the sampled rows this rank
        holds; the draws' rows are the global ones."""
        rows, local, carry = self._rows_dev, self._local_dev, ts.carry
        noise, env_draws = self._rollout_draws()
        self.env_axes = env_axes(carry.env_state, self.n_local)
        self.replay = {
            "env": check.state_rows(carry.env_state, local, self.n_local),
            "carry": {k: getattr(carry, k).index_select(0, local)
                      for k in ("obs", "states", "ep_return", "ep_len")},
            "level": env_params.curriculum_level.detach().clone(),
            "params": {"ac": {k: v.detach().clone()
                              for k, v in ts.actor_critic.state_dict().items()},
                       "cv": ({k: v.detach().clone()
                               for k, v in ts.central_value.state_dict().items()}
                              if ts.central_value is not None else None)},
            "noise": noise.index_select(1, rows),
            "env_draws": [check.rows_of(d, rows) for d in env_draws],
        }
        return {"noise": noise, "env_draws": env_draws}

    def replay_rollout(self, traj) -> None:
        self.replay["traj"] = {k: getattr(traj, k).index_select(1, self._local_dev)
                               for k in check.ROLLOUT_FIELDS}

    def records(self) -> dict:
        """What rank 0 needs of this rank, on the host (after
        ``replay_to_host``)."""
        return {"epochs": self.epochs, "replay": self.replay, "env_axes": self.env_axes}


def merge(rec: ShardRecorder, parts: List[dict]) -> ShardRecorder:
    """``rec`` (rank 0's) with every rank's records (``parts``, in rank
    order, rank 0's first) joined into the global ones (module docstring)."""
    for k, ep in enumerate(rec.epochs):
        eps = [p["epochs"][k] for p in parts]
        for key in check.TRAJ_FIELDS:
            ep[key] = torch.cat([e[key] for e in eps], dim=1)
        for key in ("last_obs", "last_states"):
            ep[key] = torch.cat([e[key] for e in eps], dim=0)

        def mean(key):
            if eps[0]["steps"][key] is None:
                return None
            return torch.stack([e["steps"][key].double() for e in eps]).mean(0)

        ep["steps"] = {"c_loss": mean("c_loss"), "kl": ep["steps"]["kl"],
                       "cv_loss": mean("cv_loss")}
    replays = [p["replay"] for p in parts]
    axes = parts[0]["env_axes"]
    rec.replay = dict(rec.replay)
    rec.replay["env"] = {
        name: (x if axes[name] is None else
               torch.cat([r["env"][name] for r in replays], dim=axes[name]))
        for name, x in rec.replay["env"].items()}
    rec.replay["carry"] = {k: torch.cat([r["carry"][k] for r in replays], dim=0)
                           for k in rec.replay["carry"]}
    rec.replay["traj"] = {k: torch.cat([r["traj"][k] for r in replays], dim=1)
                          for k in rec.replay["traj"]}
    return rec


def learner_state(ts) -> List[torch.Tensor]:
    """Both networks' parameters, both Adam states and the learning rate,
    copied to the host."""
    out = list(ts.learner_tensors())
    for opt in (ts.ac_opt, ts.cv_opt):
        if opt is not None:
            out += list(opt.mu) + list(opt.nu) + [opt.count]
    return [check.host(x) for x in out]


def rank_learner_mismatch(learners: List[List[torch.Tensor]]) -> float:
    """The number of ranks whose learner is not bitwise rank 0's (the first)."""
    first = learners[0]
    return float(sum(
        len(other) != len(first) or not all(torch.equal(a, b) for a, b in zip(first, other))
        for other in learners[1:]))
