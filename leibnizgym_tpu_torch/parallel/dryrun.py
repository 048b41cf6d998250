"""Multi-process dry run (counterpart of ``leibnizgym_tpu/parallel/dryrun.py``):
n ranks, each stepping its shard of the env axis, run one env step, one
PPO epoch, and one epoch of the flagship recipe
(``trifinger_difficulty_4_curriculum_dr``: domain randomization, keypoint
observations, the success-gated curriculum, the cone arena) with a 2-frame
stack, so that config growth cannot silently break the sharded path.
Tiny shapes: 4 envs per rank, 2 substeps.

    python -c "from leibnizgym_tpu_torch.graft_entry import dryrun_multichip; dryrun_multichip(2)"
    python -c "from leibnizgym_tpu_torch.graft_entry import dryrun_multichip; dryrun_multichip(2, 'cuda')"
    python -c "from leibnizgym_tpu_torch.graft_entry import dryrun_multichip; dryrun_multichip(2, 'cpu')"

A device name (``cuda:0``, ``cpu``) puts every rank on it under gloo, whose
epochs run eagerly on a card; ``cuda`` puts rank r on ``cuda:r`` under
NCCL, whose epochs replay CUDA graphs (``learning/train.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

ENVS_PER_RANK = 4


def dryrun_rank(device: str = "cuda:0") -> dict:
    """One rank's dry run (run by ``parallel.launch``); returns what each
    phase produced."""
    from leibnizgym_tpu_torch.config.presets import parse_cli, update_cfg
    from leibnizgym_tpu_torch.envs.trifinger.env import TrifingerEnv
    from leibnizgym_tpu_torch.learning.train import make_train_step_for_dryrun
    from leibnizgym_tpu_torch.ops import cuda_engine
    from leibnizgym_tpu_torch.parallel.mesh import data_shard

    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device(f"cuda:{rank}" if device == "cuda" else device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    n = ENVS_PER_RANK * world
    shard = data_shard(n)
    env = TrifingerEnv(config={"num_instances": n, "command_mode": "torque",
                               "asymmetric_obs": True, "sim": {"substeps": 2}},
                       device=dev, verbose=False, shard=shard)
    env.reset()
    obs, reward, dones, _ = env.step(torch.zeros((shard.n_local, env.static.action_dim),
                                                 device=dev))
    out = {"obs_shape": list(obs.shape), "obs_finite": bool(torch.isfinite(obs).all())}
    print(f"[dryrun] sharded env step OK on rank {rank} of {world}: obs {tuple(obs.shape)}",
          flush=True)

    train_step, ts = make_train_step_for_dryrun(env)
    out["loss"] = float(train_step(ts)["losses/total"])
    out["graphed"] = getattr(train_step.epoch, "graphs", None) is not None
    print(f"[dryrun] sharded PPO train step OK on rank {rank} of {world}", flush=True)

    cfg_all = update_cfg(parse_cli(["gym=trifinger_difficulty_4_curriculum_dr",
                                    f"args.num_envs={n}"]))
    gym_cfg = dict(cfg_all["gym"])
    gym_cfg.pop("rlg_overrides", None)
    gym_cfg["arena"] = {"profile": "cone"}
    gym_cfg["sim"] = dict(gym_cfg.get("sim") or {}, substeps=2)
    flagship = TrifingerEnv(config=gym_cfg, device=dev, verbose=False, shard=shard)
    train_step, ts = make_train_step_for_dryrun(flagship, frames=2)
    m = train_step(ts)
    out["flagship_loss"] = float(m["losses/total"])
    out["flagship_obs_width"] = ts.carry.obs.shape[1]
    print(f"[dryrun] sharded FLAGSHIP train step (cone+DR+frames=2) OK on rank {rank} "
          f"of {world}", flush=True)
    out["kernel_launches"] = cuda_engine.launch_count  # 0 on the CPU
    return out


def run_dryrun(n_processes: int, device: str = "cuda:0") -> list:
    """The dry run in ``n_processes`` processes: gloo ones on ``device``, or
    NCCL ones each on its card where ``device`` is ``cuda`` (module
    docstring); returns each rank's results. Several ranks may share one GPU
    under gloo."""
    from leibnizgym_tpu_torch.parallel.launch import launch

    return launch("leibnizgym_tpu_torch.parallel.dryrun:dryrun_rank", n_processes,
                  {"device": device}, backend="nccl" if device == "cuda" else "gloo",
                  timeout=900, echo=True)
