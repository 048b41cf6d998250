"""Entry points of the port (counterpart of the root ``__graft_entry__.py``):
a forward step of the flagship workload, and the multi-process dry run.

    python -m leibnizgym_tpu_torch.graft_entry          # entry() once on the card
    python -c "from leibnizgym_tpu_torch.graft_entry import dryrun_multichip; dryrun_multichip(2)"
    python -c "from leibnizgym_tpu_torch.graft_entry import dryrun_multichip; dryrun_multichip(2, 'cuda')"
    python -c "from leibnizgym_tpu_torch.graft_entry import dryrun_multichip; dryrun_multichip(2, 'cpu')"
"""

from __future__ import annotations

import torch


def entry(device="cuda:0"):
    """(fn, example_args): ``fn(state, action) -> (obs, reward, dones)`` is
    one batched TriFinger env step (physics and MDP) of 128 envs, its
    draws from a seeded generator."""
    from leibnizgym_tpu_torch.envs.trifinger.env import (
        TrifingerEnv,
        draw_step_randoms,
        env_step,
    )

    env = TrifingerEnv(config={"num_instances": 128, "command_mode": "torque",
                               "asymmetric_obs": True, "sim": {"substeps": 2}},
                       device=device, verbose=False)
    env.reset()
    static, params = env.static, env.params
    gen = torch.Generator(device=env.device).manual_seed(0)

    def fn(state, action):
        draws = draw_step_randoms(static, gen, static.num_envs, env.device)
        _, obs, _, reward, dones, _ = env_step(static, params, state, action, draws)
        return obs, reward, dones

    return fn, (env.state, torch.zeros((128, static.action_dim), device=env.device))


def dryrun_multichip(n_devices: int, device: str = "cuda:0") -> list:
    """The sharded env step and training steps in ``n_devices`` processes on
    tiny shapes (``parallel/dryrun.py``): gloo ones all on ``device`` (gloo
    ranks may share one card; ``device="cpu"`` runs it on the CPU), or, with
    ``device="cuda"``, NCCL ones each on its own card, graphed."""
    from leibnizgym_tpu_torch.parallel.dryrun import run_dryrun

    return run_dryrun(n_devices, device)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry() run OK:", [tuple(o.shape) for o in out])
