"""Offline visualizer (counterpart of ``scripts/replay_viewer.py``): roll the
env out on the card, with random actions or a trained policy, take one
env's scene (fingertips, cube, goal) at every step and draw the frames with
matplotlib into a GIF (top and side views; Pillow writes it).

    python -m leibnizgym_tpu_torch.scripts.replay_viewer --steps 100 --out replay.gif
    python -m leibnizgym_tpu_torch.scripts.replay_viewer --gym trifinger_difficulty_4_curriculum \\
        --checkpoint leibnizgym_tpu_torch/resources/policies/d4_best_curriculum.npz --steps 300

``--checkpoint`` takes a checkpoint of the port's Runner (``nn/<name>``) or
a shipped ``.npz`` policy. ``--gym`` rebuilds the training preset's env and
network widths (keypoint obs, frame stacking); ``--level`` sets a
success-gated curriculum's level (default 1.0, full difficulty). The
default output is ``trifinger_replay.gif`` in the temporary directory.
``--device`` defaults to ``cuda:0``; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

from leibnizgym_tpu_torch.envs.trifinger.env import TrifingerEnv
from leibnizgym_tpu_torch.models import trifinger as tf_model
from leibnizgym_tpu_torch.utils.helpers import resolve_device
from leibnizgym_tpu_torch.utils.message import print_info
from leibnizgym_tpu_torch.utils.viewer import draw_frame, extract_frame


def load_policy(env: TrifingerEnv, checkpoint: str, ppo_cfg=None):
    """The deterministic policy ``obs -> action`` of a Runner checkpoint or
    a shipped ``.npz``, with the training-time clips. Exits with the
    reference's message when the checkpoint's input width is not what the
    env would feed it."""
    from leibnizgym_tpu_torch.convert import checkpoint_from_npz
    from leibnizgym_tpu_torch.learning.ppo import PPOConfig, make_networks

    cfg = ppo_cfg if ppo_cfg is not None else PPOConfig()
    path = os.path.abspath(checkpoint)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at: {path}")
    payload = (checkpoint_from_npz(path, env.device) if path.endswith(".npz")
               else torch.load(path, map_location=env.device, weights_only=True))
    weights = payload["ac_state_dict"]
    # detect an obs-width mismatch up front (e.g. a checkpoint trained with
    # frame stacking replayed without --gym, so frames defaults to 1) instead
    # of failing inside the first layer with an opaque shape error
    ckpt_in = int(weights["actor_0.weight"].shape[1])
    frames_n = cfg.frames  # PPOConfig() default is frames=1
    feed_in = env.static.obs_dim * frames_n
    if ckpt_in != feed_in:
        if ckpt_in % env.static.obs_dim == 0:
            want = ckpt_in // env.static.obs_dim
            hint = (
                f" The checkpoint expects frames={want} "
                f"(rlg.params.config.frames) — pass --gym <preset> so the "
                f"training preset's frame stacking (and obs layout) is "
                f"reconstructed."
            )
        else:
            hint = (
                " Pass --gym <preset> matching the training run so the "
                "obs layout (e.g. keypoint obs) and frame stacking are "
                "reconstructed."
            )
        raise SystemExit(
            f"checkpoint/network mismatch: the restored actor consumes "
            f"{ckpt_in}-dim observations but the env would feed "
            f"{feed_in} (obs_dim {env.static.obs_dim} x frames "
            f"{frames_n}).{hint}"
        )
    actor_critic, _ = make_networks(cfg, env.static, env.device)
    actor_critic.load_state_dict(weights)

    @torch.no_grad()
    def policy(obs):
        mu, _, _ = actor_critic(torch.clamp(obs, -cfg.clip_obs, cfg.clip_obs))
        return torch.clamp(mu, -cfg.clip_actions, cfg.clip_actions)

    return policy


def record_rollout(env: TrifingerEnv, num_steps: int, checkpoint: str | None,
                   env_index: int = 0, ppo_cfg=None) -> list:
    """Roll out ``num_steps`` steps and capture env ``env_index``'s scene
    after each (``extract_frame``: tips, cube pose, goal pose)."""
    from leibnizgym_tpu_torch.wrappers import stack_if_frames

    policy = load_policy(env, checkpoint, ppo_cfg) if checkpoint else None
    # frame stacking parity: a checkpoint trained with frames > 1 expects
    # stacked obs, as the play and eval paths feed them
    stacked_env = stack_if_frames(
        env, ppo_cfg.frames if (policy is not None and ppo_cfg) else 1
    )
    obs = stacked_env.reset()
    gen = torch.Generator(device=env.device).manual_seed(0)
    frames = []
    for _ in range(num_steps):
        if policy is not None:
            action = policy(obs)
        else:
            action = torch.rand((env.num_instances, env.get_action_dim()), generator=gen,
                                device=env.device) * 2.0 - 1.0
        obs, _, _, _ = stacked_env.step(action)
        frames.append(extract_frame(env.state, env_index))
    return frames


def make_env(args):
    """(env, PPOConfig or None) for the arguments: the ``--gym`` preset with
    its agent, or a torque env of ``--difficulty``."""
    device = resolve_device(args.device, cpu_hint="--device cpu")
    if not args.gym:
        return TrifingerEnv(
            config={"num_instances": args.num_envs, "command_mode": "torque",
                    "task_difficulty": args.difficulty, "sim": {"substeps": 2}},
            device=device, verbose=False), None
    from leibnizgym_tpu_torch.config.presets import parse_cli, update_cfg
    from leibnizgym_tpu_torch.learning.ppo import PPOConfig

    cfg = update_cfg(parse_cli([f"gym={args.gym}", f"args.num_envs={args.num_envs}"]))
    env = TrifingerEnv(config=cfg["gym"], device=device, verbose=False)
    ppo_cfg = PPOConfig.from_rlg_params(cfg["rlg"]["params"], num_actors=args.num_envs)
    if env.static.curriculum_success_gated:
        env.params = env.params.with_curriculum_level(args.level)
        print_info(f"replay at curriculum level {args.level:.2f}")
    return env, ppo_cfg


def write_gif(frames: list, out: str) -> None:
    """Draw ``frames`` (top and side views) into a GIF with matplotlib's
    Pillow writer."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    half = float(tf_model.CUBE_SIZE / 2)
    fig, (ax_top, ax_side) = plt.subplots(1, 2, figsize=(8, 4))

    def update(i):
        draw_frame(ax_top, ax_side, frames[i], half)
        return []

    anim = animation.FuncAnimation(fig, update, frames=len(frames), interval=40)
    anim.save(out, writer="pillow", fps=25)
    plt.close(fig)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--num-envs", type=int, default=4)
    ap.add_argument("--env-index", type=int, default=0)
    ap.add_argument("--difficulty", type=int, default=1)
    ap.add_argument("--gym", type=str, default=None,
                    help="gym preset name (e.g. trifinger_difficulty_4_curriculum); builds "
                         "the env AND the network dims the checkpoint was trained with "
                         "(keypoint obs, substeps, reward config)")
    ap.add_argument("--level", type=float, default=1.0,
                    help="curriculum level for success-gated presets (default 1.0 = full "
                         "difficulty)")
    ap.add_argument("--checkpoint", type=str, default=None)
    ap.add_argument("--out", type=str,
                    default=os.path.join(tempfile.gettempdir(), "trifinger_replay.gif"))
    ap.add_argument("--stride", type=int, default=2, help="render every k-th step")
    ap.add_argument("--device", default="cuda:0")
    return ap


def main(argv=None) -> list:
    args = parser().parse_args(argv)
    env, ppo_cfg = make_env(args)
    frames = record_rollout(env, args.steps, args.checkpoint, args.env_index, ppo_cfg=ppo_cfg)
    frames = frames[:: args.stride]
    write_gif(frames, args.out)
    print_info(f"wrote {args.out} ({len(frames)} frames)")
    return frames


if __name__ == "__main__":
    main(sys.argv[1:])
