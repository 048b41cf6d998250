"""The port's training CLI (``leibnizgym_tpu_torch/scripts/train.py``) and
frame stack (``wrappers/frame_stack.py``).

- The CLI trains D1 with a 2-frame stack for 2 epochs on the CPU, as
  tests/test_runner.py's CLI smoke test does for the reference, in a
  subprocess, and writes ``nn/final``.
- Asking for CUDA where there is none is an error, never a CPU run.
- ``args.wandb_log=True`` without wandb installed prints the reference's
  note and trains.
- ``FrameStack`` against the reference's ``FrameStack`` on the same
  observation sequence: stacking only copies, so the two are equal.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leibnizgym_tpu.wrappers.frame_stack import FrameStack as JaxFrameStack
from leibnizgym_tpu_torch.learning import runner as trunner
from leibnizgym_tpu_torch.scripts import train as tcli
from leibnizgym_tpu_torch.wrappers import FrameStack, stack_if_frames

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_trains_d1_with_frame_stack(tmp_path):
    argv = ["gym=trifinger_difficulty_1", "args.num_envs=8", "args.device=cpu",
            "gym.sim.substeps=2", "rlg.params.config.frames=2",
            "rlg.params.config.steps_num=4", "rlg.params.config.mini_epochs=2",
            "args.max_epochs=2", f"args.logdir={tmp_path}"]
    proc = subprocess.run([sys.executable, "-m", "leibnizgym_tpu_torch.scripts.train", *argv],
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (stamp,) = os.listdir(tmp_path)
    run = tmp_path / stamp
    assert {"agent_config.yaml", "env_config.yaml", "nn"} <= set(os.listdir(run))
    ckpt = torch.load(run / "nn" / "final", weights_only=True)
    assert ckpt["epoch"] == 2 and ckpt["frame"] == 2 * 4 * 8
    assert ckpt["ac_state_dict"]["actor_0.weight"].shape == (400, 2 * 41)  # 2 frames of 41
    assert ckpt["ac_opt_state"]["count"] == 2 * 2 * 4  # epochs x mini-epochs x minibatches
    for sd in (ckpt["ac_state_dict"], ckpt["cv_state_dict"]):
        assert all(bool(torch.isfinite(v).all()) for v in sd.values())


@pytest.mark.parametrize("device", ["TPU", "cuda", "cuda:0"])
def test_cuda_without_a_card_is_an_error(device, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        trunner.resolve_device(device)
    with pytest.raises(RuntimeError, match="args.device=cpu"):
        tcli.main(["args.num_envs=8", f"args.device={device}", f"args.logdir={tmp_path}"])
    assert trunner.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("key", ["multihost"])
def test_cli_refuses_unported_args(key, monkeypatch):
    """No argument of the reference is refused as unported any more:
    ``args.multihost`` joins a process group (tests/test_torch_parallel_cli.py
    trains through it). What it still refuses, before any device or network
    use, is a rendezvous it cannot make: a coordinator address without the
    world size and rank, or no coordinator outside ``torchrun``."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="num_processes and process_id"):
        tcli.main([f"args.{key}=True", "args.device=cpu",
                   "args.coordinator_address=localhost:29500"])
    with pytest.raises(ValueError, match="RANK"):
        tcli.main([f"args.{key}=True", "args.device=cpu"])


def test_cli_wandb_log_without_wandb_trains(tmp_path, capsys, monkeypatch):
    """args.wandb_log=True where wandb is not installed: the reference
    (scripts/train.py:43-55) prints a note and trains, and so does the port."""
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb -> ImportError
    tcli.main(["gym=trifinger_difficulty_1", "args.num_envs=8", "args.device=cpu",
               "args.wandb_log=True", "gym.sim.substeps=1", "rlg.params.config.steps_num=2",
               "rlg.params.config.mini_epochs=1", "args.max_epochs=1",
               f"args.logdir={tmp_path}"])
    assert "wandb not installed; continuing without it" in capsys.readouterr().out
    (stamp,) = os.listdir(tmp_path)
    assert torch.load(tmp_path / stamp / "nn" / "final", weights_only=True)["epoch"] == 1


class _SeqEnv:
    """Hands out a fixed sequence of observations."""

    num_obs, num_states, num_actions, num_envs = 5, 0, 2, 3

    def __init__(self, seq, wrap):
        self.seq, self.wrap, self.t = seq, wrap, 0

    def reset(self):
        self.t = 0
        return self.wrap(self.seq[0])

    def step(self, actions):
        self.t += 1
        return self.wrap(self.seq[self.t]), 0.0, False, {}


@pytest.mark.parametrize("frames", [2, 3])
def test_frame_stack_matches_reference(frames):
    seq = np.random.default_rng(frames).normal(size=(6, 3, 5)).astype(np.float32)
    ref = JaxFrameStack(_SeqEnv(seq, jnp.asarray), frames)
    port = stack_if_frames(_SeqEnv(seq, torch.as_tensor), frames)
    assert isinstance(port, FrameStack) and port.num_obs == 5 * frames
    np.testing.assert_array_equal(port.reset().numpy(), np.asarray(ref.reset()))
    for _ in range(5):
        obs, *_ = port.step(None)
        ref_obs, *_ = ref.step(None)
        np.testing.assert_array_equal(obs.numpy(), np.asarray(ref_obs))
    # oldest frame first: the last block is the newest observation
    np.testing.assert_array_equal(obs[:, -5:].numpy(), seq[5])
    assert stack_if_frames(port.env, 1) is port.env
