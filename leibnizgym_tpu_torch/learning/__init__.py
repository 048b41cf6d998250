"""PPO learning stack."""

from leibnizgym_tpu_torch.learning.ppo import (
    PPOConfig,
    PPOTrainState,
    init_train_state,
    train_iteration,
)
from leibnizgym_tpu_torch.learning.runner import AverageMeter, Runner
from leibnizgym_tpu_torch.learning.train import run_training

__all__ = [
    "PPOConfig",
    "PPOTrainState",
    "init_train_state",
    "train_iteration",
    "AverageMeter",
    "Runner",
    "run_training",
]
