"""Env wrappers."""

from leibnizgym_tpu_torch.wrappers.frame_stack import FrameStack, stack_if_frames
from leibnizgym_tpu_torch.wrappers.vec_task import VecTask, VecTaskPython

__all__ = ["FrameStack", "VecTask", "VecTaskPython", "stack_if_frames"]
