"""Physics compute path: kinematics, dynamics, contacts, engines."""

from leibnizgym_tpu_torch.ops.engine import physics_step
from leibnizgym_tpu_torch.ops.types import PhysicsState, SceneParams, SolverConfig

__all__ = ["physics_step", "PhysicsState", "SceneParams", "SolverConfig"]
