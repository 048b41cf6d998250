"""Dimension constants for the TriFinger robot and object geometry helpers
(counterpart of ``leibnizgym_tpu/envs/trifinger/dims.py``; plain Python).
"""

from __future__ import annotations

import enum
import math
from typing import Tuple, Union


class TrifingerDimensions(enum.Enum):
    """Dimensions of the tri-finger robot system."""

    # cartesian position (3) + quaternion orientation (4)
    PoseDim = 7
    # linear velocity (3) + angular velocity (3)
    VelocityDim = 6
    # pose + velocity
    StateDim = 13
    # force (3) + torque (3)
    WrenchDim = 6
    # number of fingers
    NumFingers = 3
    # per-robot joint-space dims (3 fingers x 3 joints)
    JointPositionDim = 9
    JointVelocityDim = 9
    JointTorqueDim = 9
    # generalized coordinates of the fixed-base robot
    GeneralizedCoordinatesDim = 9
    GeneralizedVelocityDim = 9
    # free object dims
    ObjectPoseDim = 7
    ObjectVelocityDim = 6


# radius of the TriFinger arena (m); reference utils.py:54
ARENA_RADIUS = 0.195


class CuboidalObject:
    """Derived geometry for a cuboidal object.

    Attributes update automatically when ``size`` changes, so domain
    randomization over object size keeps derived fields consistent
    (reference utils.py:57-131).
    """

    radius_3d: float
    max_com_distance_to_center: float
    min_height: float
    max_height: float = 0.1

    def __init__(self, size: Union[float, Tuple[float, float, float]]):
        self._size = (size, size, size) if isinstance(size, float) else tuple(size)
        self.__compute()

    @property
    def size(self) -> Tuple[float, float, float]:
        return self._size

    @size.setter
    def size(self, size: Union[float, Tuple[float, float, float]]):
        self._size = (size, size, size) if isinstance(size, float) else tuple(size)
        self.__compute()

    def __compute(self):
        max_len = max(self._size)
        # half the body diagonal of the bounding cube
        self.radius_3d = max_len * math.sqrt(3) / 2
        self.max_com_distance_to_center = ARENA_RADIUS - self.radius_3d
        self.min_height = self._size[2] / 2


class SphereObject:
    """Derived geometry for a spherical object (ball.urdf variant,
    reference resources/assets/trifinger/objects/urdf/ball.urdf: radius
    0.0375 m). Mirrors the CuboidalObject surface; ``size`` is the
    bounding-box edge (the diameter)."""

    radius_3d: float
    max_com_distance_to_center: float
    min_height: float
    max_height: float = 0.1

    def __init__(self, size: Union[float, Tuple[float, float, float]]):
        self._size = (size, size, size) if isinstance(size, float) else tuple(size)
        self.__compute()

    @property
    def size(self) -> Tuple[float, float, float]:
        return self._size

    @size.setter
    def size(self, size: Union[float, Tuple[float, float, float]]):
        self._size = (size, size, size) if isinstance(size, float) else tuple(size)
        self.__compute()

    def __compute(self):
        # a sphere's circumscribed radius IS its radius
        self.radius_3d = max(self._size) / 2
        self.max_com_distance_to_center = ARENA_RADIUS - self.radius_3d
        self.min_height = self._size[2] / 2
