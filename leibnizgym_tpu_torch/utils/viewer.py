"""Live viewer of TriFinger scenes (counterpart of
``leibnizgym_tpu/utils/viewer.py``).

The reference uses the IsaacGym OpenGL viewer with ESC (quit) / V (toggle
render sync) keyboard events (reference env_base.py:403-427, 599-612). The
port renders on the host from the ``EnvState`` with matplotlib in
interactive mode:

- ESC closes the viewer and stops rendering (the reference's QUIT action);
- V toggles drawing on and off while stepping continues
  (``toggle_viewer_sync``).

``extract_frame`` takes one env's scene off the device in one copy; the same
``draw_frame`` backs the offline GIF renderer (``scripts/replay_viewer.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from leibnizgym_tpu_torch.models import trifinger as tf_model

_CORNER_SIGNS = np.array(
    [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
    dtype=np.float64,
)
# cube wireframe: corner pairs whose sign vectors differ in exactly one axis
_EDGES = [
    (i, j)
    for i in range(8)
    for j in range(i + 1, 8)
    if int(np.sum(_CORNER_SIGNS[i] != _CORNER_SIGNS[j])) == 1
]


def _np_quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """(x, y, z, w) quaternion to rotation matrix (numpy, host-side)."""
    x, y, z, w = (float(v) for v in q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _draw_wirecube(ax, pos, rot, half, xi: int, zi: int, **line_kw):
    """Project a cube wireframe onto axes (xi, zi) of the world frame."""
    corners = pos[None, :] + (_CORNER_SIGNS * half) @ rot.T
    for i, j in _EDGES:
        ax.plot(
            [corners[i, xi], corners[j, xi]],
            [corners[i, zi], corners[j, zi]],
            **line_kw,
        )


def _quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(x, y, z, w) quaternion (4,) to a rotation matrix (3, 3), the
    reference's ``utils/math.py`` ``quat_to_matrix`` formula by formula."""
    x, y, z, w = q[0], q[1], q[2], q[3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    ]).reshape(3, 3)


def extract_frame(state, env_index: int = 0) -> dict:
    """One env's drawable scene (tips (3, 3) by forward kinematics, cube
    position and rotation, goal pose (7,)) as numpy arrays, in one
    device-to-host copy."""
    from leibnizgym_tpu_torch.ops.engine_v2 import fingertip_components_v2

    physics = state.physics
    i = slice(env_index, env_index + 1)
    tips = fingertip_components_v2(tuple(physics.q[i, k] for k in range(9)),
                                   tuple(physics.qd[i, k] for k in range(9)))
    flat = torch.cat([
        torch.stack([c for tip in tips for c in tip[0]]).reshape(-1),
        physics.cube_pos[env_index],
        _quat_to_matrix(physics.cube_quat[env_index]).reshape(-1),
        state.goal_pose_cm[:, env_index],
    ]).cpu().numpy()
    return dict(tips=flat[:9].reshape(3, 3), cube_pos=flat[9:12],
                cube_rot=flat[12:21].reshape(3, 3), goal=flat[21:])


def draw_frame(ax_top, ax_side, f: dict, half: float):
    """Draw one frame onto (top view, side view) axes."""
    import matplotlib.patches as patches

    for ax in (ax_top, ax_side):
        ax.clear()
        ax.set_aspect("equal")
    r = tf_model.WALL_INNER_RADIUS
    ax_top.add_patch(patches.Circle((0, 0), r, fill=False, color="gray"))
    goal = f["goal"]
    # goal orientation wireframe (dashed) makes 6-DoF reposing (difficulty 4)
    # visually checkable: a position star alone cannot show orientation match
    goal_rot = (
        _np_quat_to_matrix(goal[3:7]) if goal.shape[0] >= 7 else np.eye(3)
    )
    for ax, xi, zi in ((ax_top, 0, 1), (ax_side, 0, 2)):
        _draw_wirecube(ax, goal[:3], goal_rot, half, xi, zi,
                       color="tab:green", lw=1.0, ls="--", alpha=0.9)
        _draw_wirecube(ax, f["cube_pos"], f["cube_rot"], half, xi, zi,
                       color="tab:orange", lw=1.2)
    ax_top.scatter(*f["cube_pos"][:2], s=25, c="tab:red", label="cube")
    ax_top.scatter(*goal[:2], s=40, marker="*", c="tab:green", label="goal")
    ax_top.scatter(f["tips"][:, 0], f["tips"][:, 1], s=30, c="tab:blue", label="tips")
    ax_top.set_xlim(-0.25, 0.25)
    ax_top.set_ylim(-0.25, 0.25)
    ax_top.set_title("top view")
    ax_top.legend(loc="upper right", fontsize=6)
    ax_side.axhline(0, color="gray", lw=1)
    ax_side.scatter(f["cube_pos"][0], f["cube_pos"][2], s=25, c="tab:red")
    ax_side.scatter(goal[0], goal[2], s=40, marker="*", c="tab:green")
    ax_side.scatter(f["tips"][:, 0], f["tips"][:, 2], s=30, c="tab:blue")
    ax_side.set_xlim(-0.25, 0.25)
    ax_side.set_ylim(-0.02, 0.35)
    ax_side.set_title("side view")


class LiveViewer:
    """Interactive matplotlib viewer with the reference's key bindings."""

    def __init__(self, half_extent: float | None = None, env_index: int = 0,
                 title: str = "leibnizgym_tpu_torch"):
        import matplotlib
        import matplotlib.pyplot as plt

        if matplotlib.get_backend().lower() == "agg":
            raise RuntimeError(
                "matplotlib Agg backend cannot open an interactive window "
                "(no display?). Use leibnizgym_tpu_torch/scripts/replay_viewer.py for "
                "offline rendering."
            )
        self._plt = plt
        self.env_index = env_index
        self.half = float(half_extent or tf_model.CUBE_SIZE / 2)
        self.enabled = True   # V toggles
        self.closed = False   # ESC / window close
        plt.ion()
        self.fig, (self.ax_top, self.ax_side) = plt.subplots(
            1, 2, figsize=(8, 4), num=title
        )
        self.fig.canvas.mpl_connect("key_press_event", self._on_key)
        self.fig.canvas.mpl_connect("close_event", self._on_close)

    def _on_key(self, event):
        if event.key == "escape":
            self.closed = True
            self._plt.close(self.fig)
        elif event.key in ("v", "V"):
            self.enabled = not self.enabled

    def _on_close(self, _event):
        self.closed = True

    def update(self, state) -> bool:
        """Draw the current EnvState. Returns False once the viewer is
        closed (callers stop rendering, reference env_base.py:409)."""
        if self.closed:
            return False
        if self.enabled:
            draw_frame(
                self.ax_top, self.ax_side,
                extract_frame(state, self.env_index), self.half,
            )
            self.fig.canvas.draw_idle()
        # flush GUI events even when drawing is toggled off so the key
        # bindings stay responsive (reference render(): poll events always)
        self.fig.canvas.flush_events()
        self._plt.pause(0.001)
        return not self.closed
