"""The port's viewer (``utils/viewer.py``), ``render()`` and the offline GIF
renderer (``scripts/replay_viewer.py``) on the CPU with matplotlib's Agg
backend.

- ``extract_frame`` against the JAX package's on one env state (a JAX reset
  with joint angles, cube pose and goal moved off their defaults),
  converted with ``convert.env_state_from_jax``: within 1e-6 (the tips come
  from the port's scalar forward kinematics, the reference's from its
  einsum one; both float32).
- ``draw_frame`` draws the same lines and markers as the JAX package's on
  the same frame dict: every line's and every scatter's data within 1e-6,
  the same titles and limits.
- ``LiveViewer`` refuses the Agg backend with the reference's message.
- ``render()``: with ``visualize=False`` one warning, once; with
  ``visualize=True`` where no window can open, one warning and rendering
  off, while the env steps on.
- ``Runner(visualize=True).play`` runs 3 steps (rendering off after its
  warning).
- ``replay_viewer.py`` writes a GIF of 4 envs x 10 steps from random actions
  and from the shipped ``d4_best_curriculum.npz``, and refuses a checkpoint
  whose input width the env does not feed with the reference's message.
"""

import copy
import os

import matplotlib

matplotlib.use("Agg")

import jax  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from leibnizgym_tpu.envs.trifinger import env as jenv  # noqa: E402
from leibnizgym_tpu.utils import viewer as jviewer  # noqa: E402
from leibnizgym_tpu_torch.convert import env_state_from_jax  # noqa: E402
from leibnizgym_tpu_torch.envs.trifinger.env import TrifingerEnv  # noqa: E402
from leibnizgym_tpu_torch.learning.runner import Runner  # noqa: E402
from leibnizgym_tpu_torch.scripts import replay_viewer  # noqa: E402
from leibnizgym_tpu_torch.utils import viewer  # noqa: E402
import torch_parallel_workers as workers  # noqa: E402

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICY = os.path.join(ROOT, "leibnizgym_tpu_torch", "resources", "policies",
                      "d4_best_curriculum.npz")
CFG = {"num_instances": 4, "command_mode": "torque", "sim": {"substeps": 2}}


@pytest.fixture(scope="module")
def jax_state():
    je = jenv.TrifingerEnv(config=dict(CFG, engine="soa"), verbose=False)
    state, _ = jenv.env_reset(je.static, je.params, jax.random.PRNGKey(3))
    state = jax.device_get(state)
    rng = np.random.default_rng(0)
    quat = rng.normal(size=(4, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    physics = state.physics.replace(
        q=rng.uniform(-0.8, 0.8, (4, 9)).astype(np.float32),
        cube_pos=rng.uniform(-0.1, 0.1, (4, 3)).astype(np.float32),
        cube_quat=quat)
    goal = np.array(state.goal_pose_cm)
    goal[3:7] = quat[::-1].T
    return state.replace(physics=physics, goal_pose_cm=goal)


@pytest.mark.parametrize("env_index", [0, 3])
def test_extract_frame_matches_reference(jax_state, env_index):
    ref = jviewer.extract_frame(jax_state, env_index)
    ours = viewer.extract_frame(env_state_from_jax(jax_state), env_index)
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].shape == np.asarray(ref[k]).shape, k
        np.testing.assert_allclose(ours[k], np.asarray(ref[k]), rtol=0, atol=1e-6, err_msg=k)


def _drawn(draw, frame):
    fig, (top, side) = plt.subplots(1, 2)
    draw(top, side, frame, 0.0325)
    out = []
    for ax in (top, side):
        out.append((ax.get_title(), ax.get_xlim(), ax.get_ylim(),
                    [np.asarray(line.get_xydata()) for line in ax.get_lines()],
                    [np.asarray(c.get_offsets()) for c in ax.collections],
                    len(ax.patches)))
    plt.close(fig)
    return out


def test_draw_frame_matches_reference(jax_state):
    frame = jviewer.extract_frame(jax_state, 1)
    frame = {k: np.asarray(v) for k, v in frame.items()}
    ours, ref = _drawn(viewer.draw_frame, frame), _drawn(jviewer.draw_frame, frame)
    for (t, xl, yl, lines, dots, patches), (rt, rxl, ryl, rlines, rdots, rpatches) in zip(ours, ref):
        assert (t, xl, yl, patches) == (rt, rxl, ryl, rpatches)
        assert len(lines) == len(rlines) > 0 and len(dots) == len(rdots) > 0
        for a, b in zip(lines + dots, rlines + rdots):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_live_viewer_refuses_agg():
    with pytest.raises(RuntimeError, match="Agg backend cannot open an interactive window"):
        viewer.LiveViewer()


def test_render_warns_once_and_turns_off_without_a_window(capsys):
    env = TrifingerEnv(config=CFG, device="cpu", verbose=False)
    env.reset()
    env.render()
    env.render()
    assert capsys.readouterr().out.count("render() called with visualize=False") == 1
    env = TrifingerEnv(config=CFG, device="cpu", verbose=False, visualize=True)
    env.reset()
    env.render()
    out = capsys.readouterr().out
    assert "live viewer unavailable" in out and "rendering off" in out
    env.render()
    assert capsys.readouterr().out == ""
    obs, *_ = env.step(torch.zeros(4, 9))  # the env itself is untouched
    assert bool(torch.isfinite(obs).all()) and env.visualize


def test_runner_visualize_plays(tmp_path, capsys):
    cfg = workers.d1_config(4, {})
    runner = Runner(copy.deepcopy(cfg["gym"]), cfg["rlg"]["params"], logdir=str(tmp_path),
                    seed=0, device="cpu", visualize=True)
    assert runner.env.visualize
    reward = runner.play(num_steps=3)
    assert np.isfinite(reward)
    assert capsys.readouterr().out.count("live viewer unavailable") == 1


@pytest.mark.parametrize("source", ["random", "npz"])
def test_replay_viewer_writes_gif(source, tmp_path):
    from PIL import Image

    out = str(tmp_path / "replay.gif")
    argv = ["--device", "cpu", "--steps", "10", "--num-envs", "4", "--out", out, "--stride", "1"]
    if source == "npz":
        argv += ["--gym", "trifinger_difficulty_4_curriculum", "--checkpoint", POLICY,
                 "--env-index", "2"]
    frames = replay_viewer.main(argv)
    assert len(frames) == 10
    for f in frames:
        assert f["tips"].shape == (3, 3) and f["cube_rot"].shape == (3, 3)
        assert f["goal"].shape == (7,) and all(np.isfinite(v).all() for v in f.values())
    with Image.open(out) as gif:
        assert gif.n_frames == 10 and gif.size[0] > 0


def test_replay_viewer_refuses_wrong_obs_width(tmp_path):
    with pytest.raises(SystemExit, match="consumes 89-dim observations but the env would feed 41"):
        replay_viewer.main(["--device", "cpu", "--steps", "1", "--checkpoint", POLICY,
                            "--out", str(tmp_path / "x.gif")])
