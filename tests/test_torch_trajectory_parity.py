"""Port parity: ``scripts/trajectory_parity.py`` of the port against the
repo's JAX one.

The JAX dump is tests/golden/traj_d1_seed0_cone.npz, written by the JAX
script (``dump``: D1, torque, 16 envs, 2 substeps, 4 TGS iterations, the
cone arena), cut to its first 10 steps (the JAX env itself takes ~70 s to
compile and run here). The port's ``dump`` replays that rollout at 16 envs
x 10 steps on the CPU, through the plain physics step, with the JAX env's
reset and goal draws and the JAX script's action stream injected (the key
splits of ``TrifingerEnv.reset``, ``env_step`` and the script's action
loop). ``--engine reference`` is compared the same way, at 4 envs x 4
steps, with a JAX dump the JAX script writes in the test through the JAX
package's reference engine. Through the port's ``compare``:

- q, cube_pos, cube_quat, obs and action within 2e-4, the goldens' own
  bound (tests/test_golden_trajectory.py:64-69);
- qd, cube_linvel and cube_angvel, which the goldens do not bound, within
  1e-3: the contact solve amplifies float32 rounding most in the cube's
  angular velocity (its inverse inertia is ~1.8e4; chip_smoke.KERNEL_TOL),
  measured 2.7e-4 at step 9 here;
- the reward within 2e-3: the recorded float32 rewards carry their own
  rounding, up to 1.1e-3 from the same formulas evaluated in float64 on the
  same states (the rate terms weigh a difference of tip distances by 750;
  tests/test_torch_golden.py), and the port's float32 reward differs from
  XLA's by up to 5.7e-4 here, so 2e-4 holds only for a replay that rounds
  exactly as XLA did.

Both ``compare``s return the same 0 / 1 / 2 on the same file pairs.
"""

import argparse
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from leibnizgym_tpu_torch.scripts import trajectory_parity as ttp

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "traj_d1_seed0_cone.npz")
N, T = 16, 10
TOL = 2e-4
# compare at each tolerance on the fields it bounds (the docstring says why)
GROUPS = {"pose": (("q", "cube_pos", "cube_quat", "obs", "action"), TOL),
          "velocity": (("qd", "cube_linvel", "cube_angvel"), 1e-3),
          "reward": (("reward",), 2e-3)}
REWARD_TOL = GROUPS["reward"][1]


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "_jax_trajectory_parity", os.path.join(ROOT, "scripts", "trajectory_parity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _save(path, meta, arrays):
    np.savez_compressed(path, meta=json.dumps(meta), **arrays)
    return path


def _dump_args(out, **kw):
    args = dict(num_envs=N, steps=T, seed=0, action_seed=1, difficulty=1, engine="soa",
                solver="tgs", substeps=2, iterations=4, arena=None, device="cpu", out=str(out))
    args.update(kw)
    return argparse.Namespace(**args)


def _reference_draws(seed: int, action_seed: int, n: int, steps: int):
    """The JAX env's reset / step draws and the JAX script's actions."""
    sub = jax.random.split(jax.random.PRNGKey(seed))[1]
    key, k_init = jax.random.split(sub)
    t = lambda x: torch.as_tensor(np.array(x))  # noqa: E731
    reset = (t(jax.random.uniform(k_init, (n, 25))), None, None, None)
    steps_draws, actions = [], []
    akey = jax.random.PRNGKey(action_seed)
    for _ in range(steps):
        key, k_reset, k_goal = jax.random.split(key, 3)
        steps_draws.append((t(jax.random.uniform(k_reset, (n, 25))), None,
                            t(jax.random.uniform(k_goal, (n, 25))), None, None, None))
        akey, k = jax.random.split(akey)
        actions.append(t(jax.random.uniform(k, (n, 9), minval=-1.0, maxval=1.0)))
    return actions, (reset, steps_draws)


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """(jax dump, port dump) of the same rollout."""
    d = tmp_path_factory.mktemp("traj")
    golden = np.load(GOLDEN, allow_pickle=True)
    meta = dict(json.loads(str(golden["meta"])), steps=T)
    assert meta["num_envs"] == N
    jax_dump = _save(d / "jax.npz", meta,
                     {k: golden[k][:T] for k in golden.files if k != "meta"})
    actions, draws = _reference_draws(meta["seed"], meta["action_seed"], N, T)
    ours = ttp.dump(_dump_args(d / "torch.npz", arena=meta["arena"]), actions, draws)
    assert ours["framework"] == "leibnizgym_tpu_torch" and ours["device"] == "cpu"
    return jax_dump, d / "torch.npz"


def test_port_dump_matches_jax_dump(dumps, tmp_path, capsys):
    ja, to = dumps
    a, b = np.load(ja, allow_pickle=True), np.load(to, allow_pickle=True)
    assert sorted(a.files) == sorted(b.files)
    meta_a, meta_b = json.loads(str(a["meta"])), json.loads(str(b["meta"]))
    assert {k: v for k, v in meta_b.items() if k not in ("framework", "device")} == \
        {k: v for k, v in meta_a.items() if k != "framework"}
    for k in ttp.FIELDS:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    # the rollout is not vacuous: the fingers moved
    assert float(np.abs(b["q"][-1] - b["q"][0]).max()) > 1e-2
    # compare reads the fields the two files share: one pair per group
    assert sorted(k for keys, _ in GROUPS.values() for k in keys) == sorted(ttp.FIELDS)
    for name, (keys, tol) in GROUPS.items():
        pair = [_save(tmp_path / f"{name}_{i}.npz", json.loads(str(x["meta"])),
                      {k: x[k] for k in keys}) for i, x in enumerate((a, b))]
        rc = ttp.compare(argparse.Namespace(file_a=str(pair[0]), file_b=str(pair[1]), tol=tol))
        out = capsys.readouterr().out
        assert rc == 0 and "verdict: PARITY" in out, out


def test_compare_codes_match_reference(dumps, tmp_path):
    """0 / 1 / 2 on the same pairs: parity at 2e-3, a divergence at a
    tolerance of 0, and dumps of different env counts."""
    ja, to = dumps
    small = tmp_path / "small.npz"
    ttp.dump(_dump_args(small, num_envs=4, steps=2))
    ref = _jax_script()
    for a, b, tol, code in ((ja, to, REWARD_TOL, 0), (ja, to, 0.0, 1), (ja, small, TOL, 2),
                            (to, to, 0.0, 0)):
        args = argparse.Namespace(file_a=str(a), file_b=str(b), tol=tol)
        assert ttp.compare(args) == ref.compare(args) == code, (a, b, tol)
    assert ttp.main(["compare", str(ja), str(small)]) == 2


REF_N, REF_T = 4, 4


def test_reference_engine_dump_matches_jax_dump(tmp_path, capsys):
    """``--engine reference``: the JAX script's dump through the JAX
    package's reference engine (4 envs x 4 steps, written here) against the
    port's through ``ops/engine.py``, replayed from the same draws and
    actions; ``compare`` at each group's tolerance, as above."""
    ref = _jax_script()
    jax_out = tmp_path / "jax_reference.npz"
    ref.dump(argparse.Namespace(num_envs=REF_N, steps=REF_T, seed=0, action_seed=1,
                                difficulty=1, engine="reference", solver="tgs", substeps=2,
                                iterations=4, arena=None, out=str(jax_out)))
    a = np.load(jax_out, allow_pickle=True)
    meta_a = json.loads(str(a["meta"]))
    actions, draws = _reference_draws(0, 1, REF_N, REF_T)
    ours = ttp.dump(_dump_args(tmp_path / "torch_reference.npz", num_envs=REF_N, steps=REF_T,
                               engine="reference", arena=meta_a["arena"]), actions, draws)
    assert {k: v for k, v in ours.items() if k not in ("framework", "device")} == \
        {k: v for k, v in meta_a.items() if k != "framework"}
    b = np.load(tmp_path / "torch_reference.npz", allow_pickle=True)
    assert float(np.abs(b["q"][-1] - b["q"][0]).max()) > 1e-2
    capsys.readouterr()
    for name, (keys, tol) in GROUPS.items():
        pair = [_save(tmp_path / f"ref_{name}_{i}.npz", json.loads(str(x["meta"])),
                      {k: x[k] for k in keys}) for i, x in enumerate((a, b))]
        rc = ttp.compare(argparse.Namespace(file_a=str(pair[0]), file_b=str(pair[1]), tol=tol))
        out = capsys.readouterr().out
        assert rc == 0 and "verdict: PARITY" in out, out


def test_unknown_engine_is_refused(tmp_path):
    with pytest.raises(SystemExit) as exc:
        ttp.main(["dump", "--engine", "bogus", "--device", "cpu", "--out",
                  str(tmp_path / "x.npz")])
    assert exc.value.code == 2 and not (tmp_path / "x.npz").exists()
    with pytest.raises(ValueError, match="Invalid engine"):
        ttp.dump(_dump_args(tmp_path / "x.npz", engine="bogus"))


def test_seeded_dump_is_reproducible(tmp_path):
    """Without injected draws the port's own generators drive the rollout:
    the same seeds give the same dump, ``--engine pallas`` the same as soa."""
    a, b = tmp_path / "a.npz", tmp_path / "b.npz"
    assert ttp.main(["dump", "--device", "cpu", "--num-envs", "4", "--steps", "3",
                     "--out", str(a)]) == 0
    assert ttp.main(["dump", "--device", "cpu", "--num-envs", "4", "--steps", "3",
                     "--engine", "pallas", "--out", str(b)]) == 0
    assert ttp.main(["compare", str(a), str(b), "--tol", "0"]) == 0
