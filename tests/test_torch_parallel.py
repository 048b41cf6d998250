"""Data-parallel training of the port (``leibnizgym_tpu_torch/parallel/``,
``learning/ppo.py`` under a ``DataShard``) on the CPU: gloo processes spawned
by ``parallel.launch``, each rank a fresh ``python`` with
``OMP_NUM_THREADS=1`` and a file rendezvous in a temporary directory.

- The shard helpers: ``shard_batch`` keeps the rank's rows of row-major
  leaves and columns of component-major ``*_cm`` leaves; a world that does
  not divide N is an error.
- Two ranks against one, on the same seed and global N (8 envs, horizon 4,
  2 substeps, the D1 preset): the trajectory (obs, states, actions, means,
  rewards, dones, values), every epoch's scalar metrics and the per-env
  finished-episode vectors and ``lr`` agree at rtol 1e-5, with an absolute
  floor of 1e-5 of each tensor's largest magnitude (an element near 0 has
  no scale of its own): the ranks' matmuls run on 4 rows where the single
  process runs on 8, so they round differently. The parameters agree at
  rtol 1e-5 and atol 1e-5: Adam moves an element by ``lr * m / (sqrt(v) +
  eps)``, about ``lr`` (3e-4 here) whatever the gradient's size, so where a
  gradient is near its rounding level the two runs' steps differ by a share
  of ``lr`` (measured up to 5.7e-6 over 2 epochs). Both ranks' learners are
  bit-identical. Both minibatch
  layouts: time-sliced (the D1 preset's: one timestep row of all envs per
  minibatch) and the rl_games global shuffle (3 minibatches of 10 samples,
  which do not divide the horizon).
- Four ranks against one, the same criteria, in both layouts.
- The collectives of an epoch: the time-sliced layout issues no all-gather
  and exactly one all-reduce per actor-critic step and per central-value
  step, two for the advantages and one for the metrics; the global
  layout adds one all-gather.
- Against the JAX package: the port's 2-rank epoch, fed a recorded
  trajectory and the reference's draws, against the reference's
  ``train_iteration`` on a 2-device data mesh (``shard_batch_pytree``), with
  ``test_torch_ppo_update.py::test_update_matches_reference``'s tolerances;
  the same ranks then run the epoch as the graph bodies of
  ``learning/graphs.py`` under ``CaptureGuard``, held to the reference
  alike and bitwise to their eager epoch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from leibnizgym_tpu.learning import ppo as jppo
from leibnizgym_tpu.parallel.mesh import shard_batch_pytree
from leibnizgym_tpu_torch.convert import (
    adam_state_from_jax,
    flax_params_to_state_dict,
    train_state_from_jax,
)
from leibnizgym_tpu_torch.learning import ppo as tppo
from leibnizgym_tpu_torch.parallel.launch import launch
from leibnizgym_tpu_torch.parallel.mesh import DataShard, shard_batch
import test_torch_ppo_update as upd
import torch_parallel_workers as workers
from test_torch_common import max_diff

torch.set_num_threads(1)
TESTS = workers.__file__.rsplit("/", 1)[0]
N, EPOCHS = 8, 2
LAYOUTS = {
    "time_sliced": {},  # minibatch = N: num_mb = 4 divides the horizon
    "global_shuffle": {"minibatch_size": 10, "cv_minibatch_size": 10},  # num_mb = 3
}


def test_shard_batch_takes_rows_and_component_major_columns():
    shard = DataShard(rank=1, world=2, n_global=8)
    assert (shard.n_local, shard.lo, shard.hi) == (4, 4, 8)
    rows = torch.arange(8 * 3).reshape(8, 3)
    cm = torch.arange(7 * 8).reshape(7, 8)
    tree = {"rows": rows, "cm": (cm, None), "scalar": torch.tensor(2.0), "n": 5}
    out = shard_batch(tree, shard)
    assert torch.equal(out["rows"], rows[4:]) and torch.equal(out["cm"][0], cm[:, 4:])
    assert out["cm"][1] is None and out["n"] == 5 and out["scalar"].shape == ()
    assert shard_batch(tree, None) is tree
    with pytest.raises(ValueError, match="multiple of the world size"):
        DataShard(rank=0, world=3, n_global=8)


@pytest.fixture(scope="module")
def runs():
    return {}


def _runs(runs, layout, world=2):
    """(the 1-rank run, the ``world`` ranks' runs) of ``layout``, each run
    once per module."""
    if layout not in runs:
        runs[layout] = workers.train_epochs(N, EPOCHS, LAYOUTS[layout])
    if (layout, world) not in runs:
        runs[layout, world] = launch(
            "torch_parallel_workers:train_epochs", world,
            dict(num_envs=N, epochs=EPOCHS, agent=LAYOUTS[layout], shard=True),
            pythonpath=[TESTS], timeout=120)
    return runs[layout], runs[layout, world]


def _close(ours, ref, what, atol=None):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    if atol is None:
        atol = 1e-5 * (np.abs(ref).max() if ref.size else 0.0)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=atol, err_msg=what)


def _hold_ranks_equal_one_rank(layout, one, world_runs):
    cfg = tppo.PPOConfig.from_rlg_params(workers.d1_config(N, LAYOUTS[layout])["rlg"]["params"], N)
    assert tppo.minibatch_layout(True, 4, N, cfg.minibatch_size)[2] == (layout == "time_sliced")
    for e in range(EPOCHS):
        ref, ranks = one["epochs"][e], [r["epochs"][e] for r in world_runs]
        for k, v in ref["traj"].items():
            _close(torch.cat([r["traj"][k] for r in ranks], dim=1), v, f"epoch {e} traj {k}")
        for r in ranks:
            assert set(r["scalars"]) == set(ref["scalars"])
            for k, v in ref["scalars"].items():
                _close(r["scalars"][k], v, f"epoch {e} {k}")
            assert torch.equal(r["finished_n"], ref["finished_n"])
            _close(r["finished_returns"], ref["finished_returns"], "finished_returns")
            assert r["mb_steps"] == ref["mb_steps"]
    assert ref["finished_n"].sum() >= 0 and ranks[0]["scalars"]["info/frames"] == EPOCHS * 4 * N
    for k, v in one["learner"].items():
        for r in world_runs[1:]:
            assert torch.equal(world_runs[0]["learner"][k], r["learner"][k]), k
        _close(world_runs[0]["learner"][k], v, k, atol=1e-5)
    assert all(r["lr"] == world_runs[0]["lr"] for r in world_runs)
    _close(world_runs[0]["lr"], one["lr"], "lr")


def _hold_collectives(layout, world_runs):
    cfg = tppo.PPOConfig.from_rlg_params(workers.d1_config(N, LAYOUTS[layout])["rlg"]["params"], N)
    num_mb = tppo.minibatch_layout(True, 4, N, cfg.minibatch_size)[0]
    cv_mb = tppo.minibatch_layout(True, 4, N, cfg.cv_minibatch_size)[0]
    steps = cfg.mini_epochs * num_mb + cfg.cv_mini_epochs * cv_mb
    for r in world_runs:
        for e in r["epochs"]:
            # one packed all-reduce per minibatch step, 2 advantage sums, 1 metrics
            assert e["counts"].get("all_reduce") == steps + 2 + 1, e["counts"]
            assert e["counts"].get("all_gather", 0) == (layout == "global_shuffle"), e["counts"]
            assert "broadcast" not in e["counts"]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_two_ranks_equal_one_rank(layout, runs):
    _hold_ranks_equal_one_rank(layout, *_runs(runs, layout))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_collectives_per_epoch(layout, runs):
    _hold_collectives(layout, _runs(runs, layout)[1])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_four_ranks_equal_one_rank(layout, runs):
    """Four ranks of 2 envs each against one rank of 8: the same criteria
    and collective counts as two ranks (a fault that grows with the world
    size shows here and not at W = 2)."""
    one, four = _runs(runs, layout, world=4)
    _hold_ranks_equal_one_rank(layout, one, four)
    _hold_collectives(layout, four)


# ---------------------------------------------------------------------------
# Against the reference's train_iteration on a 2-device data mesh
# ---------------------------------------------------------------------------

JAX_CASES = {
    "time_sliced_cv": dict(minibatch_size=128, cv_minibatch_size=256, kl_threshold=0.008),
    "flat_cv_frames2": dict(minibatch_size=96, cv_minibatch_size=48, frames=2, clip_value=True,
                            entropy_coef=0.01, grad_norm=100.0, kl_threshold=0.002),
}


def _hold_params(ref_tree, ours, total_steps, lr_max):
    """test_torch_ppo_update.py's bound: Adam moves each element by about
    lr a step, so a gradient at rounding level may flip one step's sign."""
    ref = flax_params_to_state_dict(ref_tree)
    for name, p in ours.items():
        d = np.abs(p.numpy() - ref[name].numpy())
        assert d.max() <= 2 * lr_max * total_steps, (name, d.max())
        assert np.mean(d <= 1e-5) >= 0.999, (name, np.mean(d <= 1e-5))


def _hold_adam(ref_opt, ours):
    ref = adam_state_from_jax(ref_opt)
    assert ours["count"] == ref["count"]
    for key in ("mu", "nu"):
        for name, m in ours[key].items():
            r = ref[key][name].numpy()
            assert np.abs(m.numpy() - r).max() <= 1e-5 * np.abs(r).max() + 1e-12, (key, name)


@pytest.fixture(scope="module")
def mesh_runs():
    return {}


def _mesh_run(mesh_runs, case):
    """(port config, the reference's train state and metrics after its
    epoch on a 2-device mesh, each rank's epochs by mode), once per case:
    the ranks run the epoch eagerly and as the graph bodies under
    ``CaptureGuard``, both from the converted learner."""
    if case in mesh_runs:
        return mesh_runs[case]
    n, h = 64, 8
    static = upd.Static(n, upd.OBS, upd.STATES, upd.ACT, True)
    jcfg = jppo.PPOConfig(horizon=h, mini_epochs=2, cv_mini_epochs=3, units=upd.UNITS,
                          fused_rollout=False, **JAX_CASES[case])
    tcfg = upd.port_config(jcfg)
    table = upd._recorded(n, h, static.state_dim, seed=11)

    jts = upd._jax_train_state(jcfg, static, table, seed=5)
    noise, perms = upd.reference_draws(tcfg, jts.key, n, h, True)
    mesh = Mesh(np.asarray(jax.devices()[:2]), axis_names=("data",))
    data = NamedSharding(mesh, P("data"))
    sharded = jts.replace(
        env_state=shard_batch_pytree(jts.env_state, mesh, n),
        obs=jax.device_put(jts.obs, data), states=jax.device_put(jts.states, data),
        ep_return=jax.device_put(jts.ep_return, data), ep_len=jax.device_put(jts.ep_len, data))
    assert len(sharded.obs.sharding.device_set) == 2
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jppo, "env_step", upd._jax_stub(table))
        new_jts, jm = jax.jit(lambda ts: jppo.train_iteration(jcfg, static, None, ts))(sharded)
    jts, new_jts, jm = jax.device_get((jts, new_jts, jm))

    tts = train_state_from_jax(jts, tcfg, static, env_state=upd.TorchStubState(
        0, torch.zeros(n, dtype=torch.bool), torch.zeros(n, dtype=torch.int32)))
    learner = {
        "ac": tts.actor_critic.state_dict(), "cv": tts.central_value.state_dict(),
        "ac_opt": tts.ac_opt.state_dict(), "cv_opt": tts.cv_opt.state_dict(),
        "lr": tts.lr, "epoch": tts.epoch, "frame": tts.frame,
        "carry": {k: getattr(tts.carry, k) for k in ("obs", "states", "ep_return", "ep_len")},
    }
    cfg = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    out = launch("torch_parallel_workers:stub_update", 2, dict(
        cfg=cfg, static=dataclasses.asdict(static), learner=learner,
        table={k: torch.as_tensor(v) for k, v in table.items() if k != "obs0"},
        noise=noise, perms=perms, modes=("eager", "graphed")), pythonpath=[TESTS], timeout=120)
    mesh_runs[case] = (tcfg, new_jts, jm, out)
    return mesh_runs[case]


def _hold_reference(tcfg, new_jts, jm, out, mode):
    out = [r[mode] for r in out]
    for r in out:
        tm = r["metrics"]
        assert set(tm) == set(jm)
        for k in ("losses/total", "losses/a_loss", "losses/c_loss", "losses/entropy",
                  "losses/cv_loss", "info/kl", "info/lr", "rewards/step_mean",
                  "episodes/finished_return_sum", "episodes/finished_success_sum",
                  "env/action_mean"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        for k in ("info/epochs", "info/frames", "episodes/finished_count", "env/step"):
            assert float(tm[k]) == float(jm[k]), k
        np.testing.assert_array_equal(tm["episodes/finished_n"].numpy(),
                                      jm["episodes/finished_n"])
        assert max_diff(jm["episodes/finished_returns"], tm["episodes/finished_returns"]) < 1e-3
        thr = tcfg.kl_threshold
        for kl, _ in r["steps"]:  # every step took the reference's lr branch
            assert not (0.49 * thr < kl < 0.51 * thr or 1.96 * thr < kl < 2.04 * thr), (kl, thr)
        lr_max = max([tcfg.learning_rate] + [lr for _, lr in r["steps"]])
        _hold_params(new_jts.ac_params, r["ac"], len(r["steps"]), lr_max)
        _hold_params(new_jts.cv_params, r["cv"], r["opts"]["cv"]["count"], lr_max)
        _hold_adam(new_jts.ac_opt_state, r["opts"]["ac"])
        _hold_adam(new_jts.cv_opt_state, r["opts"]["cv"])
        assert r["epoch"] == int(new_jts.epoch) and r["frame"] == int(new_jts.frame)
    for k in out[0]["ac"]:  # a replicated learner
        assert torch.equal(out[0]["ac"][k], out[1]["ac"][k]), k
    for name in ("obs", "states", "ep_return", "ep_len"):
        ours = torch.cat([r["carry"][name] for r in out])
        assert max_diff(getattr(new_jts, name), ours) < 1e-3, name


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_two_rank_update_matches_reference_on_data_mesh(case, mesh_runs):
    _hold_reference(*_mesh_run(mesh_runs, case), "eager")


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_two_rank_graph_bodies_match_reference_on_data_mesh(case, mesh_runs):
    """The two ranks' epoch as the graph bodies of ``learning/graphs.py``
    under ``CaptureGuard`` (fed the same draws, as the graphed epoch is):
    held to the reference on its 2-device mesh as the eager epoch is above,
    and bitwise equal to the eager epoch on each rank, metrics, steps,
    learner, optimizer states and carry."""
    tcfg, new_jts, jm, out = _mesh_run(mesh_runs, case)
    _hold_reference(tcfg, new_jts, jm, out, "graphed")
    for r in out:
        eager, graphed = r["eager"], r["graphed"]
        assert eager["steps"] == graphed["steps"]
        assert set(eager["metrics"]) == set(graphed["metrics"])
        for k, v in eager["metrics"].items():
            assert torch.equal(v, graphed["metrics"][k]) if torch.is_tensor(v) \
                else v == graphed["metrics"][k], k
        for part in ("ac", "cv", "carry"):
            for k, v in eager[part].items():
                assert torch.equal(v, graphed[part][k]), (part, k)
        for net in ("ac", "cv"):
            e_opt, g_opt = eager["opts"][net], graphed["opts"][net]
            assert torch.equal(torch.as_tensor(e_opt["count"]), torch.as_tensor(g_opt["count"]))
            for key in ("mu", "nu"):
                for k, v in e_opt[key].items():
                    assert torch.equal(v, g_opt[key][k]), (net, key, k)
        assert (eager["epoch"], eager["frame"]) == (graphed["epoch"], graphed["frame"])
