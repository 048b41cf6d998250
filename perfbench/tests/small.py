"""Cells of ``BENCHMARK.json`` cut to a size the CPU tests can run: 32 envs,
one physics substep, 4 steps an epoch, 2 + 2 mini-epochs of one time step
of every env, 19-step episodes (so that the first epoch of the window, the
fifth, holds the time-outs and the resets the check replays); the traffic's
windows and checks cut to match. The harness and its drivers run them
unchanged, on ``device="cpu"``.

Not 8 envs: with minibatches of 8 rows Adam's first, sign-like step carries
float32 rounding of gradients near zero into the next step's losses at up
to 3e-5 (a central-value loss, D4 + DR, one seed in a few), above the
training cells' limits; at 32 rows and at the cells' 8192 it stays within
~1e-6."""

from __future__ import annotations

import copy
import time

from perfbench import harness

TRAFFIC = dict(num_envs=32, rollout_check_rows=4, min_window_epochs=2, check_epochs=2,
               profile_epochs=1)
EPISODE_LENGTH = 19


def small_cell(name: str) -> harness.Cell:
    bench = harness.load_json(f"{harness.ROOT}/BENCHMARK.json")
    cell = harness.resolve(bench, name)
    cfg = copy.deepcopy(cell.config)
    cfg["gym"]["sim"]["substeps"] = 1
    cfg["gym"]["episode_length"] = EPISODE_LENGTH
    c = cfg["rlg_params"]["config"]
    c.update(steps_num=4, mini_epochs=2, minibatch_size=32)
    c["central_value_config"].update(mini_epochs=2, minibatch_size=32)
    cell.config = cfg
    cell.traffic = dict(cell.traffic, **{k: v for k, v in TRAFFIC.items() if k in cell.traffic})
    return cell


def run_small(name: str, seed: int = 7, trace: bool = False) -> dict:
    """A whole run of the cut cell but the look for a chip: set-up, window,
    the check against the reference."""
    return harness.run_cell(small_cell(name), seed, 0.2, trace, "cpu",
                            time.perf_counter())
