"""The readings that the limits of ``correct`` are set from (``perfbench/limits``),
on the chip, at a cell's own size:

    python3 perfbench/readings.py --workload <cell> --seeds 11,12,13 \\
        --control-seeds 3 --out chiprun_out/readings_<cell>.jsonl

For every seed, in one process, a sound run's numbers: the cell's set-up
(its checked epochs and the two that time an epoch), then its epochs
through the one the check replays, as a run's window drives them, then the
comparison with the reference, as a run makes it. Each row's gaps of both
rollouts are kept too (``rows``), sorted, to show where the quantile sits.
For the first ``--control-seeds`` seeds also:

- the control: the reference's update put in the program's place and
  computed in float32 with TF32 on, the precision under the
  configuration's (float32, TF32 off), on the card, compared with the
  reference as the program is (its rollouts are not run: the plain physics
  takes ~2 s a step on the card; the rollout numbers take their upper
  readings from the faults);
- the faults, planted in the reference put in the program's place: half of
  every minibatch left out (its mean taken over the rest), the parameters
  left as they were from the fourth step of each epoch on, and answers
  altered where they are produced (an observation component, an action
  component and the shaped rewards by ``ALTER``, a done flag of one row, a
  rollout whose env hands back the state it was given).

Each line of ``--out`` is one seed's JSON: ``{"seed", "sound", "rows",
"control", "faults": {name: numbers}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from perfbench import harness  # noqa: E402

ALTER = 1e-2  # the size of an altered answer, in the answer's own units


def _altered(stage: dict, key: str) -> dict:
    import torch

    if key == "frozen":  # every step observes the state the rollout started from
        return dict(stage, obs=stage["obs"][:1].expand_as(stage["obs"]))
    x = stage[key].double()
    if key in ("obs", "action"):
        x = x + ALTER * (torch.arange(x.shape[-1]) == 0)
    elif key == "reward":
        x = x * (1 + ALTER)
    else:  # "done": one row's flags
        x = torch.where(torch.arange(x.shape[1])[None, :] == 0, 1 - x, x)
    return dict(stage, **{key: x})


def train_readings(ctx, driver, control: bool) -> dict:
    """A training cell's readings of one seed."""
    import torch

    from perfbench.checks import train as check

    runner, hook, rec, _ = driver.setup(ctx)
    runner.train(max_epochs=rec.replay_epoch + 1)
    ctx.sync()
    rec.replay_to_host()
    if runner.writer is not None:
        runner.writer.close()
    del runner, hook
    ctx.free()
    prog = check.program_side(rec)
    ref = check.reference_side(rec, ctx.device)
    out = {"sound": check.numbers(rec, prog, ref),
           "rows": {stage: {k: [float(f"{v:.4g}") for v in sorted(g.tolist())]
                            for k, g in check.rollout_gaps(prog[stage], ref[stage]).items()}
                    for stage in ("rollout", "replay")},
           "param_change_gaps": check.param_change_gaps(rec, prog["update"]["params"],
                                                        ref["update"]),
           "reference_seconds": ref["seconds"]}
    if not control:
        return out
    ctrl = dict(ref, update=check.reference_update(rec, dtype=torch.float32,
                                                   device=ctx.device, tf32=True))
    out["control"] = check.numbers(rec, ctrl, ref)
    faults = {}
    for name, kw in (("half_batch", {"half_batch": True}),
                     ("unchanged_after_early_steps", {"frozen_after": check.EARLY_STEPS})):
        faulty = dict(ref, update=check.reference_update(rec, device=ctx.device, **kw))
        faults[name] = check.numbers(rec, faulty, ref)
    for stage in ("rollout", "replay"):
        for key in ("obs", "action", "reward", "done", "frozen"):
            faulty = dict(ref, **{stage: _altered(ref[stage], key)})
            faults[f"{stage}_{key}"] = check.numbers(rec, faulty, ref)
    out["faults"] = faults
    return out


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        harness.log("readings are taken on the card")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    cell = harness.resolve(bench, args.workload)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = harness.Context(root=harness.ROOT, cell=cell.spec, config=cell.config,
                              traffic=cell.traffic, seed=seed, seconds=0.0, trace=False,
                              device="cuda:0", tmpdir=os.environ.get("TMPDIR", "/tmp"),
                              t_start=t0)
        out = {"seed": seed, **train_readings(ctx, cell.driver, i < args.control_seeds),
               "seconds": time.perf_counter() - t0}
        with open(args.out, "a") as f:
            f.write(json.dumps(out) + "\n")
        brief = {k: v for k, v in out.items() if k not in ("rows", "faults")}
        harness.log(f"seed {seed}: {json.dumps(brief)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
