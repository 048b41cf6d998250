#!/bin/bash
# Training supervisor for the port's CLI: restarts training with checkpoint
# resume when the runner's watchdog exits 42 on a stalled device, or on a
# crash, with exponential back-off and a restart budget.
#
#   leibnizgym_tpu_torch/scripts/supervise_train.sh <logdir> [train overrides...]
#
# Example:
#   leibnizgym_tpu_torch/scripts/supervise_train.sh runs/d4 \
#       gym=trifinger_difficulty_4_curriculum_dr args.num_envs=8192 \
#       args.max_epochs=14000 args.watchdog_timeout=600
#
# MAX_RESTARTS (default 10) bounds the restarts without progress.
set -u
LOGDIR=${1:?usage: supervise_train.sh <logdir> [overrides...]}
shift
MAX_RESTARTS=${MAX_RESTARTS:-10}
# the repository root, two levels above this script
ROOT=$(cd "$(dirname "$0")/../.." && pwd)
restarts=0
while true; do
    ckpt=$(ls -dt "$LOGDIR"/*/nn/last 2>/dev/null | head -1 || true)
    resume=()
    if [ -n "${ckpt:-}" ]; then
        echo "[supervisor] resuming from $ckpt"
        resume=("args.checkpoint=$ckpt")
    fi
    # ${resume[@]+...} guards the empty-array expansion under `set -u`
    PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}" python -m leibnizgym_tpu_torch.scripts.train \
        "args.logdir=$LOGDIR" "$@" ${resume[@]+"${resume[@]}"}
    code=$?
    if [ $code -eq 0 ]; then
        echo "[supervisor] training completed"
        exit 0
    fi
    restarts=$((restarts + 1))
    if [ $restarts -gt "$MAX_RESTARTS" ]; then
        echo "[supervisor] giving up after $MAX_RESTARTS restarts (last exit $code)"
        exit $code
    fi
    # back off 10 s, 20 s, ... capped at 10 min, so a stalled device gets
    # idle time; a checkpoint newer than the last failure means training
    # progressed, which resets the budget
    backoff=$((10 * (1 << (restarts - 1))))
    [ "$backoff" -gt 600 ] && backoff=600
    new_ckpt=$(ls -dt "$LOGDIR"/*/nn/last 2>/dev/null | head -1 || true)
    if [ -n "${new_ckpt:-}" ] && [ "${new_ckpt}" != "${ckpt:-}" ]; then
        restarts=1
        backoff=10
    fi
    echo "[supervisor] exit $code — restart $restarts/$MAX_RESTARTS in ${backoff}s"
    sleep "$backoff"
done
