"""``train_mfu``: the whole epoch's share of the card's float32 peak, in
percent: the model FLOPs of an epoch (``yardstick.epoch_model_flops``: the
rollout's forward passes, every minibatch step's forward and backward, the
physics kernel's frozen operation count) times the window's epochs, over the
window's host-clock seconds, over 67 TFLOP/s."""

from perfbench import yardstick


def read(result, ctx):
    c = result["counters"]
    if not c.get("epochs"):
        return None
    return 100.0 * c["epoch_flops"] * c["epochs"] / c["window_s"] / yardstick.PEAK_FP32_FLOPS
