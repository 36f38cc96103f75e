"""The training step's share of the card's bf16 peak: the yardstick's
model FLOPs of a step (``yardstick.step_flops``, recomputation not counted)
times the steps of the window, over the window's time (host clock)."""

from yardstick import BF16_PEAK_FLOPS, step_flops


def read(view):
    if view["kind"] != "train" or not view["steps"]:
        return None
    mix = view["mix"]
    flops = step_flops(view["cfg"], mix["batch"], mix["seq_len"]) * view["steps"]
    return 100.0 * flops / view["window_s"] / BF16_PEAK_FLOPS
