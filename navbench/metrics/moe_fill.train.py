"""The share of the MoE's expert slots that hold a token in the traced
steps: the program's counter ``moe.filled`` over ``moe.slots``, kept at
each MoE layer's dispatch (each forward once; not again when the layer is
recomputed). The experts' products compute every slot, filled or not."""

from spanstore import counter


def read(view):
    if view["kind"] != "train" or not view["trace"]:
        return None
    slots, filled = counter("moe.slots"), counter("moe.filled")
    if not slots or filled is None:
        return None
    return 100.0 * filled / slots
