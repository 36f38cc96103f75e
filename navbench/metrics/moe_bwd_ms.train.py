"""The MoE FFN's backward device time a step: the device intervals of the
program's ``moe.bwd`` spans (router, dispatch, experts and combine
backward) in the traced steps, less their ``recompute`` children: the
layer's checkpoint recomputes the whole layer when the combine's backward
first needs a saved tensor, inside the span. An interval holds the
device's idle time inside it too."""

from spanstore import device_s


def read(view):
    if view["kind"] != "train" or not view["trace"]:
        return None
    secs = device_s(("moe.bwd",), less=("recompute",))
    if secs is None or secs <= 0:
        return None
    return 1e3 * secs / view["traced_steps"]
