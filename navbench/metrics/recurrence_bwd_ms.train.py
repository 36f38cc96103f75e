"""The chunked recurrence's backward device time a step: the device
intervals of the program's ``linear_recurrence.bwd`` spans in the traced
steps, less any ``recompute`` child (a checkpoint's recomputation that
would start inside one). An interval holds the device's idle time inside
it too."""

from spanstore import device_s


def read(view):
    if view["kind"] != "train" or not view["trace"]:
        return None
    secs = device_s(("linear_recurrence.bwd",), less=("recompute",))
    if secs is None or secs <= 0:
        return None
    return 1e3 * secs / view["traced_steps"]
