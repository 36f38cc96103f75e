"""The loss head's device time a step: the device intervals of the
program's spans ``loss_head`` (the chunked float32 logits and
cross-entropy, forward) and ``loss_head.bwd`` (each chunk's recomputation
and gradient) in the traced steps. An interval holds the device's idle
time inside it too."""

from spanstore import device_s


def read(view):
    if view["kind"] != "train" or not view["trace"]:
        return None
    secs = device_s(("loss_head", "loss_head.bwd"))
    if secs is None or secs <= 0:
        return None
    return 1e3 * secs / view["traced_steps"]
