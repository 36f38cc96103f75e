"""The device's idle share inside the program's own training steps: 1
less the time in which a kernel ran (the profiler's ``busy_s``) over the
device intervals of the program's ``train_step`` spans in the traced
steps. The harness's work between steps is left out of the intervals but
its kernels (the batch's copies to the card) count in ``busy_s``, so the
share reads a little low."""

from spanstore import device_s


def read(view):
    trace = view["trace"]
    if view["kind"] != "train" or not trace:
        return None
    steps = device_s(("train_step",))
    if steps is None or steps <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / steps)
