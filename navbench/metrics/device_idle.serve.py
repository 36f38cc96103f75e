"""The device's idle share of the traced prefills: 1 less the time in which
a kernel ran (the profiler's device trace) over their wall time."""


def read(view):
    trace = view["trace"]
    if view["kind"] != "serve" or not trace or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
