"""The chunked recurrence's device time a prefill: the kernels launched
under the program's ``linear_recurrence`` range in the traced prefills."""


def read(view):
    trace = view["trace"]
    secs = trace["range_s"].get("linear_recurrence", 0.0) if trace else 0.0
    if view["kind"] != "serve" or secs <= 0:
        return None
    return 1e3 * secs / view["traced_requests"]
