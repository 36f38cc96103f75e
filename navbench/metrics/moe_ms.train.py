"""The MoE FFN's device time a step: the kernels launched under the
program's ``moe_dispatch``, ``moe_experts`` and ``moe_combine`` ranges in
the traced steps (the forward and its recomputation; the backward's
kernels run outside the ranges)."""

RANGES = ("moe_dispatch", "moe_experts", "moe_combine")


def read(view):
    trace = view["trace"]
    secs = sum(trace["range_s"].get(r, 0.0) for r in RANGES) if trace else 0.0
    if view["kind"] != "train" or secs <= 0:
        return None
    return 1e3 * secs / view["traced_steps"]
