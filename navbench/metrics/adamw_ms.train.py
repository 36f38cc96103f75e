"""AdamW's device time a step: the kernels launched under the program's
``adamw_update`` range in the traced steps."""


def read(view):
    trace = view["trace"]
    secs = trace["range_s"].get("adamw_update", 0.0) if trace else 0.0
    if view["kind"] != "train" or secs <= 0:
        return None
    return 1e3 * secs / view["traced_steps"]
