"""K3's backward against its roofline in the traced training steps: the
least time of its work at the step's shape (``yardstick.k3_bwd_work``, one
call a layer a step) over the device time of the ``flash_bwd*`` kernels."""

from devtrace import kernel_s
from yardstick import head_dim, k3_bwd_work


def read(view):
    trace = view["trace"]
    if view["kind"] != "train" or not trace:
        return None
    secs, _ = kernel_s(trace, "flash_bwd")
    if secs <= 0:
        return None
    cfg, mix = view["cfg"], view["mix"]
    d = head_dim(cfg)
    work = k3_bwd_work(mix["batch"], cfg["n_heads"], cfg["n_kv_heads"], mix["seq_len"],
                       mix["seq_len"], d, d, True, cfg["window"])
    return 100.0 * work["bound_s"] * cfg["n_layers"] * view["traced_steps"] / secs
