"""K3's forward against its roofline in the traced prefills: the least time
of its work at the prefill's shape (``yardstick.k3_work``, B = 1, one call
a layer a prefill) over the device time of the ``flash_fwd_kernel*``
kernels."""

from devtrace import kernel_s
from yardstick import head_dim, k3_work


def read(view):
    trace = view["trace"]
    if view["kind"] != "serve" or not trace:
        return None
    secs, _ = kernel_s(trace, "flash_fwd_kernel")
    if secs <= 0:
        return None
    cfg, p = view["cfg"], view["mix"]["prompt_len"]
    d = head_dim(cfg)
    work = k3_work(1, cfg["n_heads"], cfg["n_kv_heads"], p, p, d, d, True, cfg["window"])
    return 100.0 * work["bound_s"] * cfg["n_layers"] * view["traced_requests"] / secs
