"""The device's idle share inside the program's own prefills: 1 less the
time in which a kernel ran (the profiler's ``busy_s``) over the device
intervals of the engine's ``prefill`` spans (each from the prompt's copy to
the card to its first token read back) in the traced prefills. The
harness's prompt making between them is left out."""

from spanstore import device_s


def read(view):
    trace = view["trace"]
    if view["kind"] != "serve" or not trace:
        return None
    prefills = device_s(("prefill",))
    if prefills is None or prefills <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / prefills)
