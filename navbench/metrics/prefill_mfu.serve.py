"""The prefill's share of the card's bf16 peak: the yardstick's prefill
FLOPs (``yardstick.prefill_flops``) over the mean wall time of the
window's prefills (host clock, each ending with its first token on the
host)."""

from yardstick import BF16_PEAK_FLOPS, prefill_flops


def read(view):
    times = view.get("prefill_s") or []
    if view["kind"] != "serve" or not times:
        return None
    mean = sum(times) / len(times)
    return 100.0 * prefill_flops(view["cfg"], view["mix"]["prompt_len"]) / mean / BF16_PEAK_FLOPS
