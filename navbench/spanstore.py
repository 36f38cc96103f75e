"""What the program's spans (``repro_torch.spans``) recorded over a traced
window, for the per-layer readers.

``drive_train.py`` and ``drive_serve.py`` profile their traced steps or
prefills with ``torch.profiler``, and the program's spans record while a
profile is active: each span's device interval (a pair of CUDA events,
from when the device reached its first work to when it finished its last,
idle inside it included) and the counters kept at span boundaries. The store holds that window until the
next one. A checkout whose program has no spans module reads nothing here
(None), and raises nothing.
"""

from __future__ import annotations


def _spans():
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return spans


def device_s(names: tuple[str, ...], less: tuple[str, ...] = ()) -> float | None:
    """The device seconds of the spans named in ``names``, less those of
    their direct children named in ``less``; None where none was recorded
    with a device interval."""
    spans = _spans()
    if spans is None:
        return None
    recs = spans.records()
    total, found = 0.0, False
    chosen = {r.id for r in recs if r.name in names}
    for r in recs:
        secs = r.device_s
        if secs is None:
            continue
        if r.name in names:
            total, found = total + secs, True
        elif r.name in less and r.parent in chosen:
            total -= secs
    return total if found else None


def counter(name: str) -> float | None:
    """The counter ``name`` over the window; None where it was not kept."""
    spans = _spans()
    return None if spans is None else spans.counters().get(name)
