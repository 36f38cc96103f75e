"""Reading a ``torch.profiler`` trace: device time by range and by kernel.

``RANGES`` and :func:`kernel_group` are copies of ``chip_smoke.RANGES`` and
``chip_smoke._kernel_group``, and :func:`device_groups` of
``chip_smoke.device_groups`` (``test_navbench_yardstick.py`` holds them
equal): a kernel launched inside one of the program's ``record_function``
ranges counts as that range, any other by its name; K3's kernels, launched
through ctypes with no op around them, by name. :func:`summarize` adds what
the metric readers need: each range's device time (the innermost of
``RANGES`` around a kernel's launch), each kernel name's time and count,
the device's busy time, and the longest idle gaps with what the host was
doing in each.
"""

from __future__ import annotations

import torch

RANGES = {"flash_attention_backward": "K3 backward (flash_attention_bwd kernels)",
          "adamw_update": "optimizer (AdamW)",
          "moe_dispatch": "MoE dispatch (router, sort, searchsorted, gathers)",
          "moe_experts": "MoE expert GEMMs (bmm)",
          "moe_combine": "MoE combine (gather, ordered sum)",
          "mla": "MLA projections and absorbed decode",
          "linear_recurrence": "chunked linear recurrence (SSD, mLSTM)"}


def kernel_group(name: str) -> str:
    low = name.lower()
    if "flash_fwd_kernel" in name:
        return "K3 flash_attention"
    if "flash_bwd" in name:
        return RANGES["flash_attention_backward"]
    if any(tag in low for tag in ("gemm", "gemv", "nvjet", "cutlass", "sm90_", "xmma")):
        return "matmul (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if "reduce" in low or "softmax" in low:
        return "reductions"
    return "elementwise and other"


def _is_device(e) -> bool:
    return (getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def device_groups(prof) -> dict:
    """A trace's device time by kernel group, its busy time, its kernels and
    the largest of them by name."""
    events = prof.events()
    device = [e for e in events if _is_device(e)]
    busy = sum(e.time_range.elapsed_us() for e in device)
    groups: dict[str, float] = {}
    for e in events:
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        owner, anc = None, e
        while anc is not None and owner is None:
            owner, anc = RANGES.get(anc.name), anc.cpu_parent
        for kern in e.kernels:
            group = owner or kernel_group(kern.name)
            groups[group] = groups.get(group, 0.0) + kern.duration
    k3_us = sum(e.time_range.elapsed_us() for e in device if "flash_fwd_kernel" in e.name)
    if groups.get("K3 flash_attention", 0.0) == 0.0:
        groups["K3 flash_attention"] = k3_us
    bwd_us = sum(e.time_range.elapsed_us() for e in device if "flash_bwd" in e.name)
    if groups.get(RANGES["flash_attention_backward"], 0.0) == 0.0 and bwd_us:
        groups[RANGES["flash_attention_backward"]] = bwd_us
    rest = busy - sum(groups.values())
    if abs(rest) > 1.0:
        groups["not attributed"] = rest
    by_name: dict[str, float] = {}
    for e in device:
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + e.time_range.elapsed_us()
    return {"busy_us": busy, "device": device,
            "groups_ms": {k: v / 1e3 for k, v in sorted(groups.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms": {k: v / 1e3 for k, v in
                               sorted(by_name.items(), key=lambda kv: -kv[1])[:8]}}


def summarize(prof, window_s: float, n_gaps: int = 10) -> dict:
    """What the per-layer readers read from one traced window: the device's
    busy time, each of ``RANGES``' device time (:func:`device_groups`), each
    kernel name's time and count, and the longest idle gaps, each with the
    innermost host op that covers its start."""
    groups = device_groups(prof)
    by_label = {label: name for name, label in RANGES.items()}
    kernels: dict[str, list] = {}
    for e in groups["device"]:
        rec = kernels.setdefault(e.name, [0.0, 0])
        rec[0] += e.time_range.elapsed_us()
        rec[1] += 1
    spans = sorted((e.time_range.start, e.time_range.end) for e in groups["device"])
    gaps = sorted(((start - end, end) for (_, end), (start, _) in zip(spans, spans[1:])
                   if start > end), reverse=True)
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CPU
                  and not e.name.startswith("ProfilerStep"))
    idle = []
    for length, at in gaps[:n_gaps]:
        doing = "nothing recorded"
        for start, end, name in host:  # the latest-starting host op that covers the gap
            if start > at:
                break
            if end >= at:
                doing = name
        idle.append([doing[:80], length / 1e6])
    return {"busy_s": groups["busy_us"] / 1e6, "window_s": window_s,
            "range_s": {by_label[k]: v / 1e3 for k, v in groups["groups_ms"].items()
                        if k in by_label},
            "kernels": {k: (v[0] / 1e6, v[1]) for k, v in kernels.items()},
            "idle_gaps": idle}


def kernel_s(summary: dict, pattern: str) -> tuple[float, int]:
    """Device seconds and count of the kernels whose name holds ``pattern``."""
    hits = [v for k, v in summary["kernels"].items() if pattern in k]
    return sum(s for s, _ in hits), sum(n for _, n in hits)


def top_ops(summary: dict, n: int = 10) -> list:
    ranked = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][0])[:n]
    return [[name[:120], secs] for name, (secs, _) in ranked]
