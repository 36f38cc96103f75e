#!/usr/bin/env python3
"""K3's backward kernels timed at the smoke's backward shapes, for one or
more checkouts.

    python3 tools/k3_backward_time.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (``.`` for this one; another
commit unpacked with ``git archive`` into a git-ignored directory). For
each, in the order given, a fresh process imports ``repro_torch`` from
``ROOT/src``, builds its kernels there and, at each shape chip_smoke.py's
``k3_lse_case`` runs K3's backward (bf16, random inputs from a seed), times
``repro_torch::flash_attention_bwd`` on the CUDA card: the call with CUDA
events over back-to-back calls, and its kernels alone (the delta, dK/dV
and dQ kernels of a call, summed and each by name) from torch.profiler's
device events.
Beside each time: the card's bound (2 (3 D + 2 Dv) operations a visible
pair at 989 TFLOP/s) and the tensor-core kernels' own floor (2 (6 D + 5
Dv)). Give the roots in turns (A B B A) to see the spread. Prints one JSON
line a root, then nvidia-smi's name and power limit. Needs one card.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

BF16_FLOPS = 989e12  # H100 SXM, bf16 dense tensor cores
REPS = 10
# name: (b, h, hkv, sq, sk, d, dv, causal, window), as chip_smoke.py runs them
SHAPES = {
    "qwen3_b1": (1, 16, 8, 2048, 2048, 128, 128, True, 0),
    "qwen3_b4": (4, 16, 8, 2048, 2048, 128, 128, True, 0),
    "d64_b1": (1, 16, 8, 2048, 2048, 64, 64, True, 0),
    "d64_b4": (4, 16, 8, 2048, 2048, 64, 64, True, 0),
    "hymba_b1": (1, 25, 5, 4096, 4096, 64, 64, True, 2048),
    "hymba_b2": (2, 25, 5, 4096, 4096, 64, 64, True, 2048),
    "mla": (1, 128, 128, 2048, 2048, 192, 128, True, 0),
    "mla_train_4k": (16, 8, 8, 4096, 4096, 192, 128, True, 0),
    "whisper_encoder": (4, 6, 6, 1500, 1500, 64, 64, False, 0),
    "whisper_cross": (4, 6, 6, 2048, 1500, 64, 64, False, 0),
    "whisper_decoder": (4, 6, 6, 2048, 2048, 64, 64, True, 0),
    "whisper_decoder_4k": (16, 6, 6, 4096, 4096, 64, 64, True, 0),
    "whisper_cross_4k": (16, 6, 6, 4096, 1500, 64, 64, False, 0),
}


def one(root: Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import ops

    assert Path(ops.__file__).resolve().is_relative_to(root.resolve()), ops.__file__
    dev = torch.device("cuda")
    out = {}
    for name, (b, h, hkv, sq, sk, d, dv, causal, win) in SHAPES.items():
        rng = np.random.default_rng(sq + d)
        q, k, v, do = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(
            dev, torch.bfloat16) for s in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv),
                                            (b, h, sq, dv)))
        o, lse = ops._forward(q, k, v, causal, win, None, True)

        def call():
            return ops.flash_attention_bwd(q, k, v, o, lse, do, causal, win, d ** -0.5)

        call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            call()
        end.record()
        end.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                call()
            torch.cuda.synchronize()
        by_kernel: dict[str, list[float]] = {}
        for e in prof.events():
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
                found = re.search(r"flash_bwd_\w+<[^(]*>", e.name)
                if found:
                    by_kernel.setdefault(found.group(0), []).append(e.time_range.elapsed_us())
        us = [t for ts in by_kernel.values() for t in ts]
        pairs = ops.visible_pairs(sq, sk, causal, win)
        kernel_ms = sum(us) / len(us) * 3 / 1e3 if us else None
        floor_ms = 2 * b * h * (6 * d + 5 * dv) * pairs / BF16_FLOPS * 1e3
        out[name] = {"ms": start.elapsed_time(end) / REPS, "kernel_ms": kernel_ms,
                     "bound_ms": 2 * b * h * (3 * d + 2 * dv) * pairs / BF16_FLOPS * 1e3,
                     "floor_ms": floor_ms,
                     "floor_share": floor_ms / kernel_ms if kernel_ms else None,
                     "kernel_ms_by_name": {kernel: sum(ts) / len(ts) / 1e3
                                           for kernel, ts in sorted(by_kernel.items())}}
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return {"root": str(root), "reps": REPS, "shapes": out}


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(Path(argv[1]).resolve())), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv:
        proc = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True,
                              text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
