#!/usr/bin/env python3
"""K3's wrapper time against its kernel time, for one or more checkouts.

    python3 tools/k3_wrapper_time.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (``.`` for this one; another
commit unpacked with ``git archive`` into a git-ignored directory). For
each, in the order given, a fresh process imports ``repro_torch`` from
``ROOT/src``, builds K3 there (reusing this checkout's build of the same
source where the file names match: the name carries the source's hash) and
times ``flash_attention`` at the serve prefill's shape, q bf16[1, 16, 2048,
128], k/v bf16[1, 8, 2048, 128], causal, on the CUDA card: the wrapper
with CUDA events over back-to-back calls, and the kernel alone from
torch.profiler's device events. Give the roots in turns (A B B A) to see
the spread. Prints one JSON line a root, then nvidia-smi's name and power
limit. Needs one card.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SHAPE = {"b": 1, "h": 16, "hkv": 8, "s": 2048, "d": 128}
REPS, WARMUP = 200, 20


def one(root: Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    assert Path(ops.__file__).resolve().is_relative_to(root.resolve()), ops.__file__
    lib = _build.lib_path("flash_attention")
    mine = HERE / "build" / "kernels" / lib.name
    if not lib.exists() and mine.exists():  # the same source, built already
        lib.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(mine, lib)
        shutil.copy2(mine.with_suffix(".ptxas.txt"), lib.with_suffix(".ptxas.txt"))
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    b, h, hkv, s, d = (SHAPE[k] for k in ("b", "h", "hkv", "s", "d"))
    q = torch.randn(b, h, s, d, generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(b, hkv, s, d, generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))

    def call():
        return ops.flash_attention(q, k, v, causal=True)

    for _ in range(WARMUP):
        call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        call()
    end.record()
    end.synchronize()
    wrapper_ms = start.elapsed_time(end) / REPS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            call()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
          and "flash_fwd_kernel" in e.name]
    return {"root": str(root), "ops": str(Path(ops.__file__).relative_to(root.resolve())),
            "custom_op": hasattr(ops, "flash_attention_fwd"), "wrapper_ms": wrapper_ms,
            "kernel_ms": sum(us) / len(us) / 1e3 if us else None,
            "wrapper_minus_kernel_us": (wrapper_ms - sum(us) / len(us) / 1e3) * 1e3
            if us else None, "reps": REPS, "shape": SHAPE}


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(Path(argv[1]).resolve())), flush=True)
        return 0
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.kernels import _build

    _build.build(["flash_attention"])  # once, here; a root with the same source copies it
    for root in argv:
        out = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True,
                             text=True)
        if out.returncode:
            raise SystemExit(f"{root}: exit {out.returncode}\n{out.stderr[-4000:]}")
        print(out.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
