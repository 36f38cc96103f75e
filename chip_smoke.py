#!/usr/bin/env python3
"""Drive repro_torch's main path on one CUDA card and check every result.

Run from the root of a checkout: ``python3 chip_smoke.py`` (no arguments,
one card). It builds the CUDA kernels from ``src/repro_torch/kernels/csrc``
with nvcc and prints one JSON line per phase:

  env        torch / CUDA versions, the card, nvidia-smi's name, power limit
             and SM clocks (now and the most the card allows)
  build      nvcc wall time and each kernel's registers and spills from ptxas
             (K2 and the tensor-core K3 must spill nothing)
  navlint    ``python -m repro_torch.analysis --check --coverage`` over the
             port exits 0 with no finding; every ``tests/lint_fixtures`` file
             gives exactly the findings its ``# EXPECT:`` comments name
  kernels    each kernel against its plain PyTorch version on the card, at the
             main path's shapes (K1, K2 bitwise; K3 in bf16 within one
             rounding of its float32 answer), with its time, the plain version's,
             one PyTorch library call's and the card's lower bound; K2 also on
             its tie cases, with its inner loop's SASS instructions per pair
             (cuobjdump) and a 4-instruction floor beside the bound; K3's bf16
             cases at D = 64 and 128 run its tensor-core kernel, whose own
             arithmetic (two PV products) has a 6 D floor beside the 4 D bound;
             granite-moe-1b-a400m's prefill shape (head dim 64) among them
  itinerary  the Fig. 8 tour at full granule size on two CUDA nodes, every hop
             through a transit CMI, preempted after the match publish and
             resumed; the product equals an uninterrupted run's
  publish    the Fig. 7 form: a publish after each stage with device change
             hints (K1), its wall time and bytes written
  fabric     the same tour across three serve-only torch worker processes
             (``repro_torch.fabric.worker``, each its own CUDA context on
             the card): read here, geometry inside B, the match (K2) inside
             C, the product streamed back — every leg streamed or relayed,
             no store fallback, ``hop_root`` empty, the product bitwise the
             in-process tour's; again with C SIGKILLed first, respawned in
             place and the tour resumed from its geometry publish (``fsck``
             clean); then a delta stream hop with K1's hints that sends only
             the changed chunk. Per-leg seconds, bytes and chunks, the tours'
             wall times and each worker's start-up time
  serve      qwen3-1.7b at full width (28 layers, random weights from seed 0)
             through ``repro_torch.launch.serve.main``: 4 requests of 2048
             prompt tokens and 32 generated, K3 in every prefill layer;
             transcripts equal ``run_reference``'s; one request published
             (CAS) on admit and every 16 steps, its host dropped mid-
             generation and resumed by another with zero re-prefill; prefill
             logits with K3 against the plain attention at the same weights;
             every K3 launch of ``main`` through the tensor-core kernel
  serve_moe  the same for granite-moe-1b-a400m at full width (24 layers, 32
             experts top 8, head dim 64): 4 x 24 K3 launches, all tensor-core;
             where the time goes with the MoE dispatch, expert GEMMs and
             combine as groups of their own
  serve_fleet  the same model and requests through two serving worker
             processes (``repro_torch.serve.worker``, each its own CUDA
             context) under a ``ServeRouter`` in this process: one request
             warmed to the other worker, decoded 4 more rounds, handed off
             (streamed, zero re-prefill), the first worker SIGKILLed at
             round 20 and its requests resumed on the survivor from their
             last CMIs; every transcript equal to the serve phase's, K3
             counted inside the workers (4 x 28 launches, none on resume or
             adopt), ``fsck`` clean, ``hop_root`` empty. TTFT, routed
             prefill and decode tok/s beside the in-process ones, the warm
             and handoff legs, the recovery, each worker's memory; and
             ``launch.serve.main(--workers 2)`` against ``--workers 0``
  chaos      three cells of ``repro_torch.chaos.matrix`` with cuda workers
             (a ``hop.*`` kill, a relay kill, a SIGKILL at stream accept):
             each product bitwise the calm run's, ``hop_root`` empty
  train      qwen3-1.7b trained at full width by the Fig. 7 launcher
             (``python -m repro_torch.launch.train``, one process a run, so
             its deterministic settings precede its first CUDA call): run B
             reclaimed after step 2, resumed from its CMI in a new
             incarnation and finished at step 4; run A the same 4 steps
             uninterrupted, on the same job store. B's step-4 CMI has every
             chunk digest equal to A's, and published into A's job (the
             content-addressed store) writes 0 new bytes; step losses equal
             step for step; jobs finished with 2 and 1 incarnations; K3 with
             its lse in every layer's forward and remat recompute, all
             tensor-core launches. Step seconds, tokens/s, model TFLOP/s,
             publish and restart seconds and bytes, peak memory, free disk;
             one profiled step in this process split by kernel group; K3
             with lse against its plain version and against SDPA, the plain
             attention backward timed, and a 2-layer float32 model's
             gradients with K3 against plain attention under autograd
  train_moe  the same two launcher runs for granite-moe-1b-a400m (the runs
             keep 4 of 24 layers, widths kept), its full-depth step timed
             and profiled in this process, K3 with lse at head dim 64
  disk       the bytes each phase wrote (``/proc/self/io`` where the kernel
             counts them, else the files left), held under 40 GiB: the chip
             machine takes at most 45 GiB of writes a call

then the summary line ``{"kernels": [...]}`` with the launches each kernel
made on its main paths (K1 and K2: the itinerary, publish and fabric phases,
the fabric's counted inside the workers too; K3: the serve and serve_moe
phases' ``main``, the serving workers' prefills and the training runs of
both models, each counted inside its launcher process), the nvidia-smi
line, and last
``{"ok": true, "device": {...}}``. Any failure raises and the
script exits non-zero before the last line; so does a machine without a CUDA
card, or a directory without the rest of the repository.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import io
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# full size: one VIIRS M-band SDR granule (48 scans x 16 lines x 3200 pixels)
# against CrIS at 30 FOR x 9 FOV per scan
GRANULES = dict(n_scans=48, viirs_lines_per_scan=16, viirs_pixels_per_scan=3200)
N_PIXELS = 48 * 16 * 3200  # 2,457,600
M_FOVS = 48 * 30 * 9  # 12,960
CHUNK = 1 << 20  # the publish phase's chunk size; K1's grid follows it
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM, bf16 dense tensor cores
F32_TOL = 2e-5  # float32 sums in another order: tests/test_kernels.py's float32 tolerance
BF16_TOL = 2e-2  # tests/test_kernels.py's bfloat16 tolerance
BF16_ROUNDING = 2.0 ** -8  # one round to nearest bf16 moves x by at most 2**-8 |x|
# the serve phase: qwen3-1.7b at full width, the CLI's requests, and the
# request published and resumed; serve_moe the same for granite-moe-1b-a400m
SERVE_SPEC = "model:qwen3-1.7b:full:seed=0"
MOE_ARCH = "granite-moe-1b-a400m"
MOE_SERVE_SPEC = f"model:{MOE_ARCH}:full:seed=0"
PROMPT_LEN, GEN, BATCH = 2048, 32, 4


def serve_argv(arch: str) -> list[str]:
    return ["--arch", arch, "--prompt-len", str(PROMPT_LEN), "--gen", str(GEN),
            "--batch", str(BATCH), "--seed", "0", "--device", "cuda"]


SERVE_ARGV = serve_argv("qwen3-1.7b")
PUBLISH_EVERY = 16
DROP_AT_DONE = 24  # the first host is dropped here; its last publish is at done 17
# the serving fleet: two workers, a live migration after 8 rounds, a SIGKILL at 20
FLEET_PUBLISH_EVERY, WARM_AT_ROUND, HANDOFF_AFTER, KILL_AT_ROUND = 8, 8, 4, 20
# the chaos phase: a hop.* kill, a relay kill and a SIGKILL at stream accept
CHAOS_CELLS = ("hop.before_restore:sigkill", "relay.mid_stream:kill_conn",
               "hop_stream.accept:sigkill")
# the train phase: qwen3-1.7b through the launcher, 4 steps of 4 x 2048
# tokens, run B reclaimed after step 2 (8,192 tokens a step; the train state
# is ~24.1 GB, so each publish writes that much)
TRAIN_ARCH, TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_PREEMPT_AT = "qwen3-1.7b", 4, 2048, 4, 2


def train_argv(arch: str) -> list[str]:
    return ["--arch", arch, "--steps", str(TRAIN_STEPS), "--seq-len", str(TRAIN_SEQ),
            "--batch", str(TRAIN_BATCH), "--publish-every", str(TRAIN_STEPS), "--seed", "0",
            "--device", "cuda", "--log-every", "1"]


# The chip machine's disk takes at most 45 GiB of writes a call, deleted or
# not; the other phases take ~4 GB of it (the fleet's cache publishes most),
# and the three train-state CMIs of the two runs (~24.1 GB each at 28
# layers) would take 67 GiB. So the runs cut depth (never width) to the most
# layers whose three CMIs fit this budget: 4 of 28 (7.18 GB a CMI; 6 layers'
# 8.58 GB left too little for train_moe's); the profiled step and the K3
# checks, which write nothing, run at full depth.
TRAIN_WRITE_BUDGET = 21 * 2**30
# train_moe: granite's train state is 14 bytes a parameter too (18.7 GB at
# 24 layers, 3.70 GB at 4), so its three CMIs get a budget of their own
MOE_TRAIN_WRITE_BUDGET = 12 * 2**30
# what the whole smoke may write (the machine's limit is 45 GiB a call)
DISK_WRITE_LIMIT = 40 * 2**30
# profiler ranges whose kernels form groups of their own
RANGES = {"flash_attention_backward": "attention backward (plain torch)",
          "adamw_update": "optimizer (AdamW)",
          "moe_dispatch": "MoE dispatch (router, sort, searchsorted, gather, index_put)",
          "moe_experts": "MoE expert GEMMs (bmm)",
          "moe_combine": "MoE combine (gather, ordered sum)"}
GRAD_TOL = 1e-4  # tests/test_torch_train.py's float32 gradient tolerance (of each max)
LSE_TOL = 1e-4  # tests/test_torch_cuda.py's lse tolerance


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profiled_ms(fn, kernel: str, reps: int) -> float | None:
    """Mean device time of one launch of the kernel named ``kernel`` while
    ``fn`` runs, from torch.profiler (None where it records no device
    time). Per recorded launch, since the profiler may drop the first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if kernel in e.key]
    us = sum(getattr(e, "device_time_total", 0.0) for e in rows)
    launches = sum(e.count for e in rows)
    return us / launches / 1e3 if us > 0 and launches else None


def ptxas_entries(log: str) -> dict:
    """Registers and spill bytes of each kernel in an ``nvcc -Xptxas -v``
    report, by mangled entry name, and the report's warnings."""
    out, cur = {"warnings": []}, None
    for ln in log.splitlines():
        if "warning" in ln.lower():
            out["warnings"].append(ln.strip())
        elif "Compiling entry function" in ln:
            cur = ln.split("'")[1]
            out[cur] = {}
        elif cur and "spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            out[cur].update(stack_bytes=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif cur and "Used" in ln and "registers" in ln:
            out[cur]["registers"] = int(ln.split("Used")[1].split()[0])
    return out


def nvidia_smi(fields: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def compute_apps() -> list[str]:
    """``pid, used_memory`` of every compute context on the card, one line
    each (a container's PID namespace may show each process as one pid)."""
    return subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()


def sass_inner_loop(lib: Path, kernel: str) -> dict:
    """``kernel``'s hot loop in the built library's SASS (``cuobjdump
    -sass``): of the backward branches, the shortest whose range holds the
    most FMULs, and its instructions (NOPs aside) per FMUL. K2 issues one
    FMUL a (pixel, FOV) pair (u0 * l0), so that is its instructions a pair."""
    from repro_torch.kernels import _build

    tool = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    body = next(f for f in sass.split("Function : ")[1:] if kernel in f.splitlines()[0])
    ins = [(int(a, 16), op.split(".")[0], args) for a, op, args in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", body)]
    loops = []
    for addr, op, args in ins:
        target = re.search(r"0x([0-9a-f]+)", args) if op == "BRA" else None
        if target and int(target.group(1), 16) < addr:
            lo = int(target.group(1), 16)
            ops = [o for a, o, _ in ins if lo <= a <= addr and o != "NOP"]
            loops.append((ops.count("FMUL"), -len(ops), lo, addr, ops))
    fmuls, _, lo, hi, ops = max(loops)
    assert fmuls > 0, "no loop of FMULs in the SASS"
    hist = {o: ops.count(o) for o in sorted(set(ops), key=lambda o: -ops.count(o))}
    return {"loop": f"0x{lo:x}-0x{hi:x}", "instructions": len(ops), "pairs": fmuls,
            "per_pair": len(ops) / fmuls, "opcodes": hist}


def proc_write_bytes() -> int | None:
    """Bytes this process and the children it has waited for sent to
    storage (``write_bytes`` of ``/proc/self/io``); None where the kernel
    does not count them."""
    try:
        for ln in Path("/proc/self/io").read_text().splitlines():
            if ln.startswith("write_bytes:"):
                return int(ln.split()[1])
    except OSError:
        pass
    return None


def dir_bytes(path: Path) -> int:
    """Bytes of the files under ``path`` (0 if it is gone)."""
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


class DiskWrites:
    """The bytes each phase writes: the larger of the growth of
    :func:`proc_write_bytes` (which some kernels leave at 0) and
    the files the phase left (``files``, which the caller may raise to count
    what the phase deleted)."""

    def __init__(self):
        self.phases: dict[str, dict] = {}
        self._io = proc_write_bytes()

    def mark(self, phase: str, files: int) -> dict:
        io = proc_write_bytes()
        counted = None if io is None or self._io is None else io - self._io
        self._io = io
        self.phases[phase] = {"written_bytes": max(counted or 0, files),
                              "proc_io_write_bytes": counted, "files_bytes": files}
        return self.phases[phase]

    def total(self) -> int:
        return sum(p["written_bytes"] for p in self.phases.values())


# ---------------------------------------------------------------------------
# phase 2b: navlint, the port's static analysis (no device)
# ---------------------------------------------------------------------------


def run_navlint() -> dict:
    """``python -m repro_torch.analysis --check --coverage`` over the port:
    exit 0, no finding, the coverage cross-check (fire sites, ``SITES``,
    the chaos cells, ``docs/fabric.md``) included; then every fixture of
    ``tests/lint_fixtures`` gives exactly the findings its ``# EXPECT:``
    comments name (the reference's goldens; the CPU tests also hold them
    equal to the JAX package's navlint, which this script may not import),
    and the CLI's exit codes."""
    from collections import Counter

    from repro_torch.analysis import lint_paths, main as navlint_main

    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p)}
    argv = [sys.executable, "-m", "repro_torch.analysis", "--check", "--coverage",
            "src/repro_torch", "--docs", "docs/fabric.md"]
    t0 = time.perf_counter()
    text = subprocess.run(argv, capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    seconds = time.perf_counter() - t0
    assert text.returncode == 0 and "navlint: clean" in text.stdout, text.stdout + text.stderr
    js = subprocess.run(argv + ["--json"], capture_output=True, text=True, cwd=ROOT, env=env,
                        timeout=300)
    report = json.loads(js.stdout)
    assert js.returncode == 0 and report["findings"] == [] and report["checked_files"] > 70, report
    expect = re.compile(r"#\s*EXPECT:\s*([A-Z0-9, ]+)")
    fixtures = sorted(f for f in (ROOT / "tests" / "lint_fixtures").rglob("*.py")
                      if f.name != "__init__.py")
    found: dict[str, list] = {}
    for f in fixtures:
        want = Counter()
        for lineno, line in enumerate(f.read_text().splitlines(), start=1):
            m = expect.search(line)
            for code in (m.group(1).replace(",", " ").split() if m else ()):
                want[(lineno, code)] += 1
        findings, _, _ = lint_paths([str(f)])
        assert Counter((x.line, x.code) for x in findings) == want, (f.name, findings)
        found[f.relative_to(ROOT / "tests" / "lint_fixtures").as_posix()] = sorted(want)
    assert len(fixtures) >= 24, len(fixtures)
    fixtures_dir = ROOT / "tests" / "lint_fixtures"
    with contextlib.redirect_stdout(io.StringIO()):
        codes = {name: navlint_main(["--check", str(fixtures_dir / name)])
                 for name in ("nav201_fail.py", "nav201_ok.py")}
    assert codes == {"nav201_fail.py": 1, "nav201_ok.py": 0}, codes
    return {"command": " ".join(["python -m repro_torch.analysis"] + argv[3:]),
            "last_line": text.stdout.strip().splitlines()[-1], "seconds": seconds,
            "checked_files": report["checked_files"], "findings": 0,
            "fixtures": len(fixtures), "fixture_findings": sum(len(v) for v in found.values()),
            "fixtures_equal_goldens": True, "exit_codes": codes}


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_delta_encode(dev) -> dict:
    from repro_torch.checkpoint.serializer import _chunk_rows
    from repro_torch.kernels.delta_encode.ops import changed_blocks, changed_blocks_plain

    gen = torch.Generator(device="cpu").manual_seed(0)
    n = N_PIXELS
    cases = [  # (label, shape, dtype): the slice's leaves, then edge cases
        ("f32[N]", (n,), torch.float32), ("f32[N,3]", (n, 3), torch.float32),
        ("int32[N]", (n,), torch.int32), ("bool[N]", (n,), torch.bool),
        ("f32[M]", (M_FOVS,), torch.float32), ("f32[M,3]", (M_FOVS, 3), torch.float32),
        ("bf16[N]", (n,), torch.bfloat16), ("f64[N]", (n,), torch.float64),
        ("f32[N+12345] ragged", (n + 12345,), torch.float32),
        ("int8[33,7] tiny", (33, 7), torch.int8), ("f32[] 0-d", (), torch.float32),
    ]
    results, max_err = [], 0
    for label, shape, dt in cases:
        base = torch.randn(shape, generator=gen) * 100
        old = (base > 0 if dt == torch.bool else base.to(dt)).to(dev)
        new = old.clone()
        rows = _chunk_rows(tuple(shape), old.element_size(), CHUNK)
        n0 = shape[0] if shape else 1
        nblocks = max(1, math.ceil(n0 / rows))
        want = torch.zeros(nblocks, dtype=torch.bool)
        if shape:
            for r in sorted({0, n0 // 3, n0 - 1}):  # mutated rows
                new[r] = ~new[r] if dt == torch.bool else new[r] + 1
                want[r // rows] = True
        else:
            new.add_(1)
            want[0] = True
        got = changed_blocks(old, new, rows)
        plain = changed_blocks_plain(old, new, rows)
        err = int((got.cpu() != plain.cpu()).sum())
        assert err == 0 and torch.equal(got.cpu(), want), (label, got, plain, want)
        assert not changed_blocks(old, old.clone(), rows).any(), label
        results.append({"case": label, "rows": rows, "blocks": nblocks, "equal": True})
        max_err = max(max_err, err)
    # bitwise: identical NaNs are no change, another NaN payload or -0.0 is
    x = torch.full((n,), float("nan"), device=dev)
    y = x.clone()
    y.view(torch.int32)[n // 2] ^= 1
    z = torch.zeros(n, device=dev)
    rows = _chunk_rows((n,), 4, CHUNK)
    assert not changed_blocks(x, x.clone(), rows).any()
    assert torch.equal(changed_blocks(x, y, rows), changed_blocks_plain(x, y, rows))
    assert int(changed_blocks(x, y, rows).sum()) == 1
    assert int(changed_blocks(z, -z, rows).sum()) == math.ceil(n / rows)
    results.append({"case": "NaN payload / -0.0", "equal": True})

    # timing at the main path's largest leaf, pos f32[N,3], 1 MiB chunks
    old = torch.randn((n, 3), generator=gen).to(dev)
    new = old.clone()
    new[n // 2, 1] += 1
    rows = _chunk_rows((n, 3), 4, CHUNK)
    nb = math.ceil(n / rows)
    chunk_bytes = rows * 12

    def library():  # one PyTorch expression for the same function
        d = old.view(torch.uint8).view(-1) != new.view(torch.uint8).view(-1)
        full = (nb - 1) * chunk_bytes
        return torch.cat([d[:full].view(nb - 1, chunk_bytes).any(dim=1), d[full:].any()[None]])

    assert torch.equal(library(), changed_blocks(old, new, rows))
    nbytes = 2 * old.numel() * old.element_size()
    timing = {
        "ms": cuda_ms(lambda: changed_blocks(old, new, rows), 50),
        "kernel_only_ms": profiled_ms(lambda: changed_blocks(old, new, rows),
                                      "changed_blocks_kernel", 20),
        "plain_ms": cuda_ms(lambda: changed_blocks_plain(old, new, rows), 10),
        "library_ms": cuda_ms(library, 10),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "shape": "f32[2457600,3] x2, 1 MiB chunks",
        "bytes": nbytes,
    }
    return {"name": "delta_encode", "cases": results, "max_abs_err": float(max_err), **timing}


def check_colocate(dev, state) -> dict:
    from repro_torch.core import colocation as co
    from repro_torch.kernels import _build
    from repro_torch.kernels.colocate.cases import TIE_CASES, tie_case
    from repro_torch.kernels.colocate.ops import colocate_match, colocate_match_plain

    torch.backends.cuda.matmul.allow_tf32 = False  # the library yardstick in full fp32
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)

    def unit_vectors(k):
        v = rng.standard_normal((k, 3)).astype(np.float32)
        return torch.from_numpy(v / np.linalg.norm(v, axis=1, keepdims=True)).to(dev)

    cases = []
    for n, m in [(1000, 300), (513, 512), (100, 1), (1, 700)]:
        u, los = unit_vectors(n), unit_vectors(m)
        ki, kc = colocate_match(u, los)
        pi, pc = colocate_match_plain(u, los)
        assert torch.equal(ki, pi) and torch.equal(kc.view(torch.int32), pc.view(torch.int32))
        cases.append({"n": n, "m": m, "idx_equal": True, "cos_bitwise": True})
    # the tie rule under the kernel's sub-tiles, tiles and deferred rescan
    for label, *_ in TIE_CASES:
        u, los = (torch.from_numpy(a).to(dev) for a in tie_case(label))
        before = colocate_match.launches
        ki, kc = colocate_match(u, los)
        assert colocate_match.launches == before + 1, label
        pi, pc = colocate_match_plain(u, los)
        assert torch.equal(ki, pi) and torch.equal(kc.view(torch.int32), pc.view(torch.int32)), label
        cases.append({"case": label, "n": u.shape[0], "m": los.shape[0], "idx_equal": True,
                      "cos_bitwise": True})

    # the main path's shapes: u from the synthetic granules' geometry
    u = co._unit(state["pos"] - state["sat_pos"][None, :]).contiguous()
    los = state["los"].contiguous()
    assert tuple(u.shape) == (N_PIXELS, 3) and tuple(los.shape) == (M_FOVS, 3)
    ki, kc = colocate_match(u, los)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pi, pc = colocate_match_plain(u, los)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    idx_equal = torch.equal(ki, pi)
    cos_bitwise = torch.equal(kc.view(torch.int32), pc.view(torch.int32))
    max_err = float((kc - pc).abs().max())
    assert idx_equal and cos_bitwise, (int((ki != pi).sum()), max_err)
    cases.append({"n": N_PIXELS, "m": M_FOVS, "idx_equal": True, "cos_bitwise": True})

    def library():  # blocked fp32 matmul + max, TF32 off
        best = torch.empty(N_PIXELS, device=dev)
        arg = torch.empty(N_PIXELS, dtype=torch.int64, device=dev)
        for r0 in range(0, N_PIXELS, 8192):
            best[r0:r0 + 8192], arg[r0:r0 + 8192] = torch.matmul(u[r0:r0 + 8192], los.T).max(dim=1)
        return arg, best

    la, lb = library()
    pairs = N_PIXELS * M_FOVS
    flops = 2 * 3 * pairs
    sass = sass_inner_loop(_build.lib_path("colocate"), "colocate_kernel")
    timing = {
        "ms": cuda_ms(lambda: colocate_match(u, los), 5),
        "kernel_only_ms": profiled_ms(lambda: colocate_match(u, los), "colocate_kernel", 3),
        "plain_ms": plain_ms,
        "library_ms": cuda_ms(library, 3),
        "bound_ms": flops / FP32_FLOPS * 1e3,
        "bound_by": "operations",
        # an exact kernel issues 4 instructions a pair (3 of the dot, 1 max),
        # at the FP32_FLOPS rate of 2 operations an instruction
        "floor_4op_ms": 4 * pairs / (FP32_FLOPS / 2) * 1e3,
        "sass_per_pair": sass["per_pair"],
        "sass_loop": sass,
        "shape": f"u f32[{N_PIXELS},3] x los f32[{M_FOVS},3]",
        "flops": flops,
        "library_idx_agreement": float((la.to(torch.int32) == ki).float().mean()),
        "library_tf32": torch.backends.cuda.matmul.allow_tf32,
    }
    return {"name": "colocate", "cases": cases, "max_abs_err": max_err, **timing}


def visible_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(q, k) pairs the attention mask keeps: the work K3 must do."""
    q = np.arange(sq, dtype=np.int64)
    hi = np.minimum(q, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def one_bf16_rounding(got: torch.Tensor, ref32: torch.Tensor) -> dict:
    """``got`` (bf16) is ``ref32`` (the plain version's float32 answer on
    the same bf16-exact inputs) rounded once: every element within
    2**-8 |ref32| + F32_TOL of it. Where outputs are small (a causal row at
    S = 32768 averages ~1e4 keys, |out| ~ 0.015) 2e-2 would pass a dropped
    key tile or an off-by-one mask; this limit scales with each output."""
    err = (got.float() - ref32).abs()
    use = float((err / (BF16_ROUNDING * ref32.abs() + F32_TOL)).max())
    rms = float(ref32.square().mean().sqrt())
    out = {"max_abs_err_vs_f32": float(err.max()), "out_rms": rms,
           "max_err_over_rms": float(err.max()) / rms if rms else 0.0,
           "rounding_limit": f"2**-8 |x| + {F32_TOL}", "rounding_limit_use": use}
    assert use <= 1.0, out
    return out


def check_flash_attention(dev) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_plain

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32
    cases = []
    # the six cases of tests/test_kernels.py, then the serve prefill's shape,
    # prefill_32k's sequence length at the same heads, and granite's prefill
    # (head dim 64)
    shapes = [(2, 4, 4, 128, 128, 64, True, 0, "float32"),
              (1, 8, 2, 257, 257, 64, True, 0, "float32"),
              (2, 4, 2, 200, 200, 128, True, 64, "float32"),
              (1, 4, 4, 96, 160, 64, False, 0, "bfloat16"),
              (1, 2, 1, 512, 512, 64, True, 0, "bfloat16"),
              (1, 4, 4, 64, 64, 128, True, 32, "bfloat16"),
              (1, 16, 8, 2048, 2048, 128, True, 0, "bfloat16"),
              (1, 16, 8, 32768, 32768, 128, True, 0, "bfloat16"),
              (1, 16, 8, 2048, 2048, 64, True, 0, "bfloat16")]
    timed = {}
    for i, (b, h, hkv, sq, sk, d, causal, window, dt) in enumerate(shapes):
        rng = np.random.default_rng(i)
        dtype = getattr(torch, dt)
        q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)
                   for shape in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
        before = flash_attention.wgmma_launches
        got = flash_attention(q, k, v, causal=causal, window=window)
        kernel = "wgmma" if flash_attention.wgmma_launches > before else "cuda-core"
        assert kernel == ("wgmma" if dt == "bfloat16" and d in (64, 128) else "cuda-core")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = float((got.float() - want.float()).abs().max())
        tol = BF16_TOL if dt == "bfloat16" else F32_TOL
        close = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
        assert close and torch.isfinite(got).all(), (b, h, hkv, sq, sk, d, causal, window, dt, err)
        case = {"shape": f"B{b} H{h} Hkv{hkv} Sq{sq} Sk{sk} D{d}", "causal": causal,
                "window": window, "dtype": dt, "kernel": kernel, "max_abs_err": err, "tol": tol}
        if dt == "bfloat16":
            case.update(one_bf16_rounding(got, flash_attention_plain(
                q.float(), k.float(), v.float(), causal=causal, window=window)))
        if sq >= 2048:  # the main paths' shapes and the 32k one: timed
            pairs = visible_pairs(sq, sk, causal, window)
            flops = 4 * b * h * d * pairs
            nbytes = (2 * b * h * sq + 2 * b * hkv * sk) * d * q.element_size()
            reps = 20 if sq <= 2048 else 3

            def library(q=q, k=k, v=v):  # the yardstick only; the port never calls it
                return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

            lib_err = float((library().float() - want.float()).abs().max())
            case.update({
                "ms": cuda_ms(lambda: flash_attention(q, k, v, causal=causal, window=window), reps),
                "kernel_only_ms": profiled_ms(
                    lambda: flash_attention(q, k, v, causal=causal, window=window),
                    "flash_fwd_kernel_wgmma" if kernel == "wgmma" else "flash_fwd_kernel", reps),
                "plain_ms": plain_ms,
                "library_ms": cuda_ms(library, reps),
                "library_max_abs_err": lib_err,
                "visible_pairs": pairs, "flops": flops, "bytes": nbytes,
                "bound_ms": max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3,
                "bound_by": "operations" if flops / BF16_FLOPS >= nbytes / HBM_BYTES_PER_S
                else "bytes",
                # the tensor-core kernel keeps P float32 as two bf16 halves:
                # 6 D operations per visible pair, its own floor
                "floor_6d_ms": 6 * b * h * d * pairs / BF16_FLOPS * 1e3,
            })
            timed[sq, d] = case
        cases.append(case)
        del q, k, v, got, want
    serve = timed[2048, 128]
    at = ("ms", "kernel_only_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "floor_6d_ms",
          "max_abs_err", "max_abs_err_vs_f32", "out_rms", "rounding_limit_use")
    return {"name": "flash_attention", "cases": cases, "max_abs_err": serve["max_abs_err"],
            **{key: serve[key] for key in ("ms", "kernel_only_ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by", "floor_6d_ms")},
            "shape": "q bf16[1,16,2048,128], k/v bf16[1,8,2048,128], causal",
            **{key: serve[key] for key in ("max_abs_err_vs_f32", "out_rms",
                                           "rounding_limit_use")},
            "at_32k": {key: timed[32768, 128][key] for key in at},
            "at_d64": {"shape": "q bf16[1,16,2048,64], k/v bf16[1,8,2048,64], causal",
                       **{key: timed[2048, 64][key] for key in at}}}


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------


def _write(state):
    """Stage 4 (write): the publish after it is the write (Fig. 8)."""
    return state


def run_itinerary(root: Path, dev, *, preempt: bool, via: str) -> dict:
    from repro_torch.checkpoint.fsck import fsck_store
    from repro_torch.core import DHP, NBS, JobStore
    from repro_torch.core import colocation as co
    from repro_torch.core.dhp import Preempted
    from repro_torch.core.itinerary import Itinerary, Stage
    from repro_torch.core.jobstore import STATUS_CKPT, STATUS_FINISHED
    from repro_torch.core.preemption import run_preemptible

    nbs = NBS(root / "s3")
    nbs.add_node("data-host", device=dev)
    nbs.add_node("compute-host", device=dev)
    store = JobStore(root / "jobs")
    job = store.create_job({"app": "viirs-cris-colocation"})
    killed = {"done": not preempt}

    def write(state):
        if not killed["done"]:
            killed["done"] = True
            raise Preempted("spot reclaim after the match publish")
        return _write(state)

    # where the time goes: stage bodies (synchronized), and plugin events
    # bracketing each store hop (on_hop .. on_restart) and each publish
    # (on_checkpoint .. on_publish)
    spent = {"stages_s": 0.0, "store_hops_s": 0.0, "publishes_s": 0.0,
             "store_hops": 0, "publishes": 0}
    opened: dict = {}

    def timed(fn):
        def run(state):
            t0 = time.perf_counter()
            out = fn(state)
            torch.cuda.synchronize()
            spent["stages_s"] += time.perf_counter() - t0
            return out
        return run

    def mark(event, **kw):
        now = time.perf_counter()
        if event == "on_hop" and kw.get("via") == "store":
            opened["hop"] = now
        elif event == "on_restart" and "hop" in opened:
            spent["store_hops_s"] += now - opened.pop("hop")
            spent["store_hops"] += 1
        elif event == "on_checkpoint" and "hop" not in opened:
            opened["publish"] = now
        elif event == "on_publish" and "publish" in opened:
            spent["publishes_s"] += now - opened.pop("publish")
            spent["publishes"] += 1

    for event in ("on_hop", "on_restart", "on_checkpoint", "on_publish"):
        nbs.plugins.subscribe(event, functools.partial(mark, event))

    stages = [
        Stage("data-host", timed(functools.partial(co.stage_read, device=dev, seed=0, **GRANULES)),
              "read", publish=True),
        Stage("compute-host", timed(co.stage_geometry), "geometry", publish=True),
        Stage("compute-host", timed(co.stage_match), "match", publish=True),
        Stage("data-host", timed(write), "write"),
    ]
    traces = []

    def make_worker(incarnation):
        def worker():
            dhp = DHP(nbs, "compute-host", store)
            it = Itinerary(dhp, job.job_id, via=via)
            try:
                if store.read_job(job.job_id).status == STATUS_CKPT:
                    state = it.resume(stages)
                else:
                    state = it.run({}, stages)
            finally:
                traces.append([name for name, _ in it.trace])
            prod = co.stage_product(state)
            dhp.publish(job.job_id, STATUS_FINISHED, product=prod)
            return state, prod

        return worker

    t0 = time.perf_counter()
    (state, prod), incarnations = run_preemptible(make_worker)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    report = fsck_store(store.cmi_root(job.job_id))
    assert report.clean, report.summary()
    assert store.read_job(job.job_id).status == STATUS_FINISHED
    assert list(nbs.hop_root.iterdir()) == []
    return {"state": state, "prod": prod, "incarnations": incarnations, "wall_s": wall,
            "traces": traces, "fsck": report.summary(), "cmis": store.list_cmis(job.job_id),
            "spent": spent}


def run_publish_with_hints(root: Path, dev) -> list[dict]:
    from repro_torch.checkpoint.serializer import load_manifest
    from repro_torch.core import DHP, NBS, JobStore
    from repro_torch.core import colocation as co
    from repro_torch.core.delta import device_changed_hints
    from repro_torch.core.jobstore import STATUS_CKPT

    nbs = NBS(root / "s3")
    nbs.add_node("compute-host", device=dev)
    store = JobStore(root / "jobs")
    job = store.create_job({"app": "viirs-cris-colocation"})
    dhp = DHP(nbs, "compute-host", store, chunk_bytes=CHUNK)
    stages = [("read", functools.partial(co.stage_read, device=dev, seed=0, **GRANULES)),
              ("geometry", co.stage_geometry), ("match", co.stage_match)]
    prev: dict = {}
    out = []
    for step, (name, fn) in enumerate(stages):
        ts = time.perf_counter()
        state = fn(prev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hints = device_changed_hints(prev, state, chunk_bytes=CHUNK)
        t1 = time.perf_counter()
        cmi = dhp.publish(job.job_id, STATUS_CKPT, state, step=step, changed_hint=hints)
        t2 = time.perf_counter()
        carried = sorted(k for k in prev if isinstance(prev[k], torch.Tensor) and state[k] is prev[k])
        assert sorted(hints) == carried, (sorted(hints), carried)
        assert all(not hints[k].any() for k in carried), "a carried-over leaf was flagged"
        stats = load_manifest(store.cmi_root(job.job_id), cmi).extra["stats"]
        out.append({"stage": name, "stage_s": t0 - ts, "hint_s": t1 - t0, "publish_s": t2 - t1,
                    "hinted_leaves": len(hints), "written_bytes": stats["written_bytes"],
                    "ref_bytes": stats["ref_bytes"], "objects_written": stats["objects_written"]})
        prev = state
    # the carried-over leaves cost no bytes: only new leaves are written
    assert out[-1]["written_bytes"] < out[-1]["ref_bytes"]
    return out


def check_product(itin: dict, calm: dict, dev) -> dict:
    """The resumed product equals the uninterrupted one, is finite where it
    must be, and the card's match equals the plain version on the CPU for a
    sample of the same inputs."""
    from repro_torch.core import colocation as co

    s, p = itin["state"], itin["prod"]
    assert torch.equal(s["idx"], calm["state"]["idx"])
    assert np.array_equal(p["cris_match_count"], calm["prod"]["cris_match_count"])
    assert p["cris_match_count"].shape == (M_FOVS,) and tuple(s["idx"].shape) == (N_PIXELS,)
    counts = p["cris_match_count"]
    assert int(counts.sum()) == int(s["within"].sum())
    assert np.isfinite(p["cris_mean_rad"][counts > 0]).all()
    assert np.isnan(p["cris_mean_rad"][counts == 0]).all()
    assert 0.9 < p["matched_frac"] <= 1.0
    rows = torch.arange(0, N_PIXELS, 301, device=dev)  # 8,165 pixels across the granule
    cpu_idx, cpu_cos, _ = co.match_viirs_to_cris(
        s["pos"][rows].cpu(), s["los"].cpu(), s["sat_pos"].cpu())
    assert torch.equal(cpu_idx, s["idx"][rows].cpu())
    return {"matched_frac": p["matched_frac"], "fovs_matched": int((counts > 0).sum()),
            "cpu_sample_pixels": len(rows), "cpu_sample_idx_equal": True}


# ---------------------------------------------------------------------------
# phase 6: the fabric — the tour across torch worker processes on the card
# ---------------------------------------------------------------------------


def _instrument(dhp, legs: list, spent: dict) -> None:
    """Time every hop, relay and fetch of ``dhp`` (one row a leg: seconds,
    and the bytes and chunks the leg's receiver counted) and every stage run
    and publish it asks a worker for. The NBS is shared across runs: its
    ``call`` is wrapped from the class's own each time, so one run's timer
    replaces the last one's and never nests in it."""
    from repro_torch.core.nbs import RemoteStateRef

    hop, fetch = dhp.hop, dhp.fetch
    call = functools.partial(type(dhp.nbs).call, dhp.nbs)

    def timed_hop(state, dest, **kw):
        src = state.node if isinstance(state, RemoteStateRef) else dhp.node
        t0 = time.perf_counter()
        out = hop(state, dest, **kw)
        sec = time.perf_counter() - t0
        rec = dhp.nbs.node(dest).last_stream_receipt
        relay = isinstance(state, RemoteStateRef)
        legs.append({"leg": f"{src}->{dest}", "via": "relay" if relay else out.via, "s": sec,
                     "bytes": rec["sent_bytes"], "chunks": rec["chunks"],
                     "data_chunks": rec["data_chunks"]})
        return out

    def timed_fetch(ref, **kw):
        t0 = time.perf_counter()
        out = fetch(ref, **kw)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        rec = dhp.nbs.node(ref.node).last_fetch_receipt
        legs.append({"leg": f"{ref.node}->{dhp.home}", "via": "fetch_stream", "s": sec,
                     "bytes": rec["bytes"], "chunks": rec["chunks"],
                     "data_chunks": rec["data_chunks"]})
        return out

    def timed_call(node, svc, **kw):
        t0 = time.perf_counter()
        out = call(node, svc, **kw)
        if svc in ("svc/run_stage", "svc/publish_resident"):
            what = f"{svc} {node}" + (f" {kw['fn'].split(':')[-1]}" if "fn" in kw else "")
            spent[what] = spent.get(what, 0.0) + time.perf_counter() - t0
            for k in ("stage_s", "thread_cpu_s"):  # the stage's own times inside the worker
                if k in out:
                    spent[f"{what} {k}"] = spent.get(f"{what} {k}", 0.0) + out[k]
        return out

    dhp.hop, dhp.fetch, dhp.nbs.call = timed_hop, timed_fetch, timed_call


def run_fabric(root: Path, dev, calm: dict) -> dict:
    """Fig. 8 over three serve-only worker processes on the card: read on
    this process's node A, geometry inside B, the match (K2) inside C, the
    product streamed back to A — every leg streamed or relayed, nothing
    through the store. Then the same tour with C SIGKILLed first, C
    respawned in place and the tour resumed from its geometry publish; and
    a delta stream hop A->B with K1's hints, relayed on to D and fetched
    back. Every product is held bitwise against the in-process tour's."""
    from repro_torch.checkpoint.fsck import fsck_store
    from repro_torch.core import DHP, NBS, JobStore
    from repro_torch.core import colocation as co
    from repro_torch.core.delta import device_changed_hints
    from repro_torch.core.itinerary import Itinerary, Stage
    from repro_torch.core.jobstore import STATUS_CKPT
    from repro_torch.fabric.proxy import wait_ready
    from repro_torch.fabric.supervisor import FabricSupervisor
    from repro_torch.kernels.colocate import ops as colocate_ops
    from repro_torch.kernels.delta_encode import ops as delta_ops

    workers = ("B", "C", "D")
    sup = FabricSupervisor(str(root / "s3"), str(root / "jobs"), device=str(dev))
    out: dict = {"startup_s": {}}
    try:
        pins = {n: sup.pin(n) for n in workers}
        t0 = time.perf_counter()
        for name in workers:  # all three start together, each its own CUDA context
            sup.spawn(name, serve_only=True, socket_path=pins[name], wait=False)
        for name in workers:
            wait_ready(sup.workers[name].address)
            out["startup_s"][name] = time.perf_counter() - t0
        nbs = NBS(root / "s3")
        nbs.add_node("A", device=dev)
        for name in workers:
            nbs.add_remote_node(name, sup.workers[name].address)
        on_card = dev.type == "cuda"  # a dry run of the phase on the CPU runs no kernel
        want = "cuda:0" if on_card else str(dev)
        pings = {n: nbs.call(n, "svc/ping") for n in workers}
        assert all(p["device"] == want for p in pings.values()), pings
        apps = compute_apps()
        # a container's PID namespace may show every process as one pid:
        # count the card's compute contexts (this process and one a worker)
        out["workers"] = {n: {"pid": p["pid"], "device": p["device"]} for n, p in pings.items()}
        out["nvidia_smi_compute_apps"] = apps
        assert not on_card or len(apps) == 1 + len(workers), apps
        store = JobStore(root / "jobs")
        vias: list = []
        nbs.plugins.subscribe("on_hop", lambda **kw: vias.append(kw["via"]))

        def stages():
            return [
                Stage("A", functools.partial(co.stage_read, device=dev, seed=0, **GRANULES),
                      "read", publish=True),
                Stage("B", co.stage_geometry, "geometry", publish=True),
                Stage("C", co.stage_match, "match", publish=True),
            ]

        def launches(reset: bool = False) -> dict:
            here = {"delta_encode": delta_ops.changed_blocks.launches,
                    "colocate": colocate_ops.colocate_match.launches}
            if reset:
                delta_ops.changed_blocks.launches = colocate_ops.colocate_match.launches = 0
            there = {n: nbs.call(n, "svc/kernel_launches", reset=reset) for n in workers}
            return {k: here[k] + sum(t[k] for t in there.values()) for k in here} | {
                "colocate_in": {n: t["colocate"] for n, t in there.items() if t["colocate"]}}

        def check(state, job) -> dict:
            assert torch.equal(state["idx"], calm["state"]["idx"])
            assert torch.equal(state["within"], calm["state"]["within"])
            prod = co.stage_product(state)
            assert np.array_equal(prod["cris_match_count"], calm["prod"]["cris_match_count"])
            report = fsck_store(store.cmi_root(job.job_id))
            assert report.clean, report.summary()
            assert list(nbs.hop_root.iterdir()) == []
            return {"idx_equal": True, "cris_match_count_equal": True,
                    "fsck": report.summary(), "cmis": store.list_cmis(job.job_id)}

        # the calm tour, on the fresh workers and again on the same ones:
        # counts from 0 just before each, read just after
        for run in ("calm", "calm_warm"):
            vias.clear()
            launches(reset=True)
            legs, spent = [], {}
            job = store.create_job({"app": "viirs-cris-colocation"})
            dhp = DHP(nbs, "A", store)
            _instrument(dhp, legs, spent)
            t0 = time.perf_counter()
            state = Itinerary(dhp, job.job_id).run({}, stages())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            out[run] = {"wall_s": wall, "legs": legs, "stage_and_publish_s": spent,
                        "vias": list(vias), "launches": launches(), **check(state, job)}
            assert vias == ["stream", "relay", "fetch_stream"], vias
            assert not on_card or out[run]["launches"]["colocate_in"] == {"C": 1}, out[run]
            assert state["idx"].device.type == dev.type
            del state

        # the interrupted tour: C is SIGKILLed before the tour moves there
        vias.clear()
        launches(reset=True)
        legs, spent = [], {}
        job = store.create_job({"app": "viirs-cris-colocation"})
        sup.reclaim("C", notice=False)
        nbs.node("C").client.reconnect_timeout_s = 1.0
        dhp = DHP(nbs, "A", store)
        _instrument(dhp, legs, spent)
        t0 = time.perf_counter()
        try:
            Itinerary(dhp, job.job_id).run({}, stages())
            raise AssertionError("the tour reached a SIGKILLed worker")
        except OSError as e:
            failed_s = time.perf_counter() - t0
            error = f"{type(e).__name__}: {e}"
        j = store.read_job(job.job_id)
        assert j.status == STATUS_CKPT and j.step == 1, j  # the geometry publish
        t1 = time.perf_counter()
        sup.spawn("C", serve_only=True, socket_path=pins["C"])
        respawn_s = time.perf_counter() - t1
        assert nbs.call("C", "svc/ping")["device"] == want
        vias_before = list(vias)
        vias.clear()
        dhp = DHP(nbs, "A", store)
        _instrument(dhp, legs, spent)
        it = Itinerary(dhp, job.job_id)
        state = it.resume(stages())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert [n for n, _ in it.trace] == ["match"]
        # resumed from the geometry CMI here, so the state streams A -> C
        assert vias == ["stream", "fetch_stream"], vias
        out["interrupted"] = {"wall_s": wall, "failed_tour_s": failed_s, "error": error,
                              "respawn_s": respawn_s, "legs": legs,
                              "stage_and_publish_s": spent, "vias_before_kill": vias_before,
                              "vias_resumed": list(vias), "launches": launches(),
                              "resumed_stages": [n for n, _ in it.trace], **check(state, job)}
        assert not on_card or out["interrupted"]["launches"]["colocate_in"] == {"C": 1}

        # the delta stream hop: K1's hints, counts from 0 just before
        launches(reset=True)
        legs = []
        dhp = DHP(nbs, "A", chunk_bytes=CHUNK)
        _instrument(dhp, legs, {})
        dhp.hop(state, "B")
        changed = {**state, "viirs_rad": state["viirs_rad"].clone()}
        changed["viirs_rad"][:1000] += 1.0  # one leaf, one 1 MiB chunk
        t0 = time.perf_counter()
        hints = device_changed_hints(state, changed, chunk_bytes=CHUNK)
        hint_s = time.perf_counter() - t0
        n_changed = sum(int(h.sum()) for h in hints.values())
        dhp.node = "A"  # the changed state is this process's
        ref = dhp.hop(changed, "B", changed_hint=hints)
        ref = dhp.hop(ref, "D")
        back = dhp.fetch(ref)
        for k, v in changed.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(back[k], v), k
        delta_leg = legs[1]
        assert n_changed == 1 and delta_leg["data_chunks"] == n_changed, (n_changed, legs)
        out["delta"] = {"legs": legs, "hint_s": hint_s, "changed_chunks": n_changed,
                        "hinted_leaves": len(hints), "fetched_bitwise": True,
                        "launches": launches()}
        assert not on_card or out["delta"]["launches"]["delta_encode"] == len(hints) > 0
    finally:
        sup.shutdown()
    return out


# ---------------------------------------------------------------------------
# phase 7: serving qwen3-1.7b at full width
# ---------------------------------------------------------------------------


def check_serve(metrics: dict, dev, spec: str = SERVE_SPEC, varied: bool = True) -> dict:
    """The served transcripts equal ``run_reference``'s on an engine rebuilt
    from the seed, differ from request to request and (``varied``) each
    holds more than one token."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import make_engine, run_reference

    engine = make_engine(spec, device=dev)
    requests = launch_serve.build_requests(engine.vocab, batch=BATCH, prompt_len=PROMPT_LEN,
                                           gen=GEN, seed=0)
    t0 = time.perf_counter()
    reference = run_reference(engine, requests)
    reference_s = time.perf_counter() - t0
    transcripts = metrics["transcripts"]
    assert transcripts == reference, (transcripts, reference)
    assert all(len(t) == GEN and (len(set(t)) > 1 or not varied)
               for t in transcripts.values()), transcripts
    assert len({tuple(t) for t in transcripts.values()}) == len(requests), transcripts
    leaves = _leaves(engine.params)
    return {"engine": engine, "requests": requests, "reference": reference,
            "line": {"spec": spec, "params": sum(t.numel() for t in leaves),
                     "param_bytes": sum(t.numel() * t.element_size() for t in leaves),
                     "prefill_s": metrics["prefill_s"], "decode_s": metrics["decode_s"],
                     "prefill_tok_s": metrics["prefill_tok_s"],
                     "decode_tok_s": metrics["decode_tok_s"], "decoded": metrics["decoded"],
                     "reference_s": reference_s, "transcripts_equal_reference": True,
                     "distinct_tokens": {rid: len(set(t)) for rid, t in transcripts.items()},
                     "first_tokens": {rid: t[:8] for rid, t in transcripts.items()}}}


def _leaves(tree):
    from repro_torch.utils import flatten_with_paths

    return list(flatten_with_paths(tree)[0].values())


def run_serve_resume(root: Path, dev, engine, req: dict, want: list[int]) -> dict:
    """One request under a job: published on admit and every 16 steps, its
    host dropped at done 24, resumed by a new host from the CMI of done 17."""
    from repro_torch.checkpoint.fsck import fsck_store
    from repro_torch.checkpoint.serializer import load_manifest
    from repro_torch.core import DHP, NBS, JobStore
    from repro_torch.core.jobstore import STATUS_FINISHED
    from repro_torch.serve import ServeHost

    nbs = NBS(root / "s3")
    nbs.add_node("serve-0", device=dev)
    nbs.add_node("serve-1", device=dev)
    store = JobStore(root / "jobs")
    job = store.create_job({"app": "serve", "req": req["id"]})
    publishes, opened = [], {}

    def on_checkpoint(node, cmi, step):
        opened[cmi] = time.perf_counter()

    def on_publish(job_id, status, name):
        if name in opened:
            stats = load_manifest(store.cmi_root(job_id), name).extra["stats"]
            publishes.append({"cmi": name, "publish_s": time.perf_counter() - opened.pop(name),
                              "written_bytes": stats["written_bytes"],
                              "ref_bytes": stats["ref_bytes"], "chunks": stats["chunks"],
                              "ref_chunks": stats["ref_chunks"]})

    nbs.plugins.subscribe("on_checkpoint", on_checkpoint)
    nbs.plugins.subscribe("on_publish", on_publish)
    host = ServeHost(engine, node_name="serve-0", dhp=DHP(nbs, "serve-0", store, chunk_bytes=CHUNK),
                     publish_every=PUBLISH_EVERY)
    got = [tok for _, tok in host.admit(req["id"], req["prompt"], req["max_new"],
                                        job_id=job.job_id)["tokens"]]
    while host.status()["requests"][req["id"]]["done"] < DROP_AT_DONE:
        got += [tok for _, tok in host.step()["tokens"][req["id"]]]
    assert host.counters["publishes"] == 2 and got == want[:DROP_AT_DONE]
    assert host.drop(req["id"]) == {"dropped": True}
    del host  # the reclaimed instance: its decode state is gone

    host2 = ServeHost(engine, node_name="serve-1",
                      dhp=DHP(nbs, "serve-1", store, chunk_bytes=CHUNK))
    t0 = time.perf_counter()
    res = host2.resume(req["id"], job.job_id)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    resumed_at = res["done"]
    assert resumed_at == 1 + PUBLISH_EVERY, resumed_at
    assert host2.active[req["id"]]["caches"]["g0"]["k"].device.type == engine.device.type
    got = [tok for _, tok in res["tokens"]]
    while host2.active:
        got += [tok for _, tok in host2.step()["tokens"].get(req["id"], [])]
    assert got == want, (got, want)
    assert host2.counters["prefills"] == 0 and host2.counters["resumes"] == 1
    report = fsck_store(store.cmi_root(job.job_id))
    assert report.clean, report.summary()
    assert store.read_job(job.job_id).status == STATUS_FINISHED
    cfg = engine.cfg
    kv_bytes = 2 * cfg.n_layers * (PROMPT_LEN + GEN) * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    assert len(publishes) == 2
    for pub in publishes:  # every layer's cache rows changed: the whole cache is written
        assert pub["written_bytes"] >= kv_bytes, (pub, kv_bytes)
    assert publishes[1]["ref_bytes"] > 0  # the unchanged prompt is referenced, not rewritten
    return {"resumed_at_done": resumed_at, "dropped_at_done": DROP_AT_DONE,
            "resume_s": resume_s, "kv_cache_bytes": kv_bytes, "publishes": publishes,
            "transcript_equal": True, "reprefills": host2.counters["prefills"],
            "fsck": report.summary()}


def check_model_kernel_vs_plain(engine, prompt: list[int]) -> dict:
    """Prefill logits of one prompt with K3 and with the plain attention,
    at the same weights (launches here are not the main path's)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain
    from repro_torch.models import attention as attn

    tokens = torch.tensor([prompt], dtype=torch.int64, device=engine.device)
    s_max = len(prompt) + 1
    got, _ = engine.model.prefill(engine.params, {"tokens": tokens}, s_max=s_max)
    kernel = attn.flash_attention
    attn.flash_attention = flash_attention_plain
    try:
        want, _ = engine.model.prefill(engine.params, {"tokens": tokens}, s_max=s_max)
    finally:
        attn.flash_attention = kernel
    assert got.shape == (1, engine.cfg.vocab) and got.dtype == torch.float32
    assert torch.isfinite(got).all() and torch.isfinite(want).all()
    top1 = bool(torch.argmax(got[0]) == torch.argmax(want[0]))
    assert top1
    return {"prompt_tokens": len(prompt), "logits_max_abs_diff": float((got - want).abs().max()),
            "logits_max_abs": float(want.abs().max()), "top1_agree": top1}


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "flash_fwd_kernel" in name:
        return "K3 flash_attention"
    if any(tag in low for tag in ("gemm", "gemv", "nvjet", "cutlass", "sm90_", "xmma")):
        return "matmul (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if "reduce" in low or "softmax" in low:
        return "reductions"
    return "elementwise and other"


def device_groups(prof) -> dict:
    """A trace's device time by kernel group: a kernel launched inside one
    of :data:`RANGES` counts as that range, any other by its name
    (:func:`_kernel_group`); K3's kernels, launched through ctypes with no
    op around them, by name. Also the device's busy time, its kernels and
    the largest of them by name."""
    events = prof.events()
    device = [e for e in events if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.time_range.elapsed_us() for e in device)
    groups: dict[str, float] = {}
    for e in events:
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        owner, anc = None, e
        while anc is not None and owner is None:
            owner, anc = RANGES.get(anc.name), anc.cpu_parent
        for kern in e.kernels:
            group = owner or _kernel_group(kern.name)
            groups[group] = groups.get(group, 0.0) + kern.duration
    k3_us = sum(e.time_range.elapsed_us() for e in device if "flash_fwd_kernel" in e.name)
    if groups.get("K3 flash_attention", 0.0) == 0.0:  # its ctypes launches have no op
        groups["K3 flash_attention"] = k3_us
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


def profile_serve(engine, prompt: list[int], steps: int = 8) -> dict:
    """Where one request's time goes: a 2048-token prefill and ``steps``
    decode steps under torch.profiler, device time by kernel group and the
    device's idle share of each phase's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import is_done

    state = engine.prefill(prompt, steps + 1)  # warm
    engine.decode(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = engine.prefill(prompt, steps + 1)
    t1 = time.perf_counter()
    while not is_done(state):
        engine.decode(state)
    out = {"unprofiled_prefill_ms": (t1 - t0) * 1e3,
           "unprofiled_decode_ms_per_step": (time.perf_counter() - t1) * 1e3 / steps}
    for phase in ("prefill", "decode"):
        state = engine.prefill(prompt, steps + 1) if phase == "decode" else None
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if phase == "prefill":
                engine.prefill(prompt, steps + 1)
            else:
                while not is_done(state):
                    engine.decode(state)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        split = device_groups(prof)
        busy = split["busy_us"]
        out[phase] = {
            "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1 - busy / wall_us if split["device"] else None,
            "kernel_launches": len(split["device"]),
            "groups_ms": split["groups_ms"], "top_kernels_ms": split["top_kernels_ms"],
            "steps": 1 if phase == "prefill" else steps,
        }
    return out


def run_serve_moe(root: Path, dev) -> dict:
    """granite-moe-1b-a400m at full width through ``launch.serve.main`` with
    the serve phase's traffic: K3 launches counted from 0 just before and
    read just after (4 x 24, all on the tensor cores), transcripts equal
    ``run_reference``'s, one request published, dropped and resumed with
    zero re-prefill, prefill logits with K3 against the plain attention,
    and where a prefill's and a decode step's time goes, the MoE dispatch,
    expert GEMMs and combine as groups of their own."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.colocate import ops as colocate_ops
    from repro_torch.kernels.delta_encode import ops as delta_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import moe

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    delta_ops.changed_blocks.launches = 0
    colocate_ops.colocate_match.launches = 0
    flash_ops.flash_attention.launches = 0
    flash_ops.flash_attention.wgmma_launches = 0
    metrics = launch_serve.main(serve_argv(MOE_ARCH))
    torch.cuda.synchronize()
    launches = {"delta_encode": delta_ops.changed_blocks.launches,
                "colocate": colocate_ops.colocate_match.launches,
                "flash_attention": flash_ops.flash_attention.launches,
                "flash_attention_wgmma": flash_ops.flash_attention.wgmma_launches}
    peak = torch.cuda.max_memory_allocated(dev)
    # The reference's init scales an expert's weights by the fan-in over all
    # experts (1/sqrt(X E), 1/sqrt(X F)), so with random weights the MoE's
    # output is ~1 % of the attention's and greedy decoding may repeat one
    # token; check_moe_on_card holds the MoE itself on the card instead.
    served = check_serve(metrics, dev, spec=MOE_SERVE_SPEC, varied=False)
    engine, req = served["engine"], served["requests"][0]
    cfg = engine.cfg
    assert cfg == get_config(MOE_ARCH), cfg  # the full width and depth, nothing cut
    assert launches == {"delta_encode": 0, "colocate": 0, "flash_attention": BATCH * cfg.n_layers,
                        "flash_attention_wgmma": BATCH * cfg.n_layers}, launches
    resume = run_serve_resume(root, dev, engine, req, served["reference"][req["id"]])
    in_model = check_model_kernel_vs_plain(engine, req["prompt"])
    on_card = check_moe_on_card(dev, cfg)
    scatter = time_dispatch_scatter(dev, cfg)
    trace = profile_serve(engine, req["prompt"])
    for phase in ("prefill", "decode"):
        for name in ("moe_dispatch", "moe_experts", "moe_combine"):
            assert trace[phase]["groups_ms"].get(RANGES[name], 0) > 0, (phase, name, trace)
    return {**served["line"],
            "config": {"arch": MOE_ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                       "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim],
                       "experts": [cfg.n_experts, cfg.top_k, cfg.resolved_moe_d_ff],
                       "router": cfg.router_type, "capacity_factor": cfg.capacity_factor,
                       "vocab": cfg.vocab, "dtype": cfg.dtype,
                       "params": cfg.param_count(), "active_params": cfg.active_param_count()},
            "capacity": {"prefill_per_expert": moe.capacity(PROMPT_LEN, cfg),
                         "prefill_assignments": PROMPT_LEN * cfg.top_k,
                         "decode_per_expert": moe.capacity(1, cfg)},
            "resume": resume, "kernel_vs_plain_in_model": in_model, "moe_on_card": on_card,
            "where_the_time_goes": trace, "dispatch_scatter": scatter,
            "launches": launches, "k3_launches_per_prefill": cfg.n_layers,
            "peak_memory_bytes": peak}


def check_moe_on_card(dev, cfg) -> dict:
    """One MoE layer of ``cfg`` on the card (bf16) against the same layer on
    the CPU in float32 (the port's CPU path, which the CPU tests hold
    against the JAX package), at a prefill's group (2048 tokens, capacity
    640) and a decode step's (one token, capacity 1). The router weights
    and inputs are multiples of 2**-6 and 2**-2 small enough that every
    router logit is exact in float32 on both devices: the routing is then
    the same whatever the order of the sums, ties (which the few distinct
    values make common) included; experts 0-3 are favoured, so their
    capacity overflows and drops happen. Outputs within 2e-2 of the largest
    magnitude (bf16 products and sums); then each expert's down
    projection made to write only its own column, so a column is non-zero
    exactly where its expert's assignment passed capacity: those sets
    equal on both devices."""
    from repro_torch.models import moe

    rng = np.random.default_rng(18)
    e, x_, f = cfg.d_model, cfg.n_experts, cfg.resolved_moe_d_ff
    p32 = {"w_router": rng.integers(-8, 9, (e, x_)).astype(np.float32) / 64,
           "wg": (rng.standard_normal((x_, e, f)) / math.sqrt(e)).astype(np.float32),
           "wu": (rng.standard_normal((x_, e, f)) / math.sqrt(e)).astype(np.float32),
           "wd": (rng.standard_normal((x_, f, e)) / math.sqrt(f)).astype(np.float32)}
    p32["w_router"][:16, :4] = 8 / 64  # with the constant features below: experts 0-3
    own = np.zeros_like(p32["wd"])     # favoured, so their capacity overflows
    own[np.arange(x_), :, np.arange(x_)] = 1.0 + np.abs(rng.standard_normal((x_, f)))
    cpu_cfg = cfg.with_(dtype="float32")
    out = {}
    for label, tokens in (("prefill", PROMPT_LEN), ("decode", 1)):
        x = (rng.integers(-2, 3, (1, tokens, e)) / 4).astype(np.float32)
        x[..., :16] = 0.5
        res = {"tokens": tokens, "capacity": moe.capacity(tokens, cfg)}
        for wd_name, wd in (("dense", p32["wd"]), ("own_column", own)):
            weights = {**p32, "wd": wd}
            card = {k: torch.from_numpy(v).to(dev, torch.float32 if k == "w_router"
                                              else torch.bfloat16) for k, v in weights.items()}
            host = {k: v.float().cpu() for k, v in card.items()}  # the same bf16 values
            got = moe.moe_ffn(card, torch.from_numpy(x).to(dev, torch.bfloat16), cfg)
            want = moe.moe_ffn(host, torch.from_numpy(x), cpu_cfg)
            got = got.float().cpu()
            assert got.shape == want.shape and torch.isfinite(got).all()
            if wd_name == "dense":
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                assert err <= BF16_TOL * scale, (label, err, scale)
                res.update(max_abs_err=err, max_abs=scale, tol=f"{BF16_TOL} of the max")
            else:
                kept_card = set(map(tuple, torch.nonzero(got[0, :, :x_]).tolist()))
                kept_host = set(map(tuple, torch.nonzero(want[0, :, :x_]).tolist()))
                assert kept_card == kept_host, (label, len(kept_card ^ kept_host))
                res.update(kept_assignments=len(kept_card),
                           dropped=tokens * cfg.top_k - len(kept_card), kept_equal=True)
        out[label] = res
    assert out["prefill"]["dropped"] > 0  # the capacity bound was exercised
    return out


def time_dispatch_scatter(dev, cfg) -> dict:
    """The dispatch's scatter alone (``index_put`` with ``accumulate=True``
    of a prefill group's 16,384 assignments into the (X, C, E) bf16 buffer):
    every assignment in a slot of its own, then with 500 and 2,400 of them
    on one slot, as dropped assignments land on their expert's clamped last
    slot. PyTorch's sort-based kernel adds a slot's rows one after another."""
    from repro_torch.models import moe

    x_, e, k = cfg.n_experts, cfg.d_model, cfg.top_k
    cap, n = moe.capacity(PROMPT_LEN, cfg), PROMPT_LEN * k
    eid = np.sort(np.random.default_rng(0).integers(0, x_, n))
    pos = np.zeros(n, np.int64)
    for x in range(x_):
        rows = np.nonzero(eid == x)[0]
        pos[rows] = np.arange(len(rows)) % cap
    vals = torch.randn(n, e, device=dev, dtype=torch.bfloat16)
    out = {"assignments": n, "capacity": cap}
    for dup in (0, 500, 2400):
        ei, pi = eid.copy(), pos.copy()
        ei[:dup], pi[:dup] = 0, cap - 1
        idx = (torch.from_numpy(ei).to(dev), torch.from_numpy(pi).to(dev))
        out[f"ms_with_{dup}_on_one_slot"] = cuda_ms(lambda idx=idx: torch.zeros(
            (x_, cap, e), dtype=torch.bfloat16, device=dev).index_put(idx, vals, accumulate=True), 20)
    return out


def train_files(root: Path, train: dict) -> int:
    """Bytes a train phase wrote as files: what is left under ``root``, or
    its publishes' bytes where it deleted a CMI on the way."""
    published = sum(p["written_bytes"] for run in train["publish"].values() for p in run)
    return max(dir_bytes(root), published)


# ---------------------------------------------------------------------------
# phase 8: the serving fleet — qwen3-1.7b across two serving worker processes
# ---------------------------------------------------------------------------


def run_serve_fleet(root: Path, dev, local: dict) -> dict:
    """The serve phase's four requests through two serving workers on the
    card under a router here: one request warmed to s1 after 8 rounds,
    decoded 4 more rounds on s0 and handed off; s0 SIGKILLed at round 20
    and its requests resumed on s1. ``local`` is the serve phase's
    in-process metrics: every transcript must equal its."""
    from repro_torch.checkpoint.fsck import fsck_store
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import NBS, JobStore
    from repro_torch.core.jobstore import STATUS_FINISHED
    from repro_torch.fabric.proxy import wait_ready
    from repro_torch.fabric.supervisor import FabricSupervisor
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import ServeRouter, spawn_serve_worker

    names = ("s0", "s1")
    _, arch, size = SERVE_SPEC.split(":")[:3]
    cfg = get_smoke_config(arch) if size == "smoke" else get_config(arch)
    requests = launch_serve.build_requests(cfg.vocab, batch=BATCH, prompt_len=PROMPT_LEN,
                                           gen=GEN, seed=0)
    sup = FabricSupervisor(str(root / "s3"), str(root / "jobs"), device=str(dev))
    store = JobStore(root / "jobs")
    router = ServeRouter(jobstore=store)
    out: dict = {"startup_s": {}}

    def k3(name: str, reset: bool = False) -> dict:
        return router.call(name, "svc/kernel_launches", reset=reset)

    def status(name: str) -> dict:
        return router.call(name, "svc/serve_status")

    try:
        t0 = time.perf_counter()
        for name in names:  # both start together, each its own CUDA context
            spawn_serve_worker(sup, name, engine_spec=SERVE_SPEC,
                               publish_every=FLEET_PUBLISH_EVERY, wait=False, device=str(dev))
        for name in names:
            wait_ready(sup.workers[name].address, timeout=300)
            out["startup_s"][name] = time.perf_counter() - t0
            router.add_worker(name, sup.workers[name].address)
        for name in names:  # the main path: counts from 0 just before
            k3(name, reset=True)
        t0 = time.perf_counter()
        for req in requests:
            router.admit(req["prompt"], req["max_new"], req_id=req["id"])
        prefill_s = time.perf_counter() - t0
        after_admit = {n: k3(n) for n in names}
        window_t0 = time.perf_counter()  # the decode window: to the last token
        step_s, rounds = 0.0, 0

        def decode(n: int) -> None:
            nonlocal step_s, rounds
            for _ in range(n):
                t = time.perf_counter()
                router.step()
                step_s += time.perf_counter() - t
                rounds += 1

        decode(WARM_AT_ROUND)
        victim = next(r for r in sorted(router.pending()) if router.assignment[r] == "s0")
        prefills_s1 = status("s1")["counters"]["prefills"]
        t = time.perf_counter()
        warm = router.warm(victim, "s1")
        warm_s = time.perf_counter() - t
        decode(HANDOFF_AFTER)
        t = time.perf_counter()
        event = router.migrate(victim, "s1", warm=False)
        handoff_s = time.perf_counter() - t
        s1 = status("s1")["counters"]
        assert event["mode"] == "stream" and event["warm"], event
        assert s1["prefills"] == prefills_s1 and s1["migrations_in"] == 1, s1
        memory = compute_apps()
        decode(KILL_AT_ROUND - rounds)
        before_kill = {n: k3(n) for n in names}
        s0_at_kill = status("s0")  # nothing runs on s0 between this read and the kill
        rc = sup.reclaim("s0", notice=False)
        assert rc == -signal.SIGKILL, rc
        t = time.perf_counter()
        resumed = router.recover("s0", "s1")
        recover_s = time.perf_counter() - t
        assert resumed, "nothing was stranded on s0"
        while router.pending():
            decode(1)
        window_s = time.perf_counter() - window_t0
        s1_at_end = status("s1")
        s1 = s1_at_end["counters"]
        end = k3("s1")
        transcripts = {req["id"]: router.transcript(req["id"]) for req in requests}
        mismatched = {r: t for r, t in transcripts.items() if t != local["transcripts"][r]}
        assert not mismatched, (mismatched, local["transcripts"])
        launches = {k: sum(c[k] for c in after_admit.values())
                    for k in ("flash_attention", "flash_attention_wgmma")}
        on_card = dev.type == "cuda"  # a dry run of the phase on the CPU runs no kernel
        assert not on_card or launches == {"flash_attention": BATCH * cfg.n_layers,
                                           "flash_attention_wgmma": BATCH * cfg.n_layers}, \
            after_admit
        # decode, the adopt and the resumes launched no K3
        assert before_kill == after_admit and end == after_admit["s1"], (before_kill, end)
        assert s1["resumes"] == len(resumed) and s1["migrations_in"] == 1, s1
        fsck = {}
        for req_id, job_id in router.jobs.items():
            job = store.read_job(job_id)
            assert job.status == STATUS_FINISHED and job.lease_owner is None, job
            report = fsck_store(store.cmi_root(job_id))
            assert report.clean, report.summary()
            fsck[req_id] = report.summary()
        assert list(NBS(root / "s3").hop_root.iterdir()) == []
        # over the whole decode window (warm, handoff, kill and recover in
        # it): the tokens that reached the router once each, and every token
        # the workers decoded, those s1 decoded again after the resume too
        delivered = BATCH * (GEN - 1)
        produced = s0_at_kill["counters"]["decode_steps"] + s1["decode_steps"]
        worker_s = {"s0": s0_at_kill["seconds"], "s1": s1_at_end["seconds"]}
        out.update(
            requests={"batch": BATCH, "prompt_len": PROMPT_LEN, "gen": GEN},
            ttft_p50_s=statistics.median(router.ttft_s.values()),
            ttft_max_s=max(router.ttft_s.values()), ttft_s=router.ttft_s,
            prefill_s=prefill_s, prefill_tok_s=BATCH * PROMPT_LEN / prefill_s,
            decode_window_s=window_s, decode_delivered=delivered, decode_produced=produced,
            decode_delivered_tok_s=delivered / window_s,
            decode_produced_tok_s=produced / window_s,
            decode_rounds=rounds,
            # where the window went, on the driver's clock; "other" is the
            # kill, the reads above and the router's own work
            decode_window_split_s={
                "router_steps": step_s, "warm": warm_s, "handoff": handoff_s,
                "recover": recover_s,
                "other": window_s - step_s - warm_s - handoff_s - recover_s},
            # inside the workers' steps and admits: decode to each token's
            # read, and the CMI publishes (s0 up to its kill)
            worker_seconds=worker_s,
            publishes={"s0": s0_at_kill["counters"]["publishes"], "s1": s1["publishes"]},
            in_process={"prefill_tok_s": local["prefill_tok_s"],
                        "decode_tok_s": local["decode_tok_s"]},
            victim=victim,
            warm={"s": warm_s, **{k: warm[k] for k in ("chunks", "data_chunks", "ref_chunks",
                                                       "sent_bytes", "done")}},
            handoff={"s": handoff_s, **{k: event[k] for k in ("mode", "chunks", "data_chunks",
                                                              "ref_chunks", "sent_bytes")}},
            reprefills_on_migration=s1["prefills"] - prefills_s1,
            killed_at_round=KILL_AT_ROUND, kill_rc=rc, recover_s=recover_s, resumed=resumed,
            resumed_at_done={e["req"]: e["done"] for e in router.events
                             if e["kind"] == "resume"},
            counters_s1=s1, launches=launches, launches_by_worker=after_admit,
            nvidia_smi_compute_apps=memory, transcripts_equal_in_process=True, fsck=fsck,
            hop_root_empty=True)
    finally:
        router.close()
        sup.shutdown()

    # the CLI's routed mode: the same transcripts as --workers 0
    t0 = time.perf_counter()
    routed = launch_serve.main(SERVE_ARGV + ["--workers", "2"])
    routed_s = time.perf_counter() - t0
    assert routed["transcripts"] == local["transcripts"]
    out["cli_workers_2"] = {k: routed[k] for k in ("mode", "prefill_tok_s", "decode_tok_s",
                                                    "ttft_p50_s", "ttft_max_s")}
    out["cli_workers_2"].update(wall_s=routed_s, transcripts_equal_workers_0=True)
    return out


# ---------------------------------------------------------------------------
# phase 9: the chaos matrix's tour cells against cuda workers
# ---------------------------------------------------------------------------


def run_chaos(dev) -> dict:
    """Three tour cells of the port's chaos matrix on workers on the card;
    a cell that breaks an invariant raises."""
    from repro_torch.chaos import matrix

    cells = {}
    for cell_id in CHAOS_CELLS:
        cell = next(c for c in matrix.CELLS if c["id"] == cell_id)
        t0 = time.perf_counter()
        matrix.run_cell(cell, device=str(dev))
        cells[cell_id] = {"s": time.perf_counter() - t0, "verdict": "ok"}
    return {"cells": cells, "device": str(dev)}


# ---------------------------------------------------------------------------
# phase 10: training — the Fig. 7 launcher on qwen3-1.7b, preempted and resumed
# ---------------------------------------------------------------------------


def state_bytes(cfg) -> int:
    """Bytes of the train state of ``cfg`` (params, master, moments)."""
    from repro_torch.distributed.steps import state_specs
    from repro_torch.optim import AdamWConfig
    from repro_torch.utils import flatten_with_paths

    flat, _ = flatten_with_paths(state_specs(cfg, AdamWConfig(moment_dtype=cfg.opt_moment_dtype)))
    return sum(math.prod(s.shape) * torch.empty((), dtype=s.dtype).element_size()
               for s in flat.values())


def train_depth(cfg, free_bytes: int, budget: int) -> int:
    """The config's depth, or the most layers whose three train-state CMIs
    (B's two, A's one) fit ``budget`` bytes of writes, two of them (the
    phase keeps two at a time) in ``free_bytes`` with 10 % to spare: a cut
    of depth, never of width."""
    for layers in range(cfg.n_layers, 0, -1):
        nbytes = state_bytes(cfg.with_(n_layers=layers))
        if 3 * nbytes <= budget and 2.2 * nbytes <= free_bytes:
            return layers
    raise RuntimeError(f"no depth of {cfg.name} fits {free_bytes} free bytes and "
                       f"{budget} bytes of writes")



def _launch_train(root: Path, name: str, store: Path, arch: str, extra: list[str]) -> list[dict]:
    """One launcher process on the card; its --metrics records."""
    metrics, log = root / f"{name}.jsonl", root / f"{name}.log"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p)}
    with open(log, "w") as out:
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *train_argv(arch),
                               *extra, "--store", str(store), "--metrics", str(metrics)],
                              stdout=out, stderr=subprocess.STDOUT, env=env, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"train run {name} exited {proc.returncode}:\n"
                           + log.read_text()[-4000:])
    return [json.loads(ln) for ln in metrics.read_text().splitlines()]


def _digests(man) -> dict:
    return {path: [c.hash for c in entry.chunks] for path, entry in man.arrays.items()}


def train_step_flops(cfg) -> int:
    """Model FLOPs of one step at the phase's shape, by the launcher's own
    count (6 N T with N the active parameters, plus attention)."""
    from repro_torch.launch.train import step_flops

    return step_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)


def run_train(root: Path, arch: str = TRAIN_ARCH, budget: int = TRAIN_WRITE_BUDGET) -> dict:
    """Run B (reclaimed at step 2, resumed) then run A (uninterrupted), one
    launcher process each on one job store; B's step-2 CMI is dropped once
    B has finished, so the disk holds two train states at a time."""
    from repro_torch.checkpoint import SaveOptions, load_checkpoint, load_manifest, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core import JobStore

    root.mkdir(parents=True, exist_ok=True)
    cfg = get_config(arch)
    free = shutil.disk_usage(root).free
    layers = train_depth(cfg, free, budget)
    extra = [] if layers == cfg.n_layers else ["--layers", str(layers)]
    cfg = cfg.with_(n_layers=layers)
    store = root / "jobs"
    gc.collect()
    torch.cuda.empty_cache()  # the launchers need the card's memory

    t0 = time.perf_counter()
    rec = {"B": _launch_train(root, "B", store, arch,
                              extra + ["--preempt-at", str(TRAIN_PREEMPT_AT)])}
    wall = {"B": time.perf_counter() - t0}
    js = JobStore(store)
    end = {"B": rec["B"][-1]}
    job = {"B": js.read_job(end["B"]["job_id"])}
    stats = {cmi: load_manifest(js.cmi_root(job["B"].job_id), cmi).extra["stats"]
             for cmi in (r["cmi"] for r in rec["B"] if r["event"] == "publish")}
    js.gc_cmis(job["B"].job_id, keep_last=1)
    t0 = time.perf_counter()
    rec["A"] = _launch_train(root, "A", store, arch, extra)
    wall["A"] = time.perf_counter() - t0
    end["A"] = rec["A"][-1]
    job["A"] = js.read_job(end["A"]["job_id"])
    man = {k: load_manifest(js.cmi_root(job[k].job_id), job[k].cmi) for k in "AB"}
    stats.update({r["cmi"]: load_manifest(js.cmi_root(job["A"].job_id), r["cmi"]).extra["stats"]
                  for r in rec["A"] if r["event"] == "publish"})

    # B's final state, bitwise A's: equal chunk digests, and published into
    # A's job it finds every chunk there
    assert man["A"].step == man["B"].step == TRAIN_STEPS
    assert _digests(man["A"]) == _digests(man["B"]), "resumed state differs from uninterrupted"
    assert man["A"].arrays["rng"].dtype == "uint32"
    t0 = time.perf_counter()
    b_state, _ = load_checkpoint(js.cmi_root(job["B"].job_id), job["B"].cmi)
    republished = save_checkpoint(js.cmi_root(job["A"].job_id), "republish-b", b_state,
                                  step=TRAIN_STEPS, options=SaveOptions(cas=True))
    republish_s = time.perf_counter() - t0
    del b_state
    assert republished.extra["stats"]["written_bytes"] == 0, republished.extra["stats"]

    leases = {k: [h["event"] for h in job[k].history if h["event"].startswith("leased:")]
              for k in "AB"}
    assert job["A"].status == job["B"].status == "finished"
    assert (len(leases["A"]), len(leases["B"])) == (1, 2), leases
    assert end["A"]["incarnations"] == 1 and end["B"]["incarnations"] == 2
    steps = {k: [(r["step"], r["loss"]) for r in rec[k] if r["event"] == "step"] for k in "AB"}
    assert steps["A"] == steps["B"] and len(steps["A"]) == TRAIN_STEPS, steps
    assert all(math.isfinite(loss) for _, loss in steps["A"])
    starts = [(r["resumed"], r["step"]) for r in rec["B"] if r["event"] == "start"]
    assert starts == [(False, 0), (True, TRAIN_PREEMPT_AT)], starts
    per_run = 2 * TRAIN_STEPS * cfg.n_layers  # forward + remat recompute, every layer
    for k in "AB":
        launched = end[k]["launches"]
        assert launched == {"flash_attention": per_run, "flash_attention_wgmma": per_run,
                            "flash_attention_lse": per_run}, (k, launched)

    step_s = {k: [r["s"] for r in rec[k] if r["event"] == "step"] for k in "AB"}
    median_s = statistics.median(step_s["A"][1:])  # steps 2-4: step 1 warms up
    flops = train_step_flops(cfg)
    assert all(r["model_flops_per_step"] == flops for k in "AB" for r in rec[k]
               if r["event"] == "start")
    publish = {k: [{"step": r["step"], "s": r["s"], "cmi": r["cmi"],
                    "written_bytes": stats[r["cmi"]]["written_bytes"],
                    "objects_written": stats[r["cmi"]]["objects_written"]}
                   for r in rec[k] if r["event"] == "publish"] for k in "AB"}
    restart = next(r for r in rec["B"] if r["event"] == "start" and r["resumed"])
    state_nbytes = sum(e.nbytes for e in man["B"].arrays.values())
    return {
        "config": {"arch": arch, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                   "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim],
                   "d_ff": cfg.d_ff, "vocab": cfg.vocab, "dtype": cfg.dtype,
                   "remat": cfg.remat, "loss_chunk": cfg.loss_chunk,
                   "params": cfg.param_count(), "active_params": cfg.active_param_count(),
                   **({"experts": [cfg.n_experts, cfg.top_k, cfg.resolved_moe_d_ff],
                       "capacity_factor": cfg.capacity_factor} if cfg.moe else {}),
                   "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
                   "steps": TRAIN_STEPS, "preempt_at": TRAIN_PREEMPT_AT},
        "depth_cut": None if not extra else {"layers": layers, "of": get_config(arch).n_layers},
        "disk_free_before_bytes": free, "state_bytes": state_nbytes,
        "write_budget_bytes": budget,
        "bitwise_equal": True, "losses": [loss for _, loss in steps["A"]],
        "step_s": step_s, "step_s_median_2_4": median_s,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / median_s,
        "model_flops_per_step": flops, "model_tflops": flops / median_s / 1e12,
        "model_flops_share_of_bf16_peak": flops / median_s / BF16_FLOPS,
        "publish": publish, "restart_s": restart["s"], "restart_bytes": state_nbytes,
        "republish_b_into_a": {"written_bytes": 0, "s": republish_s,
                               "chunks": republished.extra["stats"]["chunks"]},
        "wall_s": wall, "peak_memory_bytes": {k: end[k]["peak_memory_bytes"] for k in "AB"},
        "incarnations": {k: end[k]["incarnations"] for k in "AB"}, "leases": leases,
        "launches": {k: end[k]["launches"] for k in "AB"},
    }


def profile_train(dev, layers: int, arch: str = TRAIN_ARCH) -> dict:
    """Train steps at the phase's shape in this process (not deterministic
    mode; nothing published): one to warm up, three timed (their median,
    tokens/s, model TFLOP/s, peak memory), then one profiled: device time by
    kernel group (:func:`device_groups`: K3's backward, AdamW and the MoE
    phases by their ranges), the device's idle share, K3 launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed.steps import batch_to_device, make_init_fn, make_train_step
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.optim import AdamWConfig

    cfg = get_config(arch).with_(n_layers=layers)
    opt_cfg = AdamWConfig(moment_dtype=cfg.opt_moment_dtype)
    state = make_init_fn(cfg, opt_cfg, seed=0, device=dev)()
    step = make_train_step(cfg, opt_cfg, peak_lr=3e-3, warmup=5, total_steps=TRAIN_STEPS)
    pipe = TokenPipeline(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batch = batch_to_device(pipe.batch_at({"data_step": 0, "seed": 0})[0], dev)
    unprofiled = []
    for _ in range(4):  # the first warms up
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        unprofiled.append(time.perf_counter() - t0)
    before = flash_attention.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    k3_launches = flash_attention.launches - before
    assert k3_launches == 2 * layers, k3_launches  # forward + remat recompute, every layer
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    split = device_groups(prof)
    device, busy = split["device"], split["busy_us"]
    k3_kernels = sum("flash_fwd_kernel" in e.name for e in device)
    k3_wgmma = sum("flash_fwd_kernel_wgmma" in e.name for e in device)
    assert k3_wgmma == k3_kernels > 0, (k3_wgmma, k3_kernels)  # all on the tensor cores
    step_s = statistics.median(unprofiled[1:])
    flops = train_step_flops(cfg)
    return {"n_layers": cfg.n_layers, "unprofiled_step_s": unprofiled,
            "step_s_median_2_4": step_s, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
            "model_flops_per_step": flops, "model_tflops": flops / step_s / 1e12,
            "model_flops_share_of_bf16_peak": flops / step_s / BF16_FLOPS,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
            "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3, "device_idle_share": 1 - busy / wall_us,
            "kernel_launches": len(device), "k3_launches": k3_launches,
            "k3_kernels_in_trace": k3_kernels, "k3_wgmma_kernels_in_trace": k3_wgmma,
            "groups_ms": split["groups_ms"], "top_kernels_ms": split["top_kernels_ms"]}


def check_k3_training(dev, arch: str = TRAIN_ARCH, gradients: bool = True) -> dict:
    """K3 with lse against its plain version at ``arch``'s heads and the
    training shape; its time with and without lse, SDPA's forward (saving
    its lse for a backward) and backward, and the plain attention backward,
    at the serve and the training shapes; then (``gradients``) a 2-layer
    float32 model's gradients with K3 against plain attention under
    autograd."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import Model
    from repro_torch.models import attention as attn
    from repro_torch.utils import flatten_with_paths

    cfg = get_config(arch)
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    out = {}
    for label, b in (("serve_shape", 1), ("train_shape", TRAIN_BATCH)):
        rng = np.random.default_rng(b)
        q, k, v, dout = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
            dev, torch.bfloat16) for shape in ((b, h, TRAIN_SEQ, d), (b, hkv, TRAIN_SEQ, d),
                                              (b, hkv, TRAIN_SEQ, d), (b, h, TRAIN_SEQ, d)))
        got, lse = flash_ops._forward(q, k, v, True, 0, None, True)
        assert torch.equal(got, flash_ops.flash_attention(q, k, v, causal=True))
        t0 = time.perf_counter()
        want, want_lse = flash_ops.flash_attention_plain(q, k, v, causal=True, return_lse=True)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        lse_err = float((lse - want_lse).abs().max())
        assert lse_err <= LSE_TOL, lse_err
        rounding = one_bf16_rounding(got, flash_ops.flash_attention_plain(
            q.float(), k.float(), v.float(), causal=True))
        t0 = time.perf_counter()
        grads = flash_ops.flash_attention_backward_plain(q, k, v, got, lse, dout)
        torch.cuda.synchronize()
        bwd_first_ms = (time.perf_counter() - t0) * 1e3
        assert all(torch.isfinite(g).all() for g in grads)
        del grads
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        sdpa = F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)
        pairs = visible_pairs(TRAIN_SEQ, TRAIN_SEQ, True, 0)
        fwd_flops, bwd_flops = 4 * b * h * d * pairs, 10 * b * h * d * pairs
        nbytes = (2 * b * h + 2 * b * hkv) * TRAIN_SEQ * d * 2
        out[label] = {
            "shape": f"q bf16[{b},{h},{TRAIN_SEQ},{d}], k/v bf16[{b},{hkv},{TRAIN_SEQ},{d}], causal",
            "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL,
            "rounding_limit_use": rounding["rounding_limit_use"],
            "ms": cuda_ms(lambda: flash_ops._forward(q, k, v, True, 0, None, False), 20),
            "lse_ms": cuda_ms(lambda: flash_ops._forward(q, k, v, True, 0, None, True), 20),
            "lse_kernel_only_ms": profiled_ms(
                lambda: flash_ops._forward(q, k, v, True, 0, None, True),
                "flash_fwd_kernel_wgmma", 20),
            "plain_ms": plain_ms,
            "library_sdpa_forward_with_lse_ms": cuda_ms(
                lambda: F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True),
                20),
            "library_sdpa_backward_ms": cuda_ms(
                lambda: torch.autograd.grad(sdpa, leaves, dout, retain_graph=True), 10),
            "attention_backward_plain_ms": cuda_ms(
                lambda: flash_ops.flash_attention_backward_plain(q, k, v, got, lse, dout), 3),
            "attention_backward_plain_first_ms": bwd_first_ms,
            "forward_bound_ms": max(fwd_flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3,
            "backward_bound_ms": max(bwd_flops / BF16_FLOPS,
                                     (nbytes * 2 + b * h * TRAIN_SEQ * (d * 2 + 4))
                                     / HBM_BYTES_PER_S) * 1e3,
            "backward_bound_by": "operations",
        }
        del q, k, v, dout, got, lse, want, want_lse, leaves, sdpa
        torch.cuda.empty_cache()
    if not gradients:
        return out

    # the model's gradients with K3 (float32: the CUDA-core kernel) against
    # plain attention differentiated by autograd, same weights and batch
    small = cfg.with_(n_layers=2, dtype="float32")
    model = Model(small)
    params = model.init(torch.Generator(dev).manual_seed(0))
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, small.vocab, (1, TRAIN_SEQ + 1))).to(dev)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def loss_and_grads():
        flat, treedef = flatten_with_paths(params)
        leaves = {key: t.detach().requires_grad_(True) for key, t in flat.items()}
        loss = model.loss(treedef.unflatten(leaves), batch)
        return loss, dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    before = flash_ops.flash_attention.lse_launches
    loss, grads = loss_and_grads()
    k3_runs = flash_ops.flash_attention.lse_launches - before
    assert k3_runs == 2 * small.n_layers, k3_runs
    kernel = attn.flash_attention
    attn.flash_attention = flash_ops.flash_attention_plain  # autograd through plain torch
    try:
        want_loss, want = loss_and_grads()
    finally:
        attn.flash_attention = kernel
    worst = {key: float((g - want[key]).abs().max() / want[key].abs().max().clamp(min=1e-30))
             for key, g in grads.items()}
    assert max(worst.values()) <= GRAD_TOL, worst
    out["model_gradients"] = {
        "config": "qwen3-1.7b widths, 2 layers, float32, B1 S2048", "loss": float(loss.detach()),
        "loss_plain_attention": float(want_loss.detach()), "k3_launches": k3_runs,
        "max_rel_err": max(worst.values()), "worst_leaf": max(worst, key=worst.get),
        "tol": f"{GRAD_TOL} of each gradient's max"}
    del params, grads, want
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card here; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.colocate import ops as colocate_ops
    from repro_torch.kernels.delta_encode import ops as delta_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import serve as launch_serve

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda, device=kind,
         count=torch.cuda.device_count(), nvidia_smi=smi, python=sys.version.split()[0],
         clocks_sm_and_max=nvidia_smi("clocks.sm,clocks.max.sm"),
         disk_free_bytes=shutil.disk_usage(ROOT).free, proc_io_write_bytes=proc_write_bytes())
    disk = DiskWrites()

    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    ptxas = {name: ptxas_entries(_build.ptxas_report(name)) for name in _build.SOURCES}
    k3_wgmma = {entry: v for entry, v in ptxas["flash_attention"].items()
                if "flash_fwd_kernel_wgmma" in entry}  # D = 64 and 128
    k3_spills = sum(v["spill_stores"] + v["spill_loads"] for v in k3_wgmma.values())
    k2_entry = {entry: v for entry, v in ptxas["colocate"].items() if "colocate_kernel" in entry}
    k2_spills = sum(v["spill_stores"] + v["spill_loads"] for v in k2_entry.values())
    emit("build", seconds=build_s, sources=list(_build.SOURCES), ptxas=ptxas,
         k2_spill_bytes=k2_spills, k3_wgmma_spill_bytes=k3_spills,
         disk=disk.mark("build", dir_bytes(ROOT / "build" / "kernels")))
    emit("navlint", **run_navlint(), disk=disk.mark("navlint", 0))

    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    try:
        from repro_torch.core import colocation as co

        geo = co.stage_geometry(co.stage_read({}, device=dev, seed=0, **GRANULES))
        k1 = check_delta_encode(dev)
        k2 = check_colocate(dev, geo)
        del geo
        k3 = check_flash_attention(dev)
        emit("kernels", delta_encode=k1, colocate=k2, flash_attention=k3,
             disk=disk.mark("kernels", 0))

        # the main path: counts from 0 just before, read just after
        delta_ops.changed_blocks.launches = 0
        colocate_ops.colocate_match.launches = 0
        itin = run_itinerary(work / "itinerary", dev, preempt=True, via="store")
        calm = run_itinerary(work / "calm", dev, preempt=False, via="live")
        launches_itin = {"delta_encode": delta_ops.changed_blocks.launches,
                         "colocate": colocate_ops.colocate_match.launches}
        publishes = run_publish_with_hints(work / "publish", dev)
        launches = {"delta_encode": delta_ops.changed_blocks.launches,
                    "colocate": colocate_ops.colocate_match.launches}
        product = check_product(itin, calm, dev)
        assert itin["incarnations"] == 2 and calm["incarnations"] == 1
        emit("itinerary", incarnations=itin["incarnations"], traces=itin["traces"],
             wall_s=itin["wall_s"], breakdown=itin["spent"],
             uninterrupted_wall_s=calm["wall_s"], uninterrupted_breakdown=calm["spent"],
             fsck=itin["fsck"],
             published=itin["cmis"], product=product, launches=launches_itin)
        emit("publish", publishes=publishes,
             launches={k: launches[k] - launches_itin[k] for k in launches},
             disk=disk.mark("itinerary+publish", sum(dir_bytes(work / d) for d in
                                                     ("itinerary", "calm", "publish"))))
        assert launches["delta_encode"] > launches_itin["delta_encode"] >= 0
        assert launches["colocate"] > 0

        # the fabric path: run_fabric sets the counts (here and in each
        # worker) to 0 just before each of its runs and reads them just after
        fab = run_fabric(work / "fabric", dev, calm)
        by_path = {"itinerary+publish": dict(launches),
                   "fabric": {k: sum(fab[run]["launches"][k]
                                     for run in ("calm", "calm_warm", "interrupted", "delta"))
                              for k in ("delta_encode", "colocate")}}
        for k in ("delta_encode", "colocate"):
            launches[k] += by_path["fabric"][k]
        emit("fabric", workers=fab["workers"], startup_s=fab["startup_s"],
             nvidia_smi_compute_apps=fab["nvidia_smi_compute_apps"], calm=fab["calm"],
             calm_warm=fab["calm_warm"],
             interrupted=fab["interrupted"], delta=fab["delta"], launches=by_path["fabric"],
             store_hop_tour_wall_s=itin["wall_s"], live_tour_wall_s=calm["wall_s"],
             disk=disk.mark("fabric", dir_bytes(work / "fabric")))
        assert by_path["fabric"]["colocate"] == 3 and by_path["fabric"]["delta_encode"] > 0
        del fab

        # the serve path: counts from 0 just before, read just after
        delta_ops.changed_blocks.launches = 0
        colocate_ops.colocate_match.launches = 0
        flash_ops.flash_attention.launches = 0
        flash_ops.flash_attention.wgmma_launches = 0
        metrics = launch_serve.main(SERVE_ARGV)
        torch.cuda.synchronize()
        launches["flash_attention"] = flash_ops.flash_attention.launches
        by_path["serve"] = {"flash_attention": launches["flash_attention"]}
        serve_launches = {"delta_encode": delta_ops.changed_blocks.launches,
                          "colocate": colocate_ops.colocate_match.launches,
                          "flash_attention": launches["flash_attention"],
                          "flash_attention_wgmma": flash_ops.flash_attention.wgmma_launches}
        served = check_serve(metrics, dev)
        cfg = served["engine"].cfg
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                cfg.d_ff, cfg.vocab, cfg.dtype, cfg.tie_embeddings) == \
            (28, 2048, 16, 8, 128, 6144, 151936, "bfloat16", True), cfg
        n_layers = cfg.n_layers
        assert serve_launches == {"delta_encode": 0, "colocate": 0,
                                  "flash_attention": BATCH * n_layers,
                                  "flash_attention_wgmma": BATCH * n_layers}, serve_launches
        engine, req = served["engine"], served["requests"][0]
        resume = run_serve_resume(work / "serve", dev, engine, req, served["reference"][req["id"]])
        in_model = check_model_kernel_vs_plain(engine, req["prompt"])
        trace = profile_serve(engine, req["prompt"])
        emit("serve", **served["line"], resume=resume, kernel_vs_plain_in_model=in_model,
             where_the_time_goes=trace,
             launches=serve_launches, k3_launches_per_prefill=n_layers,
             peak_memory_bytes=torch.cuda.max_memory_allocated(),
             disk=disk.mark("serve", dir_bytes(work / "serve")))
        del served, engine

        # the MoE serve path: granite-moe-1b-a400m, counts from 0 just
        # before, read just after
        moe = run_serve_moe(work / "serve_moe", dev)
        launches["flash_attention"] += moe["launches"]["flash_attention"]
        by_path["serve_moe"] = {"flash_attention": moe["launches"]["flash_attention"]}
        emit("serve_moe", **moe, disk=disk.mark("serve_moe", dir_bytes(work / "serve_moe")))
        del moe

        # the serving fleet: each worker's counts set to 0 just before its
        # admits and read just after (K3 runs only inside the workers)
        fleet = run_serve_fleet(work / "fleet", dev, metrics)
        launches["flash_attention"] += fleet["launches"]["flash_attention"]
        by_path["serve_fleet"] = {"flash_attention": fleet["launches"]["flash_attention"]}
        emit("serve_fleet", **fleet, disk=disk.mark("serve_fleet", dir_bytes(work / "fleet")))
        del fleet
        emit("chaos", **run_chaos(dev), disk=disk.mark("chaos", 0))

        # the training path: each launcher process counts its own K3
        # launches from 0 and reports them at its end
        train = run_train(work / "train")
        for run in ("A", "B"):
            launches["flash_attention"] += train["launches"][run]["flash_attention"]
        by_path["train"] = {"flash_attention": sum(train["launches"][run]["flash_attention"]
                                                   for run in ("A", "B"))}
        from repro_torch.configs import get_config

        n_layers = get_config(TRAIN_ARCH).n_layers  # full depth: these write nothing
        torch.cuda.reset_peak_memory_stats(dev)
        train["full_depth_step"] = profile_train(dev, n_layers)
        train["k3"] = check_k3_training(dev)
        emit("train", **train, disk=disk.mark("train", train_files(work / "train", train)))
        shutil.rmtree(work / "train", ignore_errors=True)  # room for train_moe's states
        k3_train = train["k3"]
        del train

        # the MoE training path: granite through the launcher, each
        # process counting its own K3 launches from 0
        train = run_train(work / "train_moe", MOE_ARCH, MOE_TRAIN_WRITE_BUDGET)
        by_path["train_moe"] = {"flash_attention": sum(train["launches"][run]["flash_attention"]
                                                       for run in ("A", "B"))}
        launches["flash_attention"] += by_path["train_moe"]["flash_attention"]
        n_layers = get_config(MOE_ARCH).n_layers
        torch.cuda.reset_peak_memory_stats(dev)
        train["full_depth_step"] = profile_train(dev, n_layers, MOE_ARCH)
        train["k3"] = check_k3_training(dev, MOE_ARCH, gradients=False)
        emit("train_moe", **train,
             disk=disk.mark("train_moe", train_files(work / "train_moe", train)))
        k3_train_moe = train["k3"]
        del train
        total = disk.total()
        emit("disk", phases=disk.phases, total_written_bytes=total, limit_bytes=DISK_WRITE_LIMIT)
        assert total < DISK_WRITE_LIMIT, (total, disk.phases)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    assert len(k2_entry) == 1 and k2_spills == 0, k2_entry  # K2 spills nothing
    assert len(k3_wgmma) == 2 and k3_spills == 0, k3_wgmma  # the tensor-core K3 spills nothing
    rows = []
    parity = {"delta_encode": "bitmaps equal", "colocate": "idx equal, cos bitwise equal",
              "flash_attention": "within 2e-5 (f32) / 2e-2 (bf16) of the plain version; "
                                 "bf16 within one rounding (2**-8 |x| + 2e-5) of its "
                                 "float32 answer"}
    for k, name, replaces in (
            (k1, "delta_encode", "src/repro/kernels/delta_encode/delta_encode.py:48"),
            (k2, "colocate", "src/repro/kernels/colocate/colocate.py:66"),
            (k3, "flash_attention", "src/repro/kernels/flash_attention/flash_attention.py:120")):
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{name}.cu", "replaces": replaces,
                     "launches": launches[name],
                     "launches_by_path": {path: n[name] for path, n in by_path.items()
                                          if name in n},
                     "max_abs_err": k["max_abs_err"],
                     "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": k["library_ms"],
                     "kernel_ms": k["ms"], "kernel_only_ms": k["kernel_only_ms"],
                     "shape": k["shape"], "parity": parity[name],
                     **({"sass_per_pair": k["sass_per_pair"]} if "sass_per_pair" in k else {}),
                     **({"at_d64": k["at_d64"], "training": k3_train,
                         "training_d64": k3_train_moe} if name == "flash_attention" else {})})
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
