#!/usr/bin/env python3
"""Drive repro_torch's main path on one CUDA card and check every result.

Run from the root of a checkout: ``python3 chip_smoke.py`` (no arguments,
one card). It builds the CUDA kernels from ``src/repro_torch/kernels/csrc``
with nvcc and prints one JSON line per phase:

  env        torch / CUDA versions, the card, nvidia-smi's name, power limit
             and SM clocks (now and the most the card allows)
  build      nvcc wall time and each kernel's registers and spills from ptxas
             (K2, the tensor-core K3 and its backward's tensor-core
             kernels must spill nothing)
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
             granite-moe-1b-a400m's prefill shape (head dim 64) among them,
             and hymba-1.5b's (25 q / 5 kv heads, head dim 64, 4096 tokens,
             window 2048), its SDPA yardstick given the window as a mask;
             deepseek-v3's MLA prefill (128 heads, qk head dim 192, v 128;
             the tensor-core kernel's floor 2 D + 4 Dv a pair) and
             whisper-tiny's non-causal encoder (1,500 frames) and cross
             attention (2,048 tokens against 1,500 frames) and its decoder's
             causal self-attention (2,048 tokens, B 4, 6 heads)
  dryrun     ``python -m repro_torch.launch.dryrun`` for qwen3-1.7b's
             prefill_32k and decode_32k cells on a fake 16x1 cuda mesh (a
             16th of the batch and the whole model a device: the 1x1 run's
             program) and command-r's below on 16x16 (subprocesses;
             per-device FLOPs, bytes, collectives, peak memory), and
             qwen3's per-device steps run for real on a 1x1
             NCCL mesh at full width and depth: prefill 2 x 32,768 tokens
             (28 K3 launches, all tensor-core; logits and every cache leaf
             bitwise ``Model.prefill``'s), decode 8 sequences over a
             32,768-deep cache at pos 32,767 (logits bitwise
             ``Model.decode``'s, the cache written only at pos); each real
             step's counted FLOPs within 0.1 % of the dry run's; times,
             TFLOP/s, bytes against the card's bound, peak memory beside the
             dry run's (at a model axis of 1 the tensor-parallel steps are
             the plain model); then command-r-plus-104b at full width
             (depth cut: 32 and 16 of 64 layers), rank 0 of a fake 16x16
             group on real card tensors (its collectives move no bytes and
             leave their outputs unwritten, so no output is compared and no
             time counts communication): its tensor-parallel prefill_32k (2
             x 32,768 tokens, 6 q heads reading 1 kv head: one tensor-core
             K3 launch a layer) and train_4k step with ``seq_shard`` (16 x
             4,096 tokens); and the MoE family on its shards the same way:
             deepseek-v3's prefill_32k (8 of 128 MLA heads, K3 at qk 192 /
             v 128; 1 of 256 experts a MoE layer, the slots moved by
             all-to-all) and train_4k with ``seq_shard`` and
             ``moe_buf_shard``, each at 8 of 61 layers (its 3 dense and 5
             MoE), granite's prefill_32k (24 layers, 2 of 32 experts a rank
             over the model axis); each with its peak memory (below the
             card's, within 2 % of the dry run's net of what the process
             held beyond the step's arguments, which may not pass 200 MB)
             beside the dry run's, device time and TFLOP/s of
             the dry run's per-device FLOPs
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
             ``launch.serve.main(--workers 2)`` on two of the requests, 8
             tokens each, against ``--workers 0``'s first 8
  chaos      three cells of ``repro_torch.chaos.matrix`` with cuda workers
             (a ``hop.*`` kill, a relay kill, a SIGKILL at stream accept),
             each through the matrix's CLI, the three at once and beside
             the CLI's ``--workers 2`` run: each product bitwise the calm
             run's, ``hop_root`` empty
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
             K3 with lse against its plain version and against SDPA; its
             backward kernels against the plain attention backward at every
             such shape (within 1e-2, two calls bitwise; within one bf16
             rounding plus 2**-10 of each gradient's RMS of its float32
             answer, which a planted skipped key tile breaks), timed beside
             it and SDPA's backward; a 2-layer float32 model's gradients with K3
             (the CUDA-core backward) against plain attention under autograd;
             in every train phase and per-device train cell one tensor-core
             backward launch a layer a step
  train_moe  the same two launcher runs for granite-moe-1b-a400m (the runs
             keep 4 of 24 layers, widths kept), K3 with lse at head dim 64
  serve_hybrid  hymba-1.5b at full width (32 layers of windowed attention
             in parallel with SSD heads): 4 requests of 4096 prompt tokens,
             past the 2048-token window, and 32 generated; 4 x 32 K3
             launches, all tensor-core, each with the window; transcripts
             equal ``run_reference``'s; one request resumed with zero
             re-prefill from a CMI holding its SSD states; one hybrid layer
             on the card against the float32 CPU path; where the time goes
  train_hybrid  the two launcher runs for hymba at 2 x 4096 tokens a step
             (the runs keep 1 of 32 layers), every loss finite; K3 with lse
             at its heads and window
  xlstm      xlstm-1.3b at full width (48 mLSTM layers, no attention, no
             TPU kernel): served as the serve phase is, transcripts equal,
             one request resumed with zero re-prefill from its 202 MB mLSTM
             state; training steps in this process at 12 of its 48 layers
  serve_mla  deepseek-v3-671b at full width, its depth cut to 4 layers (3
             dense, 1 MoE of 256 experts, top 8, sigmoid routing, 1 shared;
             15.1 B parameters) through ``launch.serve.main --layers 4``:
             4 x 4 K3 launches, all tensor-core at qk 192 / v 128;
             transcripts equal ``run_reference``'s; one request resumed
             with zero re-prefill from its latent cache; prefill logits
             with K3 against the plain attention; one dense MLA layer and
             the MoE layer on the card against the float32 CPU path; where
             the time goes (K3, the MLA projections, the MoE dispatch,
             expert GEMMs)
  train_encdec  whisper-tiny at full width (4 encoder + 4 decoder layers,
             1,500 frames a sample, not cut) through the launcher at 4 x
             2048 tokens: B reclaimed after step 2 and resumed bitwise A's,
             K3 with lse in every encoder, self and cross attention of the
             forward and its recompute; a profiled step in this process
  examples   ``examples/torch_quickstart.py --device cuda`` in a process of
             its own: reclaimed at step 17, resumed, the job finished
  disk       the bytes each phase wrote (``/proc/self/io`` where the kernel
             counts them, else the files left), held under 40 GiB: the chip
             machine takes at most 45 GiB of writes a call

then the summary line ``{"kernels": [...]}`` with the launches each kernel
made on its main paths (K1 and K2: the itinerary, publish and fabric phases,
the fabric's counted inside the workers too; K3: the vision and dryrun
phases' prefills, the serve, serve_moe,
serve_hybrid and serve_mla phases' ``main``, the serving workers' prefills
and the training runs of the four attention models, each counted inside
its launcher process; K3's backward, a row of its own: the train phases,
the mesh, the dryrun phase's per-device train steps and the in-process
vision and whisper steps), the nvidia-smi line, and last
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
BWD_BF16_TOL = 1e-2  # K3's backward against the plain one in bf16: tests/test_torch_cuda.py's
# K3's backward against the plain one's float32 answer: one bf16 rounding,
# 2**-8 |x|, plus this share of the gradient's RMS for the float32 sums
# where x cancels to ~0 (2**-12 left the kernels at up to 0.9989 of the
# limit, about what the rounding alone reaches over millions of elements)
BWD_ATOL_RMS = 2.0 ** -10
BF16_ROUNDING = 2.0 ** -8  # one round to nearest bf16 moves x by at most 2**-8 |x|
# the serve phase: qwen3-1.7b at full width, the CLI's requests, and the
# request published and resumed; serve_moe the same for granite-moe-1b-a400m
SERVE_ARCH = "qwen3-1.7b"
SERVE_SPEC = f"model:{SERVE_ARCH}:full:seed=0"
MOE_ARCH = "granite-moe-1b-a400m"
MOE_SERVE_SPEC = f"model:{MOE_ARCH}:full:seed=0"
PROMPT_LEN, GEN, BATCH = 2048, 32, 4
# serve_hybrid: hymba-1.5b's prompts pass its 2048-token attention window,
# so K3 runs windowed and decode's rolling cache wraps; xlstm the mLSTM
HYBRID_ARCH = "hymba-1.5b"
HYBRID_SERVE_SPEC = f"model:{HYBRID_ARCH}:full:seed=0"
HYBRID_PROMPT_LEN = 4096
XLSTM_ARCH = "xlstm-1.3b"
XLSTM_SERVE_SPEC = f"model:{XLSTM_ARCH}:full:seed=0"
# serve_mla: deepseek-v3's widths, depth cut to its 3 dense layers and one
# MoE layer (15.1 B parameters, 30.2 GB in bf16; its 61 layers would not fit)
MLA_ARCH, MLA_LAYERS = "deepseek-v3-671b", 4
MLA_SERVE_SPEC = f"model:{MLA_ARCH}:full:layers={MLA_LAYERS}:seed=0"
MLA_ON_CARD_TOKENS = 256  # the MLA layer checked against the float32 CPU path
# deepseek's MoE layer on the card against the float32 CPU path at a
# 512-token prefill group (capacity 20, still overflowed by the favoured
# experts), cut from 2048 for the smoke's time: the host's float32 copy of
# all 256 experts (45 GB) and its passes over it are most of the check
MLA_MOE_ON_CARD_TOKENS = 512
# train_encdec: whisper-tiny, 4 x 2048 decoder tokens and 4 x 1500 frames
ENCDEC_ARCH = "whisper-tiny"
VISION_ARCH = "internvl2-76b"
VISION_LAYERS = 8  # the prefill/decode model's depth cut (of 80); widths are the config's
VISION_PROMPT, VISION_DECODE = 2048, 8  # tokens after the 256 patch embeddings; decode steps
DRYRUN_ARCH = "qwen3-1.7b"
DRYRUN_SHAPES = ("prefill_32k", "decode_32k")
DRYRUN_DATA_RANKS = 16  # the 16x16 production mesh's data axis: a device's share of the batch
# qwen3's cells are traced on a 16x1 mesh: the per-device step of the 1x1
# real run (a 16th of the batch, the whole model; on 16x16 the model axis
# would split the work 16 ways)
DRYRUN_MESH = f"{DRYRUN_DATA_RANKS}x1"
DRYRUN_FLOPS_TOL = 1e-3  # the real step's counted FLOPs against the dry run's, relative
# the tensor-parallel cells run for real under a fake 16x16 group: (shape,
# seq_shard, layers). Their depth is cut (their widths kept) to keep the
# smoke inside its time limit: the train cell's 64 layers take 16.3 s a step
# on the card and the smoke ran 1095 s with them, 1013 s with 32; with the
# MoE cells below it ran 1127 s, so the prefill runs 32 of 64 layers too;
# at 64 layers each peak was the dry run's
DRYRUN_TP_ARCH = "command-r-plus-104b"
DRYRUN_TP_CELLS = (("prefill_32k", False, 32), ("train_4k", True, 16))
# the MoE family on its shards under the same fake 16x16 group: (arch,
# shape, seq_shard, moe_buf_shard, layers). deepseek-v3 at its widths (8 of
# 128 MLA heads, 1 of 256 experts a rank), each step cut to its 3 dense
# layers and 5 MoE layers (the dry run's trace of the 61-layer train step
# takes ~54 s of CPU, which the phase would wait for; the prefill ran 5.5-5.9
# s at 61 layers, within 0.04 % of the dry run's peak, and the smoke took
# 1157 s with it); granite through all 24 layers (2 of 32 experts a rank,
# over the model axis)
DRYRUN_MOE_CELLS = (("deepseek-v3-671b", "prefill_32k", False, False, 8),
                    ("deepseek-v3-671b", "train_4k", True, True, 8),
                    ("granite-moe-1b-a400m", "prefill_32k", False, False, 0))
# the hybrid, mLSTM and encoder-decoder families on their shards under the
# same fake 16x16 group: (arch, shape, seq_shard, moe_buf_shard, layers).
# hymba's 25 heads, xlstm's 4 and whisper's 6 do not divide 16, so each
# device runs its mixers whole (on the gathered sequence under seq_shard)
# and its MLP and vocab split where they divide; hymba's prefill through
# all 32 layers, its train step and xlstm's cut to 4 layers for the smoke's
# time, whisper's through all 4 + 4
DRYRUN_MIXER_CELLS = (("hymba-1.5b", "prefill_32k", False, False, 0),
                      ("hymba-1.5b", "train_4k", True, False, 4),
                      ("whisper-tiny", "train_4k", True, False, 0),
                      ("xlstm-1.3b", "train_4k", True, False, 4))
DRYRUN_PEAK_TOL = 0.02  # a sharded cell's peak on the card against its dry run's count
# what a sharded cell's process may hold beyond its step's arguments (cuBLAS's
# workspaces, ~70 MB, which the dry run does not count); more is a leak
DRYRUN_HELD_MAX = 200 * 10**6


def serve_argv(arch: str, prompt_len: int = PROMPT_LEN, layers: int = 0) -> list[str]:
    return ["--arch", arch, "--prompt-len", str(prompt_len), "--gen", str(GEN),
            "--batch", str(BATCH), "--seed", "0", "--device", "cuda",
            *(["--layers", str(layers)] if layers else [])]


SERVE_ARGV = serve_argv(SERVE_ARCH)
# the serve CLI's routed mode (--workers 2) after the fleet phase: 2 of the
# requests, 8 tokens each (every request's 32 took 77 s on one H100 host)
CLI_FLEET_BATCH, CLI_FLEET_GEN = 2, 8
# decode steps in each serve phase's profile (cut from 8 for the smoke's time)
SERVE_PROFILE_STEPS = 4
PUBLISH_EVERY = 16
DROP_AT_DONE = 24  # the first host is dropped here; its last publish is at done 17
# the serving fleet: two workers, a live migration after 8 rounds, a SIGKILL at 20
FLEET_PUBLISH_EVERY, WARM_AT_ROUND, HANDOFF_AFTER, KILL_AT_ROUND = 8, 8, 4, 20
# the chaos phase: a hop.* kill, a relay kill and a SIGKILL at stream
# accept (115.7 s alone on one H100 host, so the cells run beside the
# serve CLI's routed mode)
CHAOS_CELLS = ("hop.before_restore:sigkill", "relay.mid_stream:kill_conn",
               "hop_stream.accept:sigkill")
# the train phase: qwen3-1.7b through the launcher, 4 steps of 4 x 2048
# tokens, run B reclaimed after step 2 (8,192 tokens a step; the train state
# is ~24.1 GB, so each publish writes that much)
TRAIN_ARCH, TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_PREEMPT_AT = "qwen3-1.7b", 4, 2048, 4, 2
# train_hybrid: hymba at 2 x 4096 (8,192 tokens a step too), so the window
# binds in the training forward
HYBRID_TRAIN_SEQ, HYBRID_TRAIN_BATCH = 4096, 2


def train_argv(arch: str, seq: int = TRAIN_SEQ, batch: int = TRAIN_BATCH) -> list[str]:
    return ["--arch", arch, "--steps", str(TRAIN_STEPS), "--seq-len", str(seq),
            "--batch", str(batch), "--publish-every", str(TRAIN_STEPS), "--seed", "0",
            "--device", "cuda", "--log-every", "1"]


# The chip machine's disk takes at most 45 GiB of writes a call, deleted or
# not; the other phases take ~4 GB of it (the fleet's cache publishes most),
# and the three train-state CMIs of each model's two runs (14 bytes a
# parameter: ~24.1 GB each for qwen3 at 28 layers) would take far more. So
# each model's runs cut depth (never width) to the most layers whose three
# CMIs fit its budget: qwen3 2 of 28 (5.77 GB a CMI, 16.1 GiB for three),
# granite 4 of 24 (3.70 GB), hymba 1 of 32 (1.98 GB: its untied 32,001-row
# embeddings are most of it). The K3 checks, which write nothing, run at
# the models' full shapes. The smoke's own in-process full-depth steps
# were cut for its time (with them it took 1345 s of its 1200 on one H100
# host): qwen3's, granite's and hymba's; xlstm's, its only training step
# without a mesh, runs at XLSTM_STEP_LAYERS; whisper's at full depth.
XLSTM_STEP_LAYERS = 12
TRAIN_WRITE_BUDGET = 17 * 2**30
MOE_TRAIN_WRITE_BUDGET = 12 * 2**30
HYBRID_TRAIN_WRITE_BUDGET = 6 * 2**30
ENCDEC_TRAIN_WRITE_BUDGET = 3 * 2**30  # whisper's three 0.69 GB CMIs, not cut
# what the whole smoke may write (the machine's limit is 45 GiB a call)
DISK_WRITE_LIMIT = 40 * 2**30
# profiler ranges whose kernels form groups of their own
RANGES = {"flash_attention_backward": "K3 backward (flash_attention_bwd kernels)",
          "adamw_update": "optimizer (AdamW)",
          "moe_dispatch": "MoE dispatch (router, sort, searchsorted, gathers)",
          "moe_experts": "MoE expert GEMMs (bmm)",
          "moe_combine": "MoE combine (gather, ordered sum)",
          "mla": "MLA projections and absorbed decode",
          "linear_recurrence": "chunked linear recurrence (SSD, mLSTM)"}
GRAD_TOL = 1e-4  # tests/test_torch_train.py's float32 gradient tolerance (of each max)
LSE_TOL = 1e-4  # tests/test_torch_cuda.py's lse tolerance


START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, "elapsed_s": time.perf_counter() - START, **fields}),
          flush=True)


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


def profiled_ms(fn, kernel: str, reps: int, attempts: int = 3,
                per_call: int = 1) -> float | None:
    """Mean device time of one launch of the kernel named ``kernel`` while
    ``fn`` runs, from torch.profiler's device events (``per_call`` launches
    of kernels whose names hold ``kernel`` a call of ``fn``: their sum).
    Per recorded launch, since the profiler may drop the first. A session
    late in the smoke has recorded no device event at all where the same
    call early on did, so a session without one is tried again, up to
    ``attempts`` in all (None if none records any)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
              and kernel in e.name]
        if us and sum(us) > 0:
            return sum(us) / len(us) * per_call / 1e3
    return None


def ptxas_entries(log: str) -> dict:
    """Registers and spill bytes of each kernel in an ``nvcc -Xptxas -v``
    report, by mangled entry name, and the report's warnings, its notes of a
    performance loss among them (C7515, C7518: wgmmas serialized)."""
    out, cur = {"warnings": []}, None
    for ln in log.splitlines():
        if "warning" in ln.lower() or "Performance Loss" in ln:
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


def start_navlint() -> dict:
    """``python -m repro_torch.analysis --check --coverage`` over the port,
    as text and as JSON, started now (they need no card) and read by
    :func:`run_navlint`."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p)}
    argv = [sys.executable, "-m", "repro_torch.analysis", "--check", "--coverage",
            "src/repro_torch", "--docs", "docs/fabric.md"]
    return {"argv": argv, "t0": time.perf_counter(),
            **{key: subprocess.Popen(argv + extra, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
               for key, extra in (("text", []), ("json", ["--json"]))}}


def run_navlint(started: dict) -> dict:
    """The runs of :func:`start_navlint`: exit 0, no finding, the coverage
    cross-check (fire sites, ``SITES``, the chaos cells,
    ``docs/fabric.md``) included; then every fixture of
    ``tests/lint_fixtures`` gives exactly the findings its ``# EXPECT:``
    comments name (the reference's goldens; the CPU tests also hold them
    equal to the JAX package's navlint, which this script may not import),
    and the CLI's exit codes."""
    from collections import Counter

    from repro_torch.analysis import lint_paths, main as navlint_main

    argv = started["argv"]
    out, err = started["text"].communicate(timeout=300)
    seconds = time.perf_counter() - started["t0"]
    text = subprocess.CompletedProcess(argv, started["text"].returncode, out, err)
    assert text.returncode == 0 and "navlint: clean" in text.stdout, text.stdout + text.stderr
    out, err = started["json"].communicate(timeout=300)
    js = subprocess.CompletedProcess(argv, started["json"].returncode, out, err)
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


def bwd_rounding(grads, ref32) -> dict:
    """K3's backward (dq, dk, dv in bf16) against the plain backward's
    float32 answer on the same bf16-exact inputs: every element within one
    bf16 rounding of it, 2**-8 |x|, plus BWD_ATOL_RMS of that gradient's
    RMS (the float32 sums' and the bf16 hi + lo halves' own error, where
    an element cancels to ~0). At 2k-4k positions |dq|, |dk|, |dv| are
    ~0.02-0.05, so 1e-2 absolute would pass a skipped far key tile; this
    limit follows each gradient's values. ``not_f32_rounded_share``: the
    elements that differ from the float32 answer rounded to bf16."""
    out = {}
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref32):
        err = (g.float() - r).abs()
        rms = float(r.square().mean().sqrt())
        use = float((err / (BF16_ROUNDING * r.abs() + BWD_ATOL_RMS * rms)).max())
        out[name] = {"max_abs_err_vs_f32": float(err.max()), "rms": rms, "limit_use": use,
                     "not_f32_rounded_share": float((g != r.to(g.dtype)).float().mean())}
    out["limit"] = "2**-8 |x| + 2**-10 rms"
    out["limit_use"] = max(out[n]["limit_use"] for n in ("dq", "dk", "dv"))
    return out


def dq_without_key_tile(q, k, v, o, lse, dout, dq, causal: bool, win: int,
                        tile: int = 64) -> torch.Tensor:
    """A planted fault: ``dq`` as a dQ kernel that skipped key tile 0 (its
    first ``tile`` keys) in the later half of the query rows that see it
    would give it, ``dq`` less that tile's scale dS K there in float32,
    rounded to bf16. Tile 0 is those rows' farthest tile (at a window, its
    edge), and their |dq| is the smallest."""
    from repro_torch.kernels.flash_attention import ops as flash_ops

    g, sq, d = q.shape[1] // k.shape[1], q.shape[2], q.shape[3]
    kt, vt = (t[:, :, :tile].float().repeat_interleave(g, 1) for t in (k, v))
    seen = flash_ops._visible(sq, k.shape[2], causal, win, q.device)[:, :tile]
    rows = seen.any(1).nonzero()
    seen[: (int(rows[-1]) + 1) // 2 if len(rows) else sq] = False
    p = (q.float() @ kt.transpose(-1, -2) * d ** -0.5 - lse[..., None]).exp() * seen
    ds = p * (dout.float() @ vt.transpose(-1, -2)
              - (dout.float() * o.float()).sum(-1, keepdim=True))
    return (dq.float() - ds @ kt * d ** -0.5).to(dq.dtype)


def sdpa_backend(fn) -> str:
    """The ATen operator SDPA dispatched ``fn``'s call to (flash, efficient,
    cuDNN or the math fallback), read from a profile."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    names = {e.name for e in prof.events() if e.name.startswith("aten::_scaled_dot_product_")}
    return ",".join(sorted(names)) or "aten::scaled_dot_product_attention (math)"


def k3_work(b: int, h: int, hkv: int, sq: int, sk: int, d: int, dv: int, causal: bool,
            window: int, element_size: int = 2) -> dict:
    """K3's work at a shape: visible pairs, the operations the function
    needs (2 (D + Dv) a pair and head: QK^T and PV), the bytes it must move
    (q, k, v read once, the output written once), the card's bound, and
    the tensor-core kernel's own floor (two PV products: 2 D + 4 Dv, 6 D
    where Dv = D)."""
    from repro_torch.kernels.flash_attention.ops import visible_pairs

    pairs = visible_pairs(sq, sk, causal, window)
    flops = 2 * b * h * (d + dv) * pairs
    nbytes = (b * h * sq * (d + dv) + b * hkv * sk * (d + dv)) * element_size
    return {"visible_pairs": pairs, "flops": flops, "bytes": nbytes,
            "bound_ms": max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3,
            "bound_by": "operations" if flops / BF16_FLOPS >= nbytes / HBM_BYTES_PER_S
            else "bytes",
            "floor_6d_ms": 2 * b * h * (d + 2 * dv) * pairs / BF16_FLOPS * 1e3}


def check_flash_attention(dev) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import (
        WGMMA_HEAD_DIMS,
        flash_attention,
        flash_attention_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32
    cases = []
    # the six cases of tests/test_kernels.py, then the main paths' shapes,
    # timed under their labels: the serve prefill's, prefill_32k's sequence
    # length at the same heads, granite's prefill (head dim 64), hymba's
    # (25 q / 5 kv heads at head dim 64, 4096 tokens past its 2048-token
    # window), deepseek-v3's MLA prefill (128 heads, qk 192, v 128) and
    # whisper-tiny's three: its encoder (1,500 frames) and cross attention
    # (2,048 tokens against them), both non-causal, and its decoder's
    # causal self-attention (2,048 tokens); internvl2-76b's prefill (256
    # patch embeddings + 2,048 tokens, 64 q / 8 kv heads: G = 8); the
    # dryrun phase's per-device prefill_32k (2 sequences of 32,768):
    # qwen3's, command-r's (6 q heads, 1 kv head), deepseek-v3's (8 of
    # its 128 MLA heads, qk 192 / v 128) and granite's (1 q head reading 1
    # kv head, D 64); deepseek-v3's per-device train_4k (16 x 4,096, its 8
    # heads); hymba-1.5b's per-device prefill_32k (its 25 q / 5 kv heads
    # whole on 16x16, window 2048) and whisper-tiny's per-device train_4k
    # decoder self-attention (16 x 4,096, causal) and cross attention
    # (against 1,500 frames, non-causal), its 6 heads whole
    shapes = [(2, 4, 4, 128, 128, 64, 64, True, 0, "float32", None),
              (1, 8, 2, 257, 257, 64, 64, True, 0, "float32", None),
              (2, 4, 2, 200, 200, 128, 128, True, 64, "float32", None),
              (1, 4, 4, 96, 160, 64, 64, False, 0, "bfloat16", None),
              (1, 2, 1, 512, 512, 64, 64, True, 0, "bfloat16", None),
              (1, 4, 4, 64, 64, 128, 128, True, 32, "bfloat16", None),
              (1, 16, 8, 2048, 2048, 128, 128, True, 0, "bfloat16", "serve"),
              (1, 16, 8, 32768, 32768, 128, 128, True, 0, "bfloat16", "32k"),
              (1, 16, 8, 2048, 2048, 64, 64, True, 0, "bfloat16", "d64"),
              (1, 25, 5, 4096, 4096, 64, 64, True, 2048, "bfloat16", "hymba"),
              (1, 128, 128, 2048, 2048, 192, 128, True, 0, "bfloat16", "mla"),
              (4, 6, 6, 1500, 1500, 64, 64, False, 0, "bfloat16", "whisper_encoder"),
              (4, 6, 6, 2048, 1500, 64, 64, False, 0, "bfloat16", "whisper_cross"),
              (4, 6, 6, 2048, 2048, 64, 64, True, 0, "bfloat16", "whisper_decoder"),
              (1, 64, 8, 2304, 2304, 128, 128, True, 0, "bfloat16", "internvl2"),
              (2, 16, 8, 32768, 32768, 128, 128, True, 0, "bfloat16", "prefill_32k"),
              (2, 6, 1, 32768, 32768, 128, 128, True, 0, "bfloat16", "command_r_32k"),
              (2, 8, 8, 32768, 32768, 192, 128, True, 0, "bfloat16", "mla_32k"),
              (2, 1, 1, 32768, 32768, 64, 64, True, 0, "bfloat16", "granite_32k"),
              (16, 8, 8, 4096, 4096, 192, 128, True, 0, "bfloat16", "mla_train_4k"),
              (2, 25, 5, 32768, 32768, 64, 64, True, 2048, "bfloat16", "hymba_32k"),
              (16, 6, 6, 4096, 4096, 64, 64, True, 0, "bfloat16", "whisper_decoder_4k"),
              (16, 6, 6, 4096, 1500, 64, 64, False, 0, "bfloat16", "whisper_cross_4k")]
    timed = {}
    for i, (b, h, hkv, sq, sk, d, dv, causal, window, dt, label) in enumerate(shapes):
        rng = np.random.default_rng(i)
        dtype = getattr(torch, dt)
        q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)
                   for shape in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv)))
        before = flash_attention.wgmma_launches
        got = flash_attention(q, k, v, causal=causal, window=window)
        kernel = "wgmma" if flash_attention.wgmma_launches > before else "cuda-core"
        assert kernel == ("wgmma" if dt == "bfloat16" and (d, dv) in WGMMA_HEAD_DIMS
                          else "cuda-core")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = float((got.float() - want.float()).abs().max())
        tol = BF16_TOL if dt == "bfloat16" else F32_TOL
        close = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
        assert close and torch.isfinite(got).all(), (b, h, hkv, sq, sk, d, dv, causal, window,
                                                     dt, err)
        case = {"shape": f"B{b} H{h} Hkv{hkv} Sq{sq} Sk{sk} D{d}" + (f" Dv{dv}" if dv != d else ""),
                "causal": causal, "window": window, "dtype": dt, "kernel": kernel,
                "max_abs_err": err, "tol": tol}
        if dt == "bfloat16":
            case.update(one_bf16_rounding(got, flash_attention_plain(
                q.float(), k.float(), v.float(), causal=causal, window=window)))
        if label:  # the main paths' shapes and the 32k one: timed
            reps = 20 if sq <= 4096 else 3
            # the yardstick only; the port never calls it. A window goes in
            # as a boolean mask, which SDPA's flash backend does not take
            mask = (torch.ones(sq, sk, dtype=torch.bool, device=dev).tril()
                    .triu(-(window - 1)) if window > 0 else None)

            def library(q=q, k=k, v=v, mask=mask, causal=causal):
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                      is_causal=causal and mask is None,
                                                      enable_gqa=True)

            lib_err = float((library().float() - want.float()).abs().max())
            assert lib_err <= BF16_TOL, lib_err  # the yardstick computes the same function
            case.update({
                "ms": cuda_ms(lambda: flash_attention(q, k, v, causal=causal, window=window), reps),
                "kernel_only_ms": profiled_ms(
                    lambda: flash_attention(q, k, v, causal=causal, window=window),
                    "flash_fwd_kernel_wgmma" if kernel == "wgmma" else "flash_fwd_kernel", reps),
                "plain_ms": plain_ms,
                "library_ms": cuda_ms(library, reps),
                "library_backend": sdpa_backend(library),
                "library_max_abs_err": lib_err,
                **k3_work(b, h, hkv, sq, sk, d, dv, causal, window, q.element_size()),
            })
            timed[label] = case
        cases.append(case)
        del q, k, v, got, want
    serve = timed["serve"]
    at = ("ms", "kernel_only_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "floor_6d_ms",
          "max_abs_err", "max_abs_err_vs_f32", "out_rms", "rounding_limit_use")
    more = at + ("kernel", "visible_pairs", "flops", "bytes", "library_backend")
    return {"name": "flash_attention", "cases": cases, "max_abs_err": serve["max_abs_err"],
            **{key: serve[key] for key in ("ms", "kernel_only_ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by", "floor_6d_ms")},
            "shape": "q bf16[1,16,2048,128], k/v bf16[1,8,2048,128], causal",
            **{key: serve[key] for key in ("max_abs_err_vs_f32", "out_rms",
                                           "rounding_limit_use")},
            "at_32k": {key: timed["32k"][key] for key in at},
            "at_d64": {"shape": "q bf16[1,16,2048,64], k/v bf16[1,8,2048,64], causal",
                       **{key: timed["d64"][key] for key in at}},
            "at_hymba": {"shape": "q bf16[1,25,4096,64], k/v bf16[1,5,4096,64], causal, "
                                  "window 2048",
                         **{key: timed["hymba"][key] for key in more}},
            "at_mla": {"shape": "q/k bf16[1,128,2048,192], v bf16[1,128,2048,128], causal",
                       **{key: timed["mla"][key] for key in more}},
            "at_whisper_encoder": {"shape": "q/k/v bf16[4,6,1500,64], non-causal",
                                   **{key: timed["whisper_encoder"][key] for key in more}},
            "at_whisper_cross": {"shape": "q bf16[4,6,2048,64], k/v bf16[4,6,1500,64], "
                                          "non-causal",
                                 **{key: timed["whisper_cross"][key] for key in more}},
            "at_whisper_decoder": {"shape": "q/k/v bf16[4,6,2048,64], causal",
                                   **{key: timed["whisper_decoder"][key] for key in more}},
            "at_internvl2": {"shape": "q bf16[1,64,2304,128], k/v bf16[1,8,2304,128], causal",
                             **{key: timed["internvl2"][key] for key in more}},
            "at_prefill_32k": {"shape": "q bf16[2,16,32768,128], k/v bf16[2,8,32768,128], "
                                        "causal (qwen3-1.7b's prefill_32k, a device of 16x16)",
                               **{key: timed["prefill_32k"][key] for key in more}},
            "at_command_r_32k": {"shape": "q bf16[2,6,32768,128], k/v bf16[2,1,32768,128], "
                                          "causal (command-r-plus-104b's prefill_32k on a "
                                          "device of 16x16: its 6 q heads, 1 kv head)",
                                 **{key: timed["command_r_32k"][key] for key in more}},
            "at_mla_32k": {"shape": "q/k bf16[2,8,32768,192], v bf16[2,8,32768,128], causal "
                                    "(deepseek-v3's prefill_32k on a device of 16x16: its 8 of "
                                    "128 MLA heads)",
                           **{key: timed["mla_32k"][key] for key in more}},
            "at_granite_32k": {"shape": "q/k/v bf16[2,1,32768,64], causal (granite-moe-1b-"
                                        "a400m's prefill_32k on a device of 16x16: 1 q head "
                                        "reading 1 kv head)",
                               **{key: timed["granite_32k"][key] for key in more}},
            "at_mla_train_4k": {"shape": "q/k bf16[16,8,4096,192], v bf16[16,8,4096,128], "
                                         "causal (deepseek-v3's train_4k on a device of "
                                         "16x16: its 8 of 128 MLA heads)",
                                **{key: timed["mla_train_4k"][key] for key in more}},
            "at_hymba_32k": {"shape": "q bf16[2,25,32768,64], k/v bf16[2,5,32768,64], causal, "
                                      "window 2048 (hymba-1.5b's prefill_32k on a device of "
                                      "16x16: its 25 q / 5 kv heads whole)",
                             **{key: timed["hymba_32k"][key] for key in more}},
            "at_whisper_decoder_4k": {"shape": "q/k/v bf16[16,6,4096,64], causal (whisper-tiny's "
                                               "train_4k decoder on a device of 16x16)",
                                      **{key: timed["whisper_decoder_4k"][key] for key in more}},
            "at_whisper_cross_4k": {"shape": "q bf16[16,6,4096,64], k/v bf16[16,6,1500,64], "
                                             "non-causal (whisper-tiny's train_4k cross "
                                             "attention on a device of 16x16)",
                                    **{key: timed["whisper_cross_4k"][key] for key in more}},
            "head_slices": check_k3_head_slices(dev)}


def check_k3_head_slices(dev) -> dict:
    """K3 on each model rank's q heads and its view (or block) of the kv
    heads (``kernels/flash_attention/cases.py``: qwen3's and command-r's
    GQA and deepseek-v3's MLA at qk 192 / v 128 on 16 ranks, hymba's
    windowed attention on 5, whisper's non-causal cross attention on 2):
    bitwise those heads of the call over every head, each view read as it
    is by the tensor-core kernel, one launch a rank."""
    from repro_torch.kernels.flash_attention.cases import HEAD_SLICE_CASES, check_head_slices

    out = {}
    for name, case in HEAD_SLICE_CASES.items():
        got = check_head_slices(dev, *case)
        ranks = case[-1]
        assert got["bitwise"] and got["views_taken_as_is"], (name, got)
        assert got["rank_wgmma_launches"] == ranks, (name, got)
        out[name] = got
    return out


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


def check_serve(metrics: dict, dev, spec: str = SERVE_SPEC, varied: bool = True,
                prompt_len: int = PROMPT_LEN) -> dict:
    """The served transcripts equal ``run_reference``'s on an engine rebuilt
    from the seed, differ from request to request and (``varied``) each
    holds more than one token."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import make_engine, run_reference

    engine = make_engine(spec, device=dev)
    requests = launch_serve.build_requests(engine.vocab, batch=BATCH, prompt_len=prompt_len,
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
    host dropped at done 24, resumed by a new host from the CMI of done 17.
    Every decode step changes every layer's cache (a k/v row, a recurrent
    state), so each publish writes the whole cache; ``cmi_cache_arrays``
    are the cache leaves of the CMI resumed from, with their bytes."""
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
            man = load_manifest(store.cmi_root(job_id), name)
            stats = man.extra["stats"]
            publishes.append({"cmi": name, "publish_s": time.perf_counter() - opened.pop(name),
                              "cache_arrays": {p: e.nbytes for p, e in man.arrays.items()
                                               if p.startswith("caches/")},
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
    assert all(t.device.type == engine.device.type
               for t in _leaves(host2.active[req["id"]]["caches"]))
    got = [tok for _, tok in res["tokens"]]
    while host2.active:
        got += [tok for _, tok in host2.step()["tokens"].get(req["id"], [])]
    assert got == want, (got, want)
    assert host2.counters["prefills"] == 0 and host2.counters["resumes"] == 1
    report = fsck_store(store.cmi_root(job.job_id))
    assert report.clean, report.summary()
    assert store.read_job(job.job_id).status == STATUS_FINISHED
    cache = engine.model.cache_struct(1, len(req["prompt"]) + GEN)
    cache_bytes = sum(math.prod(s.shape) * torch.empty((), dtype=s.dtype).element_size()
                      for s in _leaves(cache))
    assert len(publishes) == 2
    cache_arrays = publishes[0].pop("cache_arrays")
    assert publishes[1].pop("cache_arrays") == cache_arrays  # the CMI resumed from
    assert sum(cache_arrays.values()) == cache_bytes, (cache_arrays, cache_bytes)
    for pub in publishes:  # every layer's cache changed: the whole cache is written
        assert pub["written_bytes"] >= cache_bytes, (pub, cache_bytes)
    assert publishes[1]["ref_bytes"] > 0  # the unchanged prompt is referenced, not rewritten
    return {"resumed_at_done": resumed_at, "dropped_at_done": DROP_AT_DONE,
            "resume_s": resume_s, "cache_bytes": cache_bytes,
            "cmi_cache_arrays": cache_arrays, "publishes": publishes,
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
    if "flash_bwd" in name:
        return RANGES["flash_attention_backward"]
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
    bwd_us = sum(e.time_range.elapsed_us() for e in device if "flash_bwd" in e.name)
    if groups.get(RANGES["flash_attention_backward"], 0.0) == 0.0 and bwd_us:  # the same
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


def profile_serve(engine, prompt: list[int], steps: int = SERVE_PROFILE_STEPS) -> dict:
    """Where one request's time goes: its prefill and ``steps`` decode
    steps under torch.profiler, device time by kernel group and the
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


def serve_counted(dev, arch: str, prompt_len: int = PROMPT_LEN,
                  layers: int = 0) -> tuple[dict, dict, dict, int]:
    """``launch.serve.main`` for ``arch`` at full width (its depth cut to
    ``layers`` where given), every kernel's count set to 0 just before and
    read just after: (metrics, launches, the ``window`` of each call the
    model made to K3, peak memory)."""
    from collections import Counter

    from repro_torch.kernels.colocate import ops as colocate_ops
    from repro_torch.kernels.delta_encode import ops as delta_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import attention as attn

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    kernel, windows = attn.flash_attention, Counter()

    def seen(*args, **kw):  # records the call, then the wrapper launches and counts
        windows[kw.get("window", 0)] += 1
        return kernel(*args, **kw)

    delta_ops.changed_blocks.launches = 0
    colocate_ops.colocate_match.launches = 0
    flash_ops.flash_attention.launches = 0
    flash_ops.flash_attention.wgmma_launches = 0
    attn.flash_attention = seen
    try:
        metrics = launch_serve.main(serve_argv(arch, prompt_len, layers))
        torch.cuda.synchronize()
    finally:
        attn.flash_attention = kernel
    launches = {"delta_encode": delta_ops.changed_blocks.launches,
                "colocate": colocate_ops.colocate_match.launches,
                "flash_attention": flash_ops.flash_attention.launches,
                "flash_attention_wgmma": flash_ops.flash_attention.wgmma_launches}
    return metrics, launches, dict(windows), torch.cuda.max_memory_allocated(dev)


def run_serve_moe(root: Path, dev) -> dict:
    """granite-moe-1b-a400m at full width through ``launch.serve.main`` with
    the serve phase's traffic: K3 launches counted from 0 just before and
    read just after (4 x 24, all on the tensor cores), transcripts equal
    ``run_reference``'s, one request published, dropped and resumed with
    zero re-prefill, prefill logits with K3 against the plain attention,
    and where a prefill's and a decode step's time goes, the MoE dispatch,
    expert GEMMs and combine as groups of their own."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    metrics, launches, _, peak = serve_counted(dev, MOE_ARCH)
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
            "where_the_time_goes": trace,
            "launches": launches, "k3_launches_per_prefill": cfg.n_layers,
            "peak_memory_bytes": peak}


def _expert_stack(dev, gen, shape, scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(X, a, b) expert weights N(0, scale**2) drawn on the card from
    ``gen`` one expert at a time and rounded to bf16, and the same values in
    float32 on the host, copied 16 experts at a time and widened there: the
    card holds no float32 or float64 draw of the whole stack (deepseek's
    256 x 7168 x 2048 is 7.5 GB in bf16, 15 GB in float32)."""
    card = torch.empty(shape, dtype=torch.bfloat16, device=dev)
    for x in range(shape[0]):
        card[x] = torch.randn(shape[1:], generator=gen, device=dev) * scale
    host = torch.empty(shape, dtype=torch.float32)
    for x in range(0, shape[0], 16):  # 16 experts a copy, widened on the host
        host[x:x + 16] = card[x:x + 16].cpu()
    return card, host


def _own_column(dev, gen, x_: int, f: int, e: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Down projections that write only their expert's own output column
    (1 + |N(0, 1)| a hidden unit), on the card in bf16 and on the host in
    float32, built as :func:`_expert_stack` builds its stacks."""
    card = torch.zeros((x_, f, e), dtype=torch.bfloat16, device=dev)
    host = torch.zeros((x_, f, e), dtype=torch.float32)
    for x in range(x_):
        card[x, :, x] = 1.0 + torch.randn(f, generator=gen, device=dev).abs()
        host[x, :, x] = card[x, :, x].float().cpu()
    return card, host


def check_moe_on_card(dev, cfg, prefill_tokens: int = PROMPT_LEN) -> dict:
    """One MoE layer of ``cfg``, all its experts at full width, on the card
    (bf16) against the same layer on the CPU in float32 (the port's CPU
    path, which the CPU tests hold against the JAX package), at a prefill's
    group (``prefill_tokens``; 2048 tokens: granite's capacity 640,
    deepseek's 80) and a decode step's (one token, capacity 1); sigmoid
    routing with its bias (zero, its init) and a shared expert where
    ``cfg`` has them. The router weights
    and inputs are multiples of 2**-6 and 2**-2 small enough that every
    router logit is exact in float32 on both devices: the routing is then
    the same whatever the order of the sums, ties (which the few distinct
    values make common) included; experts 0-3 are favoured, so their
    capacity overflows and drops happen. Outputs within 2e-2 of the largest
    magnitude (bf16 products and sums); then each expert's down
    projection made to write only its own column, so a column is non-zero
    exactly where its expert's assignment passed capacity (the shared
    expert's down projection zero): those sets equal on both devices. The
    expert weights are drawn on the card (seed 18); the host's float32 copy
    of them is the largest host allocation of the smoke (45 GB at
    deepseek's widths), reported with the host's peak resident size."""
    import resource

    from repro_torch.models import moe

    t0 = time.perf_counter()
    rng = np.random.default_rng(18)
    gen = torch.Generator(device=dev).manual_seed(18)
    e, x_, f = cfg.d_model, cfg.n_experts, cfg.resolved_moe_d_ff
    w_router = rng.integers(-8, 9, (e, x_)).astype(np.float32) / 64
    w_router[:16, :4] = 8 / 64  # with the constant features below: experts 0-3
    small = {"w_router": w_router}  # favoured, so their capacity overflows
    if cfg.router_type == "sigmoid":
        small["router_bias"] = np.zeros(x_, np.float32)
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        small.update(ws_g=rng.standard_normal((e, fs), dtype=np.float32) / math.sqrt(e),
                     ws_u=rng.standard_normal((e, fs), dtype=np.float32) / math.sqrt(e),
                     ws_d=rng.standard_normal((fs, e), dtype=np.float32) / math.sqrt(fs))
    xs = {}
    for label, tokens in (("prefill", prefill_tokens), ("decode", 1)):
        xs[label] = (rng.integers(-2, 3, (1, tokens, e)) / 4).astype(np.float32)
        xs[label][..., :16] = 0.5
    card = {k: torch.from_numpy(v).to(dev, torch.float32 if k.startswith("router")
                                      or k == "w_router" else torch.bfloat16)
            for k, v in small.items()}
    host = {k: v.float().cpu() for k, v in card.items()}  # the same bf16 values
    for name, shape, fan_in in (("wg", (x_, e, f), e), ("wu", (x_, e, f), e),
                                ("wd", (x_, f, e), f)):
        card[name], host[name] = _expert_stack(dev, gen, shape, 1 / math.sqrt(fan_in))
    cpu_cfg = cfg.with_(dtype="float32")
    out = {label: {"tokens": x.shape[1], "capacity": moe.capacity(x.shape[1], cfg)}
           for label, x in xs.items()}
    for wd_name in ("dense", "own_column"):
        if wd_name == "own_column":
            del card["wd"], host["wd"]
            card["wd"], host["wd"] = _own_column(dev, gen, x_, f, e)
            if "ws_d" in card:
                card["ws_d"].zero_()
                host["ws_d"].zero_()
        for label, x in xs.items():
            got = moe.moe_ffn(card, torch.from_numpy(x).to(dev, torch.bfloat16), cfg)
            want = moe.moe_ffn(host, torch.from_numpy(x), cpu_cfg)
            got = got.float().cpu()
            assert got.shape == want.shape and torch.isfinite(got).all()
            res, tokens = out[label], x.shape[1]
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
    assert out["prefill"]["dropped"] > 0  # the capacity bound was exercised
    host_bytes = sum(t.numel() * t.element_size() for t in host.values())
    del card, host
    torch.cuda.empty_cache()
    return {"experts": x_, **out, "host_float32_bytes": host_bytes,
            "host_peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
            "s": time.perf_counter() - t0}


def run_serve_hybrid(root: Path, dev) -> dict:
    """hymba-1.5b at full width through ``launch.serve.main``: 4 requests of
    4096 prompt tokens, past its 2048-token window, and 32 generated (the
    first decode writes slot 0 of the rolling cache again). K3 counted from
    0 just before and read just after: one launch a layer a prefill (4 x
    32), all on the tensor cores, every call with the window. Transcripts
    equal ``run_reference``'s; one request published, dropped and resumed
    with zero re-prefill, its SSD states in the CMI; prefill logits with K3
    against the plain attention; one hybrid layer on the card against the
    float32 CPU path; where a prefill's and a decode step's time goes."""
    from repro_torch.configs import get_config

    metrics, launches, windows, peak = serve_counted(dev, HYBRID_ARCH, HYBRID_PROMPT_LEN)
    served = check_serve(metrics, dev, spec=HYBRID_SERVE_SPEC, prompt_len=HYBRID_PROMPT_LEN)
    engine, req = served["engine"], served["requests"][0]
    cfg = engine.cfg
    assert cfg == get_config(HYBRID_ARCH) and 0 < cfg.window < HYBRID_PROMPT_LEN, cfg  # nothing cut
    per_run = BATCH * cfg.n_layers
    assert launches == {"delta_encode": 0, "colocate": 0, "flash_attention": per_run,
                        "flash_attention_wgmma": per_run}, launches
    assert windows == {cfg.window: per_run}, windows
    resume = run_serve_resume(root, dev, engine, req, served["reference"][req["id"]])
    ssd = {p: n for p, n in resume["cmi_cache_arrays"].items() if p.endswith("/ssd")}
    assert list(ssd.values()) == [cfg.n_layers * cfg.n_heads * cfg.ssm_state
                                  * cfg.resolved_head_dim * 4], resume["cmi_cache_arrays"]
    in_model = check_model_kernel_vs_plain(engine, req["prompt"])
    on_card = check_hybrid_on_card(dev, cfg)
    trace = profile_serve(engine, req["prompt"])
    assert trace["prefill"]["groups_ms"].get(RANGES["linear_recurrence"], 0) > 0, trace
    return {**served["line"],
            "config": {"arch": HYBRID_ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                       "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim],
                       "window": cfg.window, "ssm_state": cfg.ssm_state, "chunk": cfg.chunk,
                       "d_ff": cfg.d_ff, "vocab": cfg.vocab, "dtype": cfg.dtype,
                       "params": cfg.param_count()},
            "prompt_len": HYBRID_PROMPT_LEN, "resume": resume,
            "kernel_vs_plain_in_model": in_model, "hybrid_layer_on_card": on_card,
            "where_the_time_goes": trace, "launches": launches, "k3_windows": windows,
            "k3_launches_per_prefill": cfg.n_layers, "peak_memory_bytes": peak}


def check_hybrid_on_card(dev, cfg) -> dict:
    """One hymba layer (the windowed attention ‖ the SSD, then the SwiGLU
    FFN; random weights from seed 19) at the serve prompt's 4096 tokens on
    the card against the same layer on the CPU in float32 (the port's CPU
    path, which the CPU tests hold against the JAX package), from the same
    bf16-exact weights and inputs: the layer's output, its k/v cache and
    its SSD state. On the card in bf16, the main path's arithmetic (K3's
    tensor-core kernel), within 2e-2 of each one's largest magnitude; in
    float32 (K3's CUDA-core kernel, TF32 off) within 1e-4 of it."""
    from repro_torch.models import Model
    from repro_torch.models import transformer as tf
    from repro_torch.utils import flatten_with_paths, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(19)
    layer = tf._layer(Model(cfg.with_(n_layers=1)).init(gen)["blocks"]["g0"], 0)
    x = torch.randn((1, HYBRID_PROMPT_LEN, cfg.d_model), generator=gen).to(torch.bfloat16)
    s_max = HYBRID_PROMPT_LEN + GEN

    def run(pl, xin):
        y, cache = tf.block_prefill(pl, xin, cfg, "hybrid", "dense", 0, s_max)
        return {"out": y, **flatten_with_paths(cache)[0]}

    want = run(tree_map(lambda t: t.float(), layer), x.float())
    out = {}
    for label, dtype, tol in (("bf16", None, BF16_TOL), ("float32", torch.float32, GRAD_TOL)):
        pl = tree_map(lambda t: t.to(dev, dtype or t.dtype), layer)
        got = run(pl, x.to(dev, dtype or x.dtype))
        res = {}
        for key, w in want.items():
            g = got[key].float().cpu()
            assert g.shape == w.shape and torch.isfinite(g).all(), (label, key)
            err, scale = float((g - w).abs().max()), float(w.abs().max())
            assert err <= tol * scale, (label, key, err, scale)
            res[key] = {"max_abs_err": err, "max_abs": scale}
        out[label] = {"tol": f"{tol} of the max", **res}
    return out


def run_xlstm(root: Path, dev) -> dict:
    """xlstm-1.3b at full width: served through ``launch.serve.main`` (4
    requests of 2048 prompt tokens, 32 generated; every kernel counted from
    0 just before and read just after, and none launched: the mLSTM is
    matrix products and elementwise work that the JAX package runs outside
    any Pallas kernel), transcripts equal ``run_reference``'s, one request
    published, dropped and resumed with zero re-prefill from its 202 MB
    mLSTM state; then training steps in this process at full width and
    ``XLSTM_STEP_LAYERS`` of its 48 layers, timed, with finite losses and
    the peak memory."""
    from repro_torch.configs import get_config

    metrics, launches, windows, peak = serve_counted(dev, XLSTM_ARCH)
    served = check_serve(metrics, dev, spec=XLSTM_SERVE_SPEC)
    engine, req = served["engine"], served["requests"][0]
    cfg = engine.cfg
    assert cfg == get_config(XLSTM_ARCH), cfg
    assert launches == {"delta_encode": 0, "colocate": 0, "flash_attention": 0,
                        "flash_attention_wgmma": 0} and not windows, (launches, windows)
    resume = run_serve_resume(root, dev, engine, req, served["reference"][req["id"]])
    dh = cfg.resolved_head_dim
    assert list(resume["cmi_cache_arrays"].values()) == [cfg.n_layers * cfg.n_heads * dh
                                                         * (dh + 1) * 4], resume
    line = {**served["line"],
            "config": {"arch": XLSTM_ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                       "heads": [cfg.n_heads, dh], "chunk": cfg.chunk, "vocab": cfg.vocab,
                       "dtype": cfg.dtype, "params": cfg.param_count()},
            "resume": resume, "launches": launches, "peak_memory_bytes": peak,
            "tpu_kernels": "none: the JAX package runs the mLSTM outside any Pallas kernel"}
    del served, engine
    torch.cuda.reset_peak_memory_stats(dev)
    line["cut_depth_step"] = profile_train(dev, XLSTM_STEP_LAYERS, XLSTM_ARCH)
    return line


def run_serve_mla(root: Path, dev) -> dict:
    """deepseek-v3-671b at full width, its depth cut to 4 layers (3 dense +
    1 MoE), through ``launch.serve.main --layers 4``: 4 requests of 2048
    prompt tokens and 32 generated, K3 counted from 0 just before and read
    just after (one launch a layer a prefill, all on the tensor cores at qk
    192 / v 128). Transcripts equal ``run_reference``'s on an engine
    rebuilt from the spec; one request published, dropped and resumed with
    zero re-prefill from its latent cache; prefill logits with K3 against
    the plain attention; one dense MLA layer and the MoE layer (all 256
    experts, a prefill group of ``MLA_MOE_ON_CARD_TOKENS``) on the card
    against the float32 CPU path; where a prefill's and a decode step's
    time goes (K3, the MLA range, the MoE dispatch, expert GEMMs and
    combine)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.cases import check_mla_layer_on_device

    gc.collect()
    torch.cuda.empty_cache()  # 30.2 GB of weights and a 15 GB float32 expert draw
    metrics, launches, windows, peak = serve_counted(dev, MLA_ARCH, layers=MLA_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()  # main's engine is gone; check_serve builds its own
    t0 = time.perf_counter()
    # the reference's init leaves a random 256-expert MoE layer ~1/16 of a
    # dense layer's output, so greedy transcripts may repeat a token
    served = check_serve(metrics, dev, spec=MLA_SERVE_SPEC, varied=False)
    engine, req = served["engine"], served["requests"][0]
    cfg = engine.cfg
    assert cfg == get_config(MLA_ARCH).with_(n_layers=MLA_LAYERS), cfg  # widths kept
    per_run = BATCH * cfg.n_layers
    assert launches == {"delta_encode": 0, "colocate": 0, "flash_attention": per_run,
                        "flash_attention_wgmma": per_run}, launches
    assert windows == {0: per_run}, windows
    check_s = time.perf_counter() - t0
    resume = run_serve_resume(root, dev, engine, req, served["reference"][req["id"]])
    assert sorted(resume["cmi_cache_arrays"]) == ["caches/g0/ckv", "caches/g0/kr",
                                                  "caches/g1/ckv", "caches/g1/kr"], resume
    in_model = check_model_kernel_vs_plain(engine, req["prompt"])
    trace = profile_serve(engine, req["prompt"])
    for phase in ("prefill", "decode"):
        for name in ("mla", "moe_dispatch", "moe_experts"):
            assert trace[phase]["groups_ms"].get(RANGES[name], 0) > 0, (phase, name, trace)
    leaves = _leaves(engine.params)
    line = {**served["line"],
            "config": {"arch": MLA_ARCH, "n_layers": cfg.n_layers,
                       "depth_cut": {"layers": cfg.n_layers, "of": get_config(MLA_ARCH).n_layers},
                       "d_model": cfg.d_model, "heads": cfg.n_heads,
                       "mla": {"q_lora": cfg.q_lora_rank, "kv_lora": cfg.kv_lora_rank,
                               "qk_nope": cfg.qk_nope_dim, "qk_rope": cfg.qk_rope_dim,
                               "v_head": cfg.v_head_dim},
                       "experts": [cfg.n_experts, cfg.top_k, cfg.resolved_moe_d_ff,
                                   cfg.n_shared_experts], "router": cfg.router_type,
                       "first_dense_layers": cfg.first_dense_layers, "d_ff": cfg.d_ff,
                       "vocab": cfg.vocab, "dtype": cfg.dtype, "params": cfg.param_count(),
                       "active_params": cfg.active_param_count()},
            "param_bytes_on_card": sum(t.numel() * t.element_size() for t in leaves),
            "capacity": {"prefill_per_expert": moe.capacity(PROMPT_LEN, cfg),
                         "decode_per_expert": moe.capacity(1, cfg)},
            "engine_rebuild_and_reference_s": check_s,
            "resume": resume, "kernel_vs_plain_in_model": in_model,
            "where_the_time_goes": trace, "launches": launches,
            "k3_launches_per_prefill": cfg.n_layers, "peak_memory_bytes": peak}
    del served, engine, leaves
    gc.collect()
    torch.cuda.empty_cache()
    line["mla_layer_on_card"] = check_mla_layer_on_device(dev, cfg, MLA_ON_CARD_TOKENS)
    line["moe_on_card"] = check_moe_on_card(dev, cfg, MLA_MOE_ON_CARD_TOKENS)
    return line


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

    return out


def run_serve_cli(local: dict) -> dict:
    """The serve CLI's routed mode, ``launch.serve.main(--workers 2)``: two
    of the serve phase's requests and their first tokens (a depth cut for
    the smoke's time), the tokens of ``--workers 0``'s (``local``)."""
    from repro_torch.launch import serve as launch_serve

    argv = list(SERVE_ARGV) + ["--workers", "2"]
    argv[argv.index("--batch") + 1] = str(CLI_FLEET_BATCH)
    argv[argv.index("--gen") + 1] = str(CLI_FLEET_GEN)
    t0 = time.perf_counter()
    routed = launch_serve.main(argv)
    routed_s = time.perf_counter() - t0
    assert len(routed["transcripts"]) == CLI_FLEET_BATCH
    for rid, toks in routed["transcripts"].items():
        assert len(toks) == CLI_FLEET_GEN and toks == local["transcripts"][rid][:CLI_FLEET_GEN]
    out = {k: routed[k] for k in ("mode", "prefill_tok_s", "decode_tok_s", "ttft_p50_s",
                                  "ttft_max_s")}
    out.update(wall_s=routed_s, batch=CLI_FLEET_BATCH, gen=CLI_FLEET_GEN,
               tokens_equal_workers_0=True, beside="the chaos phase's cells")
    return out


# ---------------------------------------------------------------------------
# phase 9: the chaos matrix's tour cells against cuda workers
# ---------------------------------------------------------------------------


def start_chaos(dev) -> dict:
    """Start the tour cells of :data:`CHAOS_CELLS`, each through the chaos
    matrix's CLI (``python -m repro_torch.chaos.matrix --cells <id>``) with
    its workers on the card, all at once (each in a directory of its own);
    :func:`finish_chaos` reads them."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p)}
    procs = {cell_id: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.chaos.matrix", "--cells", cell_id,
         "--device", str(dev)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for cell_id in CHAOS_CELLS}
    return {"procs": procs, "t0": time.perf_counter(), "device": str(dev)}


def stop_chaos(chaos: dict) -> None:
    """End every cell process of ``chaos`` still running."""
    for proc in chaos["procs"].values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def finish_chaos(chaos: dict) -> dict:
    """Wait for the cells :func:`start_chaos` started; a cell that breaks
    an invariant exits non-zero. Every cell's process is ended on the way
    out, whatever happened."""
    cells = {}
    try:
        for cell_id, proc in chaos["procs"].items():
            log, _ = proc.communicate(timeout=600)
            assert proc.returncode == 0 and "1/1 cells survived" in log, (cell_id, log[-3000:])
            took = re.search(r"ok\s+\(\s*([0-9.]+)s\)", log)
            cells[cell_id] = {"s": float(took.group(1)), "verdict": "ok"}
    finally:
        stop_chaos(chaos)
    return {"cells": cells, "device": chaos["device"], "concurrent": True,
            "beside": "the serve CLI's --workers 2 run (serve_fleet.cli_workers_2)",
            "wall_s": time.perf_counter() - chaos["t0"]}


# ---------------------------------------------------------------------------
# phase 10: training — the Fig. 7 launcher on qwen3-1.7b, preempted and resumed
# ---------------------------------------------------------------------------


def k3_per_forward(cfg) -> int:
    """K3 calls of one forward pass: one a layer with attention (the
    mLSTM has none); the encoder-decoder's encoder layers and its decoder
    layers' self and cross attention."""
    if cfg.encdec:
        return cfg.enc_layers + 2 * cfg.n_layers
    return 0 if cfg.mlstm else cfg.n_layers


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



def _launch_train(root: Path, name: str, store: Path, argv: list[str]) -> list[dict]:
    """One launcher process on the card; its --metrics records."""
    metrics, log = root / f"{name}.jsonl", root / f"{name}.log"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p)}
    with open(log, "w") as out:
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *argv,
                               "--store", str(store), "--metrics", str(metrics)],
                              stdout=out, stderr=subprocess.STDOUT, env=env, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"train run {name} exited {proc.returncode}:\n"
                           + log.read_text()[-4000:])
    return [json.loads(ln) for ln in metrics.read_text().splitlines()]


def _digests(man) -> dict:
    return {path: [c.hash for c in entry.chunks] for path, entry in man.arrays.items()}


def run_train(root: Path, arch: str = TRAIN_ARCH, budget: int = TRAIN_WRITE_BUDGET,
              seq: int = TRAIN_SEQ, batch: int = TRAIN_BATCH) -> dict:
    """Run B (reclaimed at step 2, resumed) then run A (uninterrupted), one
    launcher process each on one job store, ``batch`` x ``seq`` tokens a
    step; B's step-2 CMI is dropped once B has finished, so the disk holds
    two train states at a time."""
    from repro_torch.checkpoint import SaveOptions, load_checkpoint, load_manifest, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core import JobStore
    from repro_torch.launch.train import step_flops

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
    argv = train_argv(arch, seq, batch) + extra
    rec = {"B": _launch_train(root, "B", store, argv + ["--preempt-at", str(TRAIN_PREEMPT_AT)])}
    wall = {"B": time.perf_counter() - t0}
    js = JobStore(store)
    end = {"B": rec["B"][-1]}
    job = {"B": js.read_job(end["B"]["job_id"])}
    stats = {cmi: load_manifest(js.cmi_root(job["B"].job_id), cmi).extra["stats"]
             for cmi in (r["cmi"] for r in rec["B"] if r["event"] == "publish")}
    js.gc_cmis(job["B"].job_id, keep_last=1)
    t0 = time.perf_counter()
    rec["A"] = _launch_train(root, "A", store, argv)
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
    per_run = 2 * TRAIN_STEPS * k3_per_forward(cfg)  # forward + remat recompute
    for k in "AB":
        # one backward (tensor-core) for each layer's forward with lse that
        # autograd keeps: the recompute's
        launched = end[k]["launches"]
        assert launched == {"flash_attention": per_run, "flash_attention_wgmma": per_run,
                            "flash_attention_lse": per_run, "flash_attention_bwd": per_run // 2,
                            "flash_attention_bwd_mma": per_run // 2}, (k, launched)

    step_s = {k: [r["s"] for r in rec[k] if r["event"] == "step"] for k in "AB"}
    median_s = statistics.median(step_s["A"][1:])  # steps 2-4: step 1 warms up
    flops = step_flops(cfg, batch, seq)
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
                   **({"window": cfg.window} if cfg.window else {}),
                   **({"ssm_state": cfg.ssm_state, "chunk": cfg.chunk} if cfg.ssm else {}),
                   **({"enc_layers": cfg.enc_layers, "enc_seq": cfg.enc_seq, "d_ff": cfg.d_ff,
                       "tie_embeddings": cfg.tie_embeddings} if cfg.encdec else {}),
                   "batch": batch, "seq_len": seq,
                   "steps": TRAIN_STEPS, "preempt_at": TRAIN_PREEMPT_AT},
        "depth_cut": None if not extra else {"layers": layers, "of": get_config(arch).n_layers},
        "disk_free_before_bytes": free, "state_bytes": state_nbytes,
        "write_budget_bytes": budget,
        "bitwise_equal": True, "losses": [loss for _, loss in steps["A"]],
        "step_s": step_s, "step_s_median_2_4": median_s,
        "tokens_per_s": batch * seq / median_s,
        "model_flops_per_step": flops, "model_tflops": flops / median_s / 1e12,
        "model_flops_share_of_bf16_peak": flops / median_s / BF16_FLOPS,
        "publish": publish, "restart_s": restart["s"], "restart_bytes": state_nbytes,
        "republish_b_into_a": {"written_bytes": 0, "s": republish_s,
                               "chunks": republished.extra["stats"]["chunks"]},
        "wall_s": wall, "peak_memory_bytes": {k: end[k]["peak_memory_bytes"] for k in "AB"},
        "incarnations": {k: end[k]["incarnations"] for k in "AB"}, "leases": leases,
        "launches": {k: end[k]["launches"] for k in "AB"},
        "final_cmis": {k: [job[k].job_id, job[k].cmi] for k in "AB"},
    }


def profile_train(dev, layers: int, arch: str = TRAIN_ARCH, seq: int = TRAIN_SEQ,
                  batch: int = TRAIN_BATCH) -> dict:
    """Train steps at the phase's shape in this process (not deterministic
    mode; nothing published): one to warm up, three timed (their median,
    tokens/s, model TFLOP/s, peak memory, every loss finite), then one
    profiled: device time by kernel group (:func:`device_groups`: K3's
    backward, AdamW, the MoE phases and the chunked recurrence by their
    ranges), the device's idle share, K3 launches (none for the mLSTM)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed.steps import batch_to_device, make_init_fn, make_train_step
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.train import step_flops
    from repro_torch.optim import AdamWConfig

    cfg = get_config(arch).with_(n_layers=layers)
    opt_cfg = AdamWConfig(moment_dtype=cfg.opt_moment_dtype)
    state = make_init_fn(cfg, opt_cfg, seed=0, device=dev)()
    step = make_train_step(cfg, opt_cfg, peak_lr=3e-3, warmup=5, total_steps=TRAIN_STEPS)
    pipe = TokenPipeline(cfg, seq, batch, seed=0)
    tokens = batch_to_device(pipe.batch_at({"data_step": 0, "seed": 0})[0], dev)
    unprofiled, losses = [], []
    for _ in range(4):  # the first warms up
        t0 = time.perf_counter()
        _, m = step(state, tokens)
        torch.cuda.synchronize()
        unprofiled.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    assert all(math.isfinite(loss) for loss in losses), losses
    before = (flash_attention.launches, flash_attention.bwd_launches,
              flash_attention.bwd_mma_launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, tokens)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    k3_launches = flash_attention.launches - before[0]
    bwd_launches = flash_attention.bwd_launches - before[1]
    want_k3 = 2 * k3_per_forward(cfg)  # forward + remat recompute
    assert k3_launches == want_k3, (k3_launches, want_k3)
    # one backward a layer, all tensor-core (bf16 models)
    assert bwd_launches == flash_attention.bwd_mma_launches - before[2] == want_k3 // 2
    del state, tokens
    gc.collect()
    torch.cuda.empty_cache()
    split = device_groups(prof)
    device, busy = split["device"], split["busy_us"]
    k3_kernels = sum("flash_fwd_kernel" in e.name for e in device)
    k3_wgmma = sum("flash_fwd_kernel_wgmma" in e.name for e in device)
    assert k3_wgmma == k3_kernels and (k3_kernels > 0) == (want_k3 > 0), (k3_wgmma, k3_kernels)
    bwd_kernels = sum("flash_bwd" in e.name for e in device)
    bwd_wgmma = sum("flash_bwd_dkdv_wgmma" in e.name or "flash_bwd_dq_wgmma" in e.name
                    for e in device)
    # every dK/dV and dQ kernel the tensor-core one: no mma.sync or CUDA-core kernel
    bwd_delta = sum("flash_bwd_delta" in e.name for e in device)
    assert (bwd_wgmma > 0) == (want_k3 > 0) and bwd_wgmma == bwd_kernels - bwd_delta, (
        bwd_kernels, bwd_wgmma, bwd_delta)
    step_s = statistics.median(unprofiled[1:])
    flops = step_flops(cfg, batch, seq)
    return {"n_layers": cfg.n_layers, "batch": batch, "seq_len": seq, "losses": losses,
            "unprofiled_step_s": unprofiled,
            "step_s_median_2_4": step_s, "tokens_per_s": batch * seq / step_s,
            "model_flops_per_step": flops, "model_tflops": flops / step_s / 1e12,
            "model_flops_share_of_bf16_peak": flops / step_s / BF16_FLOPS,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
            "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3, "device_idle_share": 1 - busy / wall_us,
            "kernel_launches": len(device), "k3_launches": k3_launches,
            "k3_kernels_in_trace": k3_kernels, "k3_wgmma_kernels_in_trace": k3_wgmma,
            "k3_backward_launches": bwd_launches,
            "k3_backward_kernels_in_trace": bwd_kernels,
            "k3_backward_wgmma_kernels_in_trace": bwd_wgmma,
            "groups_ms": split["groups_ms"], "top_kernels_ms": split["top_kernels_ms"]}


def vision_train_depth(cfg, free_bytes: int) -> int:
    """The most layers of ``cfg`` whose train step fits ``free_bytes`` of
    the card with 4 GB to spare: the state (params, master, moments), a
    gradient per param, and AdamW's five float32 temporaries of the
    largest leaf. A cut of depth, never of width."""
    from repro_torch.models import Model
    from repro_torch.utils import flatten_with_paths

    for layers in range(cfg.n_layers, 0, -1):
        c = cfg.with_(n_layers=layers)
        specs = flatten_with_paths(Model(c).param_specs())[0].values()
        params = sum(math.prod(s.shape) * torch.empty((), dtype=s.dtype).element_size()
                     for s in specs)
        largest = max(math.prod(s.shape) for s in specs)
        if state_bytes(c) + params + 5 * 4 * largest + 4e9 <= free_bytes:
            return layers
    raise RuntimeError(f"no depth of {cfg.name} trains in {free_bytes} bytes")


def run_vision(dev) -> dict:
    """internvl2-76b at full width, in this process (the engines refuse a
    vision prefix, in both packages): ``VISION_LAYERS`` layers prefill the
    pipeline's 256 patch embeddings + ``VISION_PROMPT`` tokens (K3 at q
    64 / kv 8 heads, G = 8, in every layer; its counts set to 0 just
    before and read just after) and decode ``VISION_DECODE`` greedy
    tokens; the prefill's top-1 with K3 equals its top-1 with plain
    attention; where the time goes (a profiled prefill and decode); then
    one timed training step at the depth the card's memory allows
    (:func:`vision_train_depth`). Nothing is published."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed.steps import batch_to_device
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain
    from repro_torch.models import Model
    from repro_torch.models import attention as attn

    full = get_config(VISION_ARCH)
    cfg = full.with_(n_layers=VISION_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = batch_to_device(TokenPipeline(cfg, VISION_PROMPT, 1, seed=0)
                            .batch_at({"data_step": 0, "seed": 0})[0], dev)
    inputs = {"tokens": batch["tokens"], "vis_embeds": batch["vis_embeds"]}
    assert inputs["vis_embeds"].shape == (1, cfg.vision_prefix, cfg.d_model)
    assert inputs["vis_embeds"].dtype == torch.bfloat16
    total = cfg.vision_prefix + VISION_PROMPT
    s_max = total + VISION_DECODE

    def generate():
        logits, caches = model.prefill(params, inputs, s_max)
        toks = [int(torch.argmax(logits[0]))]
        for i in range(VISION_DECODE - 1):
            lg, caches = model.decode(params, caches, torch.tensor([[toks[-1]]], device=dev),
                                      total + i)
            toks.append(int(torch.argmax(lg[0, -1])))
        return logits, caches, toks

    generate()  # warm: the first calls load kernels and size the allocator
    kernel, shapes = attn.flash_attention, Counter()

    def seen(q, k, v, **kw):  # records the call, then the wrapper launches and counts
        shapes[(tuple(q.shape), tuple(k.shape), str(q.dtype), kw.get("causal"))] += 1
        return kernel(q, k, v, **kw)

    # the main path: counts from 0 just before, read just after
    flash_ops.flash_attention.launches = 0
    flash_ops.flash_attention.wgmma_launches = 0
    attn.flash_attention = seen
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.prefill(params, inputs, s_max)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches_prefill = flash_ops.flash_attention.launches
        toks = [int(torch.argmax(logits[0]))]
        t0 = time.perf_counter()
        for i in range(VISION_DECODE):
            lg, caches = model.decode(params, caches, torch.tensor([[toks[-1]]], device=dev),
                                      total + i)
            toks.append(int(torch.argmax(lg[0, -1])))
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    finally:
        attn.flash_attention = kernel
    launches = {"flash_attention": flash_ops.flash_attention.launches,
                "flash_attention_wgmma": flash_ops.flash_attention.wgmma_launches}
    assert launches_prefill == launches["flash_attention"] == cfg.n_layers, launches
    assert launches["flash_attention_wgmma"] == cfg.n_layers, launches  # decode runs none
    want_shape = ((1, cfg.n_heads, total, cfg.resolved_head_dim),
                  (1, cfg.n_kv_heads, total, cfg.resolved_head_dim), "torch.bfloat16", True)
    assert dict(shapes) == {want_shape: cfg.n_layers}, shapes
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab) == \
        (full.d_model, full.n_heads, full.n_kv_heads, full.d_ff, full.vocab)  # full width
    assert caches["g0"]["k"].shape[2] == s_max and torch.isfinite(logits).all()

    # K3 against plain attention inside the model: the same prefill's top-1
    attn.flash_attention = flash_attention_plain
    try:
        plain, _ = model.prefill(params, inputs, s_max)
    finally:
        attn.flash_attention = kernel
    top1 = bool(torch.argmax(logits[0]) == torch.argmax(plain[0]))
    assert top1 and torch.isfinite(plain).all()
    in_model = {"prompt_positions": total, "logits_max_abs_diff": float((logits - plain)
                                                                        .abs().max()),
                "logits_max_abs": float(plain.abs().max()), "top1_agree": top1}
    del plain, caches

    where = {}
    for phase in ("prefill", "decode"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if phase == "prefill":
                model.prefill(params, inputs, s_max)
            else:
                generate()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        split = device_groups(prof)
        busy = split["busy_us"]
        where[phase] = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
                        "device_idle_share": 1 - busy / wall_us if split["device"] else None,
                        "kernel_launches": len(split["device"]),
                        "groups_ms": split["groups_ms"],
                        "top_kernels_ms": split["top_kernels_ms"],
                        "covers": "one prefill" if phase == "prefill"
                        else f"one prefill + {VISION_DECODE - 1} decode steps"}
    serve_peak = torch.cuda.max_memory_allocated(dev)
    del params, logits, lg
    gc.collect()
    torch.cuda.empty_cache()

    free = torch.cuda.mem_get_info(dev)[0]
    layers = vision_train_depth(full, free)
    torch.cuda.reset_peak_memory_stats(dev)
    step = profile_train(dev, layers, VISION_ARCH, VISION_PROMPT, 1)
    return {
        "config": {"arch": VISION_ARCH, "d_model": cfg.d_model,
                   "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim],
                   "gqa_group": cfg.n_heads // cfg.n_kv_heads,
                   "d_ff": cfg.d_ff, "vocab": cfg.vocab, "vision_prefix": cfg.vision_prefix,
                   "dtype": cfg.dtype, "tie_embeddings": cfg.tie_embeddings},
        "depth_cut": {"prefill_decode_layers": VISION_LAYERS, "train_layers": layers,
                      "of": full.n_layers},
        "init_s": init_s, "prefill_positions": total,
        "prefill_s": prefill_s, "prefill_tok_s": total / prefill_s,
        "decode_steps": VISION_DECODE, "decode_s": decode_s,
        "decode_tok_s": VISION_DECODE / decode_s, "tokens": toks,
        "k3_calls": {f"q{list(q)} k/v{list(k)} {dt} causal={c}": n
                     for (q, k, dt, c), n in shapes.items()},
        "launches": launches, "kernel_vs_plain_in_model": in_model,
        "where_the_time_goes": where, "peak_memory_bytes": serve_peak,
        "train_step": step, "train_free_bytes": free, "cmi_written": False,
    }


def _dryrun_cells() -> list[tuple[str, str, bool, bool, str, int, str]]:
    """``(arch, shape, seq_shard, moe_buf_shard, mesh, layers, file)`` of
    every dry-run cell the phase reads: qwen3's two on :data:`DRYRUN_MESH`,
    then command-r's tensor-parallel ones, the MoE ones and the hybrid,
    mLSTM and encoder-decoder ones on 16x16 (``layers`` a depth cut, 0 for
    none)."""
    cells = [(DRYRUN_ARCH, shape, False, False, DRYRUN_MESH, 0,
              f"{DRYRUN_ARCH}__{shape}__mesh{DRYRUN_MESH}.json") for shape in DRYRUN_SHAPES]
    for arch, shape, seq_shard, moe_buf, layers in _sharded_cells():
        name = (f"{arch}__{shape}__pod1" + (f"__l{layers}" if layers else "")
                + ("__seqshard" if seq_shard else "") + ("__moebuf" if moe_buf else ""))
        cells.append((arch, shape, seq_shard, moe_buf, "16x16", layers, name + ".json"))
    return cells


def _sharded_cells() -> list[tuple[str, str, bool, bool, int]]:
    """``(arch, shape, seq_shard, moe_buf_shard, layers)`` of the cells
    :func:`run_dryrun_tp` runs under the fake 16x16 group, in order."""
    return ([(DRYRUN_TP_ARCH, shape, ss, False, layers) for shape, ss, layers in DRYRUN_TP_CELLS]
            + list(DRYRUN_MOE_CELLS) + list(DRYRUN_MIXER_CELLS))


def start_dryrun(out: Path) -> list[subprocess.Popen]:
    """``python -m repro_torch.launch.dryrun`` for each of
    :func:`_dryrun_cells` on the fake 16x16 cuda mesh (a fake process group
    of 256 ranks; nothing runs on the card), started now and read by
    :func:`finish_dryrun`."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                              arch, "--shape", shape, "--out", str(out), "--force",
                              *(["--seq-shard"] if seq_shard else []),
                              *(["--moe-buf-shard"] if moe_buf else []),
                              *(["--mesh", mesh] if mesh != "16x16" else []),
                              *(["--layers", str(layers)] if layers else [])],
                             cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for arch, shape, seq_shard, moe_buf, mesh, layers, _ in _dryrun_cells()]


def finish_dryrun(procs: list[subprocess.Popen], out: Path) -> dict:
    """Each dry-run cell's record by file name, its process ended with 0
    and the cell ``ok`` on the ``tp`` path."""
    cells = {}
    for (arch, shape, seq_shard, moe_buf, mesh, _, name), proc in zip(_dryrun_cells(), procs):
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, (arch, shape, log[-3000:])
        rec = json.loads((out / name).read_text())
        assert rec["ok"] and rec["device"] == "cuda" and rec["mesh"] == mesh, rec
        assert rec["seq_shard"] == seq_shard and rec["moe_buf_shard"] == moe_buf, rec
        assert rec["path"] == "tp", rec
        cells[name] = rec
    return cells


def _on_mesh(tree, shardings):
    """``tree``'s tensors as DTensors on a 1x1 mesh, each sharing its
    tensor's storage (every block of a 1x1 mesh is the whole tensor)."""
    from repro_torch.distributed.sharding import from_local
    from repro_torch.utils import flatten_with_paths

    flat, treedef = flatten_with_paths(tree)
    sh, _ = flatten_with_paths(shardings)
    return treedef.unflatten({k: from_local(v, v.shape, sh[k]) for k, v in flat.items()})


def _timed(fn) -> tuple:
    """``(fn(), wall s, device ms)``: the host clock and CUDA events around
    one call, synchronised."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, time.perf_counter() - t0, start.elapsed_time(end)


def _counted_flops(fn) -> float:
    from repro_torch.launch.hlo_stats import count

    return count(fn)[1]["flops"]  # the step's outputs go with the tuple


def _fill(spec, dev, seed: int) -> torch.Tensor:
    """A cache leaf filled layer by layer from generators seeded ``seed +
    i`` (so :func:`_fill_layer` can make any layer's values again)."""
    t = torch.empty(spec.shape, dtype=spec.dtype, device=dev)
    for i in range(spec.shape[0]):
        _fill_layer(t[i], seed + i)
    return t


def _fill_layer(t: torch.Tensor, seed: int) -> torch.Tensor:
    return t.normal_(generator=torch.Generator(t.device).manual_seed(seed))


def run_1x1_cells(dev) -> tuple[dict, dict]:
    """qwen3-1.7b's prefill_32k and decode_32k per-device steps on a 1x1
    NCCL mesh (see :func:`run_dryrun`): ``(prefill, decode)`` records."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed.group import free_port, in_group
    from repro_torch.distributed.steps import make_decode_step, make_prefill_step
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.utils import flatten_with_paths, tree_nbytes

    cfg = get_config(DRYRUN_ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.dtype) == (28, 2048, 16, 8, 128, "bfloat16"), cfg
    pre, dec = (SHAPES[s] for s in DRYRUN_SHAPES)
    pre = InputShape(pre.name, pre.seq_len, pre.global_batch // DRYRUN_DATA_RANKS, pre.kind)
    dec = InputShape(dec.name, dec.seq_len, dec.global_batch // DRYRUN_DATA_RANKS, dec.kind)
    gc.collect()
    torch.cuda.empty_cache()
    model = Model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0))
    gen = torch.Generator(dev).manual_seed(1)
    with in_group(0, 1, free_port(), "cuda", 600):
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        # prefill: counts from 0 just before, read just after
        step, p_sh, _ = make_prefill_step(cfg, mesh, pre)
        dparams = _on_mesh(params, p_sh)
        batch = {"tokens": torch.randint(0, cfg.vocab, (pre.global_batch, pre.seq_len),
                                         generator=gen, device=dev, dtype=torch.int32)}
        flash_attention.launches = flash_attention.wgmma_launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        (logits, caches), wall, dev_ms = _timed(lambda: step(dparams, batch))
        launches = {"flash_attention": flash_attention.launches,
                    "flash_attention_wgmma": flash_attention.wgmma_launches}
        peak = torch.cuda.max_memory_allocated(dev)
        assert launches == {"flash_attention": cfg.n_layers,
                            "flash_attention_wgmma": cfg.n_layers}, launches
        (want_l, want_c), ref_wall, ref_ms = _timed(
            lambda: model.prefill(params, batch, pre.seq_len))
        got_c, _ = flatten_with_paths(caches)
        want_c, _ = flatten_with_paths(want_c)
        assert torch.equal(logits.to_local(), want_l), "prefill logits differ from no mesh's"
        assert sorted(got_c) == sorted(want_c)
        for path, c in got_c.items():
            assert torch.equal(c.to_local(), want_c[path]), f"prefill cache {path} differs"
        cache_bytes, cache_leaves = tree_nbytes(want_c), sorted(got_c)
        del logits, caches, want_l, want_c, got_c
        steady = _timed(lambda: step(dparams, batch))  # warm: cuBLAS has seen the shapes
        steady_wall, steady_ms = steady[1:]
        del steady
        flops = _counted_flops(lambda: step(dparams, batch))
        prefill = {"shape": f"B{pre.global_batch} S{pre.seq_len} (prefill_32k / "
                            f"{DRYRUN_DATA_RANKS} data ranks)",
                   "wall_s": wall, "device_ms": dev_ms, "steady_wall_s": steady_wall,
                   "steady_device_ms": steady_ms, "no_mesh_wall_s": ref_wall,
                   "no_mesh_device_ms": ref_ms, "launches": launches,
                   "bitwise_equal_no_mesh": {"logits": True, "caches": cache_leaves},
                   "flops": flops, "tflops_per_s": flops / steady_ms / 1e9,
                   "bf16_peak_share": flops / (steady_ms / 1e3) / BF16_FLOPS,
                   "cache_bytes": cache_bytes, "max_memory_allocated": peak}
        del batch
        torch.cuda.empty_cache()

        # decode: 8 sequences over a 32,768-deep cache, pos 32,767
        step, _, c_sh = make_decode_step(cfg, mesh, dec)
        specs, treedef = flatten_with_paths(model.cache_struct(dec.global_batch, dec.seq_len))
        seeds = {path: 1000 * (j + 1) for j, path in enumerate(sorted(specs))}
        caches = treedef.unflatten({k: _fill(s, dev, seeds[k]) for k, s in specs.items()})
        dcaches = _on_mesh(caches, c_sh)
        tokens = torch.randint(0, cfg.vocab, (dec.global_batch, 1), generator=gen,
                               device=dev, dtype=torch.int32)
        pos = dec.seq_len - 1
        torch.cuda.reset_peak_memory_stats(dev)
        # the returned caches are the arguments, written in place: not kept
        (logits, returned), wall, dev_ms = _timed(lambda: step(dparams, dcaches, tokens, pos))
        del returned
        dpeak = torch.cuda.max_memory_allocated(dev)
        reps = [_timed(lambda: step(dparams, dcaches, tokens, pos))[1:] for _ in range(3)]
        want_l, returned = model.decode(params, caches, tokens, pos)
        del returned
        assert torch.equal(logits.to_local(), want_l), "decode logits differ from no mesh's"
        del logits, want_l
        written = {}
        for path, t in flatten_with_paths(caches)[0].items():
            same = changed = True
            for i in range(t.shape[0]):
                regen = _fill_layer(torch.empty_like(t[i]), seeds[path] + i)
                same &= (torch.equal(t[i][:, :pos], regen[:, :pos])
                         and torch.equal(t[i][:, pos + 1:], regen[:, pos + 1:]))
                changed &= not torch.equal(t[i][:, pos], regen[:, pos])
                del regen
            assert same and changed, (path, same, changed)
            written[path] = f"only pos {pos}, every layer"
        dflops = _counted_flops(lambda: step(dparams, dcaches, tokens, pos))
        read = tree_nbytes(caches) + tree_nbytes(params)
        med_ms = statistics.median([ms for _, ms in reps])
        decode = {"shape": f"B{dec.global_batch} over {dec.seq_len} positions (decode_32k / "
                           f"{DRYRUN_DATA_RANKS} data ranks), pos {pos}",
                  "wall_s": wall, "device_ms": dev_ms,
                  "steady_device_ms": [ms for _, ms in reps], "steady_wall_s":
                  [w for w, _ in reps], "bitwise_equal_no_mesh": {"logits": True},
                  "written": written, "flops": dflops,
                  "bytes_read_bound": read, "bound_ms": read / HBM_BYTES_PER_S * 1e3,
                  "bound_share": read / HBM_BYTES_PER_S * 1e3 / med_ms,
                  "cache_bytes": tree_nbytes(caches), "max_memory_allocated": dpeak}
        del caches, dcaches, dparams
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return prefill, decode


def run_dryrun(root: Path, dev) -> dict:
    """The dry run (subprocesses, while the card works: qwen3-1.7b's two
    cells on a fake 16x1 cuda mesh, command-r's on 16x16), and qwen3's
    per-device steps for real on a 1x1 NCCL mesh (a group of one; a model
    axis of 1 runs the plain model) at full width and depth, random
    weights from seed 0:

    * prefill_32k: ``make_prefill_step`` on 32 / 16 = 2 sequences of
      32,768 tokens (K3 in every layer: its counts set to 0 just before,
      read just after); its logits and every cache leaf bitwise
      ``Model.prefill``'s without a mesh, on the same card;
    * decode_32k: ``make_decode_step`` on 128 / 16 = 8 sequences over a
      32,768-deep cache filled from seeded generators, at pos 32,767; its
      logits bitwise ``Model.decode``'s, the cache written only at pos;

    and each step's FLOPs, counted by ``launch.hlo_stats.StepCounter`` over
    the real step, within 0.1 % of the dry run's per-device count. Times,
    TFLOP/s, bytes against the card's bound, and peak memory against the
    dry run's. Then :func:`run_dryrun_tp`."""
    out_dir = root / "cells"
    procs = start_dryrun(out_dir)
    try:
        # qwen3's cells in a frame of their own: none of their tensors (the
        # 30 GB decode cache) outlives it
        prefill, decode = run_1x1_cells(dev)
        tp_cells = run_dryrun_tp(dev, _sharded_cells())
        cells = finish_dryrun(procs, out_dir)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    names = {shape: name for arch, shape, _, _, _, _, name in _dryrun_cells()
             if arch == DRYRUN_ARCH}
    for shape, real in (("prefill_32k", prefill), ("decode_32k", decode)):
        cell = cells[names[shape]]
        real["path"] = cell["path"]
        real["dryrun"] = {k: cell[k] for k in ("cost", "memory", "collectives", "trace_s",
                                               "total_s")}
        real["flops_rel_diff"] = abs(real["flops"] - cell["cost"]["flops"]) / cell["cost"]["flops"]
        real["peak_over_dryrun_peak"] = (real["max_memory_allocated"]
                                         / cell["memory"]["peak_memory_in_bytes"])
        assert real["flops_rel_diff"] <= DRYRUN_FLOPS_TOL, (shape, real["flops"], cell["cost"])
    from repro_torch.configs import get_config

    card = torch.cuda.get_device_properties(dev).total_memory
    for (arch, shape, seq_shard, moe_buf, _, _, name), real in zip(
            [c for c in _dryrun_cells() if c[0] != DRYRUN_ARCH], tp_cells):
        cell = cells[name]
        flops = cell["cost"]["flops"]
        real.update({
            "dryrun": {k: cell[k] for k in ("cost", "memory", "collectives", "trace_s",
                                            "total_s", "experts", "moe_buf_shard")},
            "dryrun_flops": flops, "tflops_per_s": flops / real["device_ms"] / 1e9,
            "bf16_peak_share": flops / (real["device_ms"] / 1e3) / BF16_FLOPS,
            "card_memory_bytes": card,
            "peak_over_dryrun_peak": (real["max_memory_allocated"]
                                      / cell["memory"]["peak_memory_in_bytes"]),
            "peak_over_card": real["max_memory_allocated"] / card})
        assert real["max_memory_allocated"] < card, (name, real["max_memory_allocated"], card)
        assert cell["experts"] == real["experts"], (name, cell["experts"], real["experts"])
        # what the process held beyond the step's arguments (cuBLAS's
        # workspaces, ~70 MB, which the dry run does not count) taken out
        extra = real["arguments_bytes"] - cell["memory"]["argument_size_in_bytes"]
        real["held_beyond_arguments_bytes"] = extra
        assert abs(extra) <= DRYRUN_HELD_MAX, (name, extra)
        real["peak_net_over_dryrun_peak"] = ((real["max_memory_allocated"] - extra)
                                             / cell["memory"]["peak_memory_in_bytes"])
        assert abs(real["peak_net_over_dryrun_peak"] - 1) <= DRYRUN_PEAK_TOL, (name, real)
        if get_config(arch).moe:
            real["all_to_all"] = cell["collectives"]["by_kind"].get("all-to-all")
            if "data" in real["experts"]:  # tokens move to experts over (data, model)
                assert real["all_to_all"] and real["all_to_all"]["count"] > 0, (name, real)
    n_tp, n_moe = len(DRYRUN_TP_CELLS), len(DRYRUN_MOE_CELLS)
    tp = dict(zip([f"{shape}" + ("_seq_shard" if ss else "") for shape, ss, _ in DRYRUN_TP_CELLS],
                  tp_cells[:n_tp]))

    def by_name(cells, recs):
        return {f"{arch}__{shape}" + ("__seq_shard" if ss else "")
                + ("__moe_buf_shard" if mb else ""): rec
                for (arch, shape, ss, mb, _), rec in zip(cells, recs)}

    moe = by_name(DRYRUN_MOE_CELLS, tp_cells[n_tp:n_tp + n_moe])
    mixers = by_name(DRYRUN_MIXER_CELLS, tp_cells[n_tp + n_moe:])
    launches = {k: prefill["launches"][k] + sum(c["launches"][k] for c in tp_cells)
                for k in prefill["launches"]}
    launches["flash_attention_bwd"] = sum(c["launches"]["flash_attention_bwd"] for c in tp_cells)
    return {"arch": DRYRUN_ARCH, "mesh": "1x1 (data, model), cuda, nccl, world 1",
            "dryrun_mesh": f"{DRYRUN_MESH} fake cuda ({DRYRUN_DATA_RANKS} ranks): the 1x1 "
                           "step's per-device program (the whole model, a 16th of the batch)",
            "prefill_32k": prefill,
            "decode_32k": decode, "tensor_parallel": {
                "arch": DRYRUN_TP_ARCH, "mesh": "16x16 (data, model), rank 0 of a fake group "
                "of 256 on real card tensors", "not_compared": "the fake group's collectives "
                "move no bytes and leave their outputs unwritten: no output is compared with "
                "anything, and no time includes communication", **tp},
            "moe": {"mesh": "16x16 (data, model), rank 0 of a fake group of 256 on real card "
                            "tensors", "not_compared": "as tensor_parallel's: shapes, launches, "
                    "memory and the dry run's FLOPs only", **moe},
            "mixers": {"mesh": "16x16 (data, model), rank 0 of a fake group of 256 on real "
                               "card tensors", "not_compared": "as tensor_parallel's: shapes, "
                       "launches, memory and the dry run's FLOPs only (correctness is held "
                       "on the CPU: tests/test_torch_mesh_hybrid.py, "
                       "tests/test_torch_mesh_encdec.py)", **mixers},
            "launches": launches}


def _real_dtensors(specs, shardings, dev, seed: int):
    """Rank 0's DTensor a leaf of ``specs`` (TensorSpecs) placed by the
    parallel ``shardings``, each local block real on the card: optimizer
    moments zero, integers zero, other floating leaves normal * 0.02 from
    a generator seeded ``seed`` (the values are never compared)."""
    from repro_torch.distributed.sharding import from_local
    from repro_torch.utils import flatten_with_paths

    flat, treedef = flatten_with_paths(specs)
    sh, _ = flatten_with_paths(shardings)
    gen = torch.Generator(dev).manual_seed(seed)
    out = {}
    for path, spec in flat.items():
        index = sh[path].shard_index(spec.shape, sh[path].mesh.get_coordinate())
        local = torch.empty([b - a for a, b in index], dtype=spec.dtype, device=dev)
        if spec.dtype.is_floating_point and not path.startswith(("opt/mu/", "opt/nu/")):
            local.normal_(0.0, 0.02, generator=gen)
        else:
            local.zero_()
        out[path] = from_local(local, spec.shape, sh[path])
    return treedef.unflatten(out)


# each sharded cell's arch at full width: (layers, d_model, heads, kv heads,
# d_ff, vocab, dtype), and what a device of 16x16 holds of it
_WIDTHS = {
    "hymba-1.5b": ((32, 1600, 25, 5, 5504, 32001, "bfloat16"),
                   "25 q / 5 kv heads and 25 SSD heads whole (25 do not divide 16), window "
                   "2048, mlp 344, vocab 32001 whole"),
    "xlstm-1.3b": ((48, 2048, 4, 4, 0, 50304, "bfloat16"),
                   "4 mLSTM heads whole (4 do not divide 16), vocab 3144 a model rank"),
    "whisper-tiny": ((4, 384, 6, 6, 1536, 51865, "bfloat16"),
                     "6 heads whole in each attention, mlp 96, vocab 51865 whole; 4 encoder "
                     "layers over 1500 frames"),
    "command-r-plus-104b": ((64, 12288, 96, 8, 33792, 256000, "bfloat16"),
                            "6 q heads / 1 kv head, mlp 2112, vocab 16000 a model rank"),
    "deepseek-v3-671b": ((61, 7168, 128, 128, 18432, 129280, "bfloat16"),
                         "8 of 128 MLA heads (qk 192 / v 128), 1 of 256 experts a MoE layer, "
                         "mlp 1152 (shared expert 128), vocab 8080 a device"),
    "granite-moe-1b-a400m": ((24, 1024, 16, 8, 512, 49155, "bfloat16"),
                             "1 q head / its kv head, 2 of 32 experts a layer (over model), "
                             "vocab 49155 whole"),
}


def run_dryrun_tp(dev, cells) -> list[dict]:
    """Rank 0's tensor-parallel steps of ``cells`` (``(arch, shape,
    seq_shard, moe_buf_shard, layers)``: command-r-plus-104b's, the MoE
    ones, then the hybrid, mLSTM and encoder-decoder ones) on the card,
    each arch at full width: this process joins a fake group of 256 ranks
    (its collectives return at once and write nothing) and makes the 16x16
    production mesh over it; the params and train state are rank 0's real
    blocks (:func:`_real_dtensors`), the batch the global one (each step
    takes its data block; whisper's frames drawn too). K3's counts set to
    0 just before each step and read just after: a prefill's
    :func:`k3_per_forward` launches, a train step's twice as many with lse
    (the forward and its recompute), all tensor-core (none for the
    mLSTM). Each step's wall and device time (CUDA events; the collectives
    take none) and peak memory, each step run once. The group is destroyed
    at the end."""
    import torch.distributed as dist

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.steps import (make_prefill_step, make_train_step,
                                               model_axes_for, state_struct_for,
                                               train_state_shardings)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.dryrun import join_fake_group
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.optim import AdamWConfig

    gen = torch.Generator(dev).manual_seed(2)
    out = []

    def counts():
        return {"flash_attention": flash_attention.launches,
                "flash_attention_wgmma": flash_attention.wgmma_launches,
                "flash_attention_lse": flash_attention.lse_launches,
                "flash_attention_bwd": flash_attention.bwd_launches,
                "flash_attention_bwd_mma": flash_attention.bwd_mma_launches}

    join_fake_group(256)
    try:
        mesh = make_production_mesh(multi_pod=False, device_type="cuda")
        for arch, shape_name, seq_shard, moe_buf, layers in cells:
            cfg = get_config(arch)
            widths, holds = _WIDTHS[arch]
            assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab,
                    cfg.dtype) == widths, cfg
            shape = SHAPES[shape_name]
            ccfg = cfg.with_(n_layers=layers) if layers else cfg
            gc.collect()
            torch.cuda.empty_cache()
            tokens = torch.randint(0, cfg.vocab, (shape.global_batch, shape.seq_len),
                                   generator=gen, device=dev, dtype=torch.int32)
            frames = {}
            if cfg.encdec:  # the encoder's stub frames
                frames["enc_frames"] = torch.randn(
                    (shape.global_batch, cfg.enc_seq, cfg.d_model), generator=gen, device=dev,
                    dtype=torch.bfloat16)
            if shape.kind == "prefill":
                step, p_sh, _ = make_prefill_step(ccfg, mesh, shape)
                args = (_real_dtensors(model_axes_for(ccfg)[1], p_sh, dev, 0),
                        {"tokens": tokens, **frames})
            else:
                opt_cfg = AdamWConfig(moment_dtype=ccfg.opt_moment_dtype)
                step = make_train_step(ccfg, opt_cfg, mesh=mesh, seq_shard=seq_shard,
                                       moe_buf_shard=moe_buf)
                # no name binds the state: it goes with args, before the next cell
                args = (_real_dtensors(state_struct_for(ccfg, opt_cfg),
                                       train_state_shardings(ccfg, opt_cfg, mesh), dev, 0),
                        {"tokens": tokens, "labels": tokens, **frames})
            torch.cuda.synchronize(dev)
            held = torch.cuda.memory_allocated(dev)
            flash_attention.launches = flash_attention.wgmma_launches = 0
            flash_attention.lse_launches = 0
            flash_attention.bwd_launches = flash_attention.bwd_mma_launches = 0
            torch.cuda.reset_peak_memory_stats(dev)
            res, wall, dev_ms = _timed(lambda: step(*args))
            launches = counts()
            peak = torch.cuda.max_memory_allocated(dev)
            del res
            rec = {"arch": arch,
                   "shape": f"{shape_name}: B{shape.global_batch // 16} S{shape.seq_len} a "
                            f"device (16 data ranks), {holds}"
                            + (", seq_shard" if seq_shard else "")
                            + (", moe_buf_shard" if moe_buf else ""),
                   "path": step.path, "experts": step.experts, "wall_s": wall,
                   "device_ms": dev_ms, "launches": launches, "arguments_bytes": held,
                   "max_memory_allocated": peak,
                   "depth_cut": f"{layers} of {cfg.n_layers} layers" if layers else None}
            n = k3_per_forward(ccfg)
            if shape.kind == "prefill":
                assert launches == {"flash_attention": n, "flash_attention_wgmma": n,
                                    "flash_attention_lse": 0, "flash_attention_bwd": 0,
                                    "flash_attention_bwd_mma": 0}, launches
            else:  # the forward and its recomputation with lse, one tensor-core backward
                assert launches == {"flash_attention": 2 * n, "flash_attention_wgmma": 2 * n,
                                    "flash_attention_lse": 2 * n, "flash_attention_bwd": n,
                                    "flash_attention_bwd_mma": n}, launches
            assert step.path == "tp", step.path
            del args, tokens, frames
            out.append(rec)
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    return out


def run_quickstart() -> dict:
    """``examples/torch_quickstart.py --device cuda`` (qwen3's smoke config
    reclaimed at step 17 and resumed) in a process of its own."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "examples/torch_quickstart.py", "--device", "cuda"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    assert "quickstart: job finished after a reclaim at step 17" in lines, lines[-5:]
    return {"seconds": seconds, "final_loss": next(ln for ln in lines if "final loss" in ln)}


def run_mesh(root: Path, dev, no_mesh: dict) -> dict:
    """whisper-tiny through the launcher on a 1×1 ``("data", "model")`` cuda
    mesh, an NCCL group of one, at train_encdec's arguments, reclaimed at
    step 2 and resumed (``--remesh 1x1,1x1``): its final CMI is bitwise the
    same arguments' uninterrupted run without a mesh (train_encdec's A:
    ``no_mesh``'s chunk digests and losses; the placements are trivial);
    the state it resumed from is its step-2 CMI; every array's sharding
    record names ``mesh_shape [1, 1]`` and the rules' spec. The launcher
    counts its own K3 launches from 0."""
    from repro_torch.checkpoint import load_manifest
    from repro_torch.configs import get_config
    from repro_torch.core import JobStore
    from repro_torch.core.cmi import restore_cmi
    from repro_torch.distributed.sharding import AbstractMesh
    from repro_torch.distributed.steps import train_state_shardings
    from repro_torch.launch.train import state_digest
    from repro_torch.optim import AdamWConfig
    from repro_torch.utils import flatten_with_paths

    root.mkdir(parents=True, exist_ok=True)
    store = root / "jobs"
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec = _launch_train(root, "B", store, train_argv(ENCDEC_ARCH) + [
        "--remesh", "1x1,1x1", "--preempt-at", str(TRAIN_PREEMPT_AT)])
    wall = time.perf_counter() - t0
    js = JobStore(store)
    end = rec[-1]
    job = js.read_job(end["job_id"])
    man = load_manifest(js.cmi_root(job.job_id), job.cmi)
    assert _digests(man) == no_mesh["digests"], "the mesh run's state differs from no mesh's"
    losses = [r["loss"] for r in rec if r["event"] == "step"]
    assert losses == no_mesh["losses"] and len(losses) == TRAIN_STEPS, (losses, no_mesh["losses"])
    starts = [(r["mesh"], r["resumed"], r["step"]) for r in rec if r["event"] == "start"]
    assert starts == [("1x1", False, 0), ("1x1", True, TRAIN_PREEMPT_AT)], starts
    assert end["incarnations"] == 2 and job.status == "finished"
    resumed = next(r for r in rec if r["event"] == "start" and r["resumed"])
    published = next(r["cmi"] for r in rec
                     if r["event"] == "publish" and r["step"] == TRAIN_PREEMPT_AT)
    state, _ = restore_cmi(js.cmi_root(job.job_id), published, device="cpu")
    assert resumed["restored_digest"] == state_digest(state)
    del state
    cfg = get_config(ENCDEC_ARCH)
    want = flatten_with_paths(train_state_shardings(
        cfg, AdamWConfig(moment_dtype=cfg.opt_moment_dtype),
        AbstractMesh((1, 1), ("data", "model"))))[0]
    records = {p: e.sharding for p, e in man.arrays.items()}
    assert sorted(records) == sorted(want)
    for path, got in records.items():
        assert (got.mesh_shape, got.mesh_axes) == ([1, 1], ["data", "model"]), path
        assert got.pspec == want[path].record().pspec, path
    per_run = 2 * TRAIN_STEPS * k3_per_forward(cfg)  # forward + remat recompute
    assert end["launches"]["flash_attention"] == per_run, end["launches"]
    assert (end["launches"]["flash_attention_bwd"] == end["launches"]["flash_attention_bwd_mma"]
            == per_run // 2), end["launches"]
    return {"arch": ENCDEC_ARCH, "mesh": "1x1 (data, model), cuda, nccl, world 1",
            "remesh": "1x1,1x1", "preempt_at": TRAIN_PREEMPT_AT,
            "vs": "train_encdec.A (no mesh, uninterrupted)",
            "bitwise_equal_no_mesh_uninterrupted": True, "losses": losses,
            "restored_equals_published": True,
            "sharding_record": {"mesh_shape": [1, 1], "mesh_axes": ["data", "model"],
                                "params/embed": records["params/embed"].pspec,
                                "step": records["step"].pspec},
            "step_s": [r["s"] for r in rec if r["event"] == "step"],
            "publish_s": [r["s"] for r in rec if r["event"] == "publish"],
            "restart_s": resumed["s"], "wall_s": wall, "incarnations": end["incarnations"],
            "launches": end["launches"], "peak_memory_bytes": end["peak_memory_bytes"]}


def k3_lse_case(dev, b: int, h: int, hkv: int, sq: int, sk: int, d: int, dv: int,
                causal: bool, win: int, seed: int) -> dict:
    """K3 with lse (the training forward) at one shape against its plain
    version (lse within LSE_TOL, the output within one bf16 rounding), its
    time with and without lse, SDPA's forward (saving its lse for a
    backward; a window as a boolean mask) and backward; K3's backward
    kernels (``repro_torch::flash_attention_bwd``, the tensor-core variant
    at (D, Dv) in ``WGMMA_HEAD_DIMS``) against the plain attention backward
    on the same inputs (within BWD_BF16_TOL, as tests/test_torch_cuda.py
    holds them; two calls bitwise equal) and against its float32 answer
    within :func:`bwd_rounding`'s limit, which a planted fault (key tile 0
    skipped in dq) must break; the kernels' time and the plain backward's,
    beside the forward's and backward's bounds."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as flash_ops

    mask = torch.ones(sq, sk, dtype=torch.bool, device=dev).tril().triu(-(win - 1)) if win else None
    sdpa_kw = {"attn_mask": mask, "is_causal": causal and mask is None, "enable_gqa": True}
    rng = np.random.default_rng(seed)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
        dev, torch.bfloat16) for shape in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv),
                                          (b, h, sq, dv)))
    got, lse = flash_ops._forward(q, k, v, causal, win, None, True)
    assert torch.equal(got, flash_ops.flash_attention(q, k, v, causal=causal, window=win))
    t0 = time.perf_counter()
    want, want_lse = flash_ops.flash_attention_plain(q, k, v, causal=causal, window=win,
                                                     return_lse=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    lse_err = float((lse - want_lse).abs().max())
    assert lse_err <= LSE_TOL, lse_err
    rounding = one_bf16_rounding(got, flash_ops.flash_attention_plain(
        q.float(), k.float(), v.float(), causal=causal, window=win))
    t0 = time.perf_counter()
    grads = flash_ops.flash_attention_backward_plain(q, k, v, got, lse, dout, causal=causal,
                                                     window=win)
    torch.cuda.synchronize()
    bwd_first_ms = (time.perf_counter() - t0) * 1e3
    assert all(torch.isfinite(g).all() for g in grads)
    bwd_args = (q, k, v, got, lse, dout, causal, win, d ** -0.5)
    fa = flash_ops.flash_attention
    before = (fa.bwd_launches, fa.bwd_mma_launches)
    kgrads = flash_ops.flash_attention_bwd(*bwd_args)
    mma = (d, dv) in flash_ops.WGMMA_HEAD_DIMS
    assert (fa.bwd_launches, fa.bwd_mma_launches) == (before[0] + 1, before[1] + mma)
    bwd_err = 0.0
    for kg, pg in zip(kgrads, grads):
        torch.testing.assert_close(kg.float(), pg.float(), atol=BWD_BF16_TOL, rtol=BWD_BF16_TOL)
        bwd_err = max(bwd_err, float((kg.float() - pg.float()).abs().max()))
    assert all(torch.equal(a, b) for a, b in zip(kgrads, flash_ops.flash_attention_bwd(*bwd_args)))
    ref32 = flash_ops.flash_attention_backward_plain(q.float(), k.float(), v.float(), got.float(),
                                                     lse, dout.float(), causal=causal, window=win)
    bwd_rnd = bwd_rounding(kgrads, ref32)
    assert bwd_rnd["limit_use"] <= 1.0, bwd_rnd
    faulty = dq_without_key_tile(q, k, v, got, lse, dout, kgrads[0], causal, win)
    fault = bwd_rounding((faulty, *kgrads[1:]), ref32)["dq"]
    fault["passes_1e-2"] = bool(torch.allclose(faulty.float(), grads[0].float(),
                                               atol=BWD_BF16_TOL, rtol=BWD_BF16_TOL))
    assert fault["limit_use"] > 1.0, fault  # the check fails the planted fault
    del grads, kgrads, ref32, faulty
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    sdpa = F.scaled_dot_product_attention(*leaves, **sdpa_kw)
    work = k3_work(b, h, hkv, sq, sk, d, dv, causal, win)
    pairs = work["visible_pairs"]
    # the backward: S recomputed, dQ = dS K and dK = dS^T Q over D; dV = P^T
    # dO and dP = dO V^T over Dv (10 D a pair where Dv = D); the kernels'
    # own products: S and dP once more in the dQ pass, and each product
    # with P or dS twice (its bf16 hi and lo halves), 2 (6 D + 5 Dv)
    bwd_flops = 2 * b * h * (3 * d + 2 * dv) * pairs
    bwd_floor_flops = 2 * b * h * (6 * d + 5 * dv) * pairs
    nbytes = work["bytes"]
    out = {
        "shape": f"q bf16[{b},{h},{sq},{d}], k bf16[{b},{hkv},{sk},{d}], "
                 f"v bf16[{b},{hkv},{sk},{dv}], " + ("causal" if causal else "non-causal")
                 + (f", window {win}" if win else ""),
        "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL,
        "rounding_limit_use": rounding["rounding_limit_use"],
        "ms": cuda_ms(lambda: flash_ops._forward(q, k, v, causal, win, None, False), 20),
        "lse_ms": cuda_ms(lambda: flash_ops._forward(q, k, v, causal, win, None, True), 20),
        "lse_kernel_only_ms": profiled_ms(
            lambda: flash_ops._forward(q, k, v, causal, win, None, True),
            "flash_fwd_kernel_wgmma", 20),
        "plain_ms": plain_ms,
        "library_sdpa_forward_with_lse_ms": cuda_ms(
            lambda: F.scaled_dot_product_attention(*leaves, **sdpa_kw), 20),
        "library_sdpa_backend": sdpa_backend(
            lambda: F.scaled_dot_product_attention(*leaves, **sdpa_kw)),
        "library_sdpa_backward_ms": cuda_ms(
            lambda: torch.autograd.grad(sdpa, leaves, dout, retain_graph=True), 10),
        "attention_backward_ms": cuda_ms(lambda: flash_ops.flash_attention_bwd(*bwd_args), 10),
        "attention_backward_kernel_only_ms": profiled_ms(
            lambda: flash_ops.flash_attention_bwd(*bwd_args), "flash_bwd", 10, per_call=3),
        "attention_backward_kernel": "wgmma" if mma else "cuda-core",
        "attention_backward_max_abs_err": bwd_err, "attention_backward_tol": BWD_BF16_TOL,
        "attention_backward_vs_f32": bwd_rnd,
        "attention_backward_rounding_limit_use": bwd_rnd["limit_use"],
        "attention_backward_planted_fault": {
            "fault": "key tile 0 (64 keys) skipped in dq's later half of the rows that see "
                     "it", **fault},
        "attention_backward_plain_ms": cuda_ms(
            lambda: flash_ops.flash_attention_backward_plain(q, k, v, got, lse, dout,
                                                             causal=causal, window=win), 3),
        "attention_backward_plain_first_ms": bwd_first_ms,
        "visible_pairs": pairs,
        "forward_bound_ms": work["bound_ms"],
        "backward_bound_ms": max(bwd_flops / BF16_FLOPS,
                                 (nbytes * 2 + b * h * sq * (dv * 2 + 4)) / HBM_BYTES_PER_S) * 1e3,
        "backward_bound_by": "operations",
        "backward_floor_ms": bwd_floor_flops / BF16_FLOPS * 1e3,
    }
    # the share of the bf16 peak the kernels reach on their own products
    kernel_ms = out["attention_backward_kernel_only_ms"]
    out["backward_floor_share"] = out["backward_floor_ms"] / kernel_ms if kernel_ms else None
    del q, k, v, dout, got, lse, want, want_lse, leaves, sdpa
    torch.cuda.empty_cache()
    return out


def check_k3_training(dev, arch: str = TRAIN_ARCH, gradients: bool = True,
                      seq: int = TRAIN_SEQ, batches: tuple[int, ...] = (1, TRAIN_BATCH)) -> dict:
    """K3 with lse (:func:`k3_lse_case`) at ``arch``'s heads and window and
    ``seq`` tokens, at the serve and the training batch; then
    (``gradients``) a 2-layer float32 model's gradients with K3 against
    plain attention under autograd."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import Model
    from repro_torch.models import attention as attn
    from repro_torch.utils import flatten_with_paths

    cfg = get_config(arch)
    h, hkv, d, win = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.window
    out = {label: k3_lse_case(dev, b, h, hkv, seq, seq, d, d, True, win, seed=b)
           for label, b in zip(("serve_shape", "train_shape"), batches)}
    if not gradients:
        return out

    # the model's gradients with K3 (float32: the CUDA-core kernel) against
    # plain attention differentiated by autograd, same weights and batch
    small = cfg.with_(n_layers=2, dtype="float32")
    model = Model(small)
    params = model.init(torch.Generator(dev).manual_seed(0))
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, small.vocab, (1, seq + 1))).to(dev)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def loss_and_grads():
        flat, treedef = flatten_with_paths(params)
        leaves = {key: t.detach().requires_grad_(True) for key, t in flat.items()}
        loss = model.loss(treedef.unflatten(leaves), batch)
        return loss, dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    fa = flash_ops.flash_attention
    before = (fa.lse_launches, fa.bwd_launches, fa.bwd_mma_launches)
    loss, grads = loss_and_grads()
    k3_runs = fa.lse_launches - before[0]
    bwd_runs = (fa.bwd_launches - before[1], fa.bwd_mma_launches - before[2])
    assert k3_runs == 2 * small.n_layers, k3_runs
    assert bwd_runs == (small.n_layers, 0), bwd_runs  # float32: the CUDA-core kernels
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
        "config": f"{arch} widths, 2 layers, float32, B1 S{seq}", "loss": float(loss.detach()),
        "loss_plain_attention": float(want_loss.detach()), "k3_launches": k3_runs,
        "k3_backward_launches": bwd_runs[0],
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

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda, device=kind,
         count=torch.cuda.device_count(), nvidia_smi=smi, python=sys.version.split()[0],
         clocks_sm_and_max=nvidia_smi("clocks.sm,clocks.max.sm"),
         disk_free_bytes=shutil.disk_usage(ROOT).free, proc_io_write_bytes=proc_write_bytes())
    disk = DiskWrites()

    navlint = start_navlint()
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    ptxas = {name: ptxas_entries(_build.ptxas_report(name)) for name in _build.SOURCES}
    k3_wgmma = {entry: v for entry, v in ptxas["flash_attention"].items()
                if "flash_fwd_kernel_wgmma" in entry}  # (D, Dv) (64, 64), (128, 128), (192, 128)
    k3_spills = sum(v["spill_stores"] + v["spill_loads"] for v in k3_wgmma.values())
    k2_entry = {entry: v for entry, v in ptxas["colocate"].items() if "colocate_kernel" in entry}
    k2_spills = sum(v["spill_stores"] + v["spill_loads"] for v in k2_entry.values())
    # the backward's tensor-core dK/dV and dQ kernels at the three (D, Dv),
    # and no mma.sync kernel left beside them
    k3_bwd_wgmma = {entry: v for entry, v in ptxas["flash_attention_bwd"].items()
                    if "_wgmma" in entry}
    k3_bwd_spills = sum(v["spill_stores"] + v["spill_loads"] for v in k3_bwd_wgmma.values())
    assert not any("_mma" in entry for entry in ptxas["flash_attention_bwd"]), ptxas
    # and ptxas serializes none of their wgmmas (its C7515/C7518 notes)
    k3_bwd_serialized = [w for w in ptxas["flash_attention_bwd"]["warnings"]
                         if "Performance Loss" in w]
    emit("build", seconds=build_s, sources=list(_build.SOURCES), ptxas=ptxas,
         k2_spill_bytes=k2_spills, k3_wgmma_spill_bytes=k3_spills,
         k3_bwd_wgmma_spill_bytes=k3_bwd_spills,
         k3_bwd_wgmma_registers={entry: v["registers"] for entry, v in k3_bwd_wgmma.items()},
         k3_bwd_serialized=k3_bwd_serialized,
         disk=disk.mark("build", dir_bytes(ROOT / "build" / "kernels")))
    emit("navlint", **run_navlint(navlint), disk=disk.mark("navlint", 0))

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
        # K3 with lse at each trained model's heads, reported in its train
        # line; run here, where the profiler records the kernel's own time
        # (after the later phases its sessions have recorded no device event)
        k3_train = check_k3_training(dev)
        k3_train_moe = check_k3_training(dev, MOE_ARCH, gradients=False)
        k3_train_hybrid = check_k3_training(dev, HYBRID_ARCH, gradients=False,
                                            seq=HYBRID_TRAIN_SEQ, batches=(1, HYBRID_TRAIN_BATCH))
        # and at the new phases' shapes: deepseek's MLA prefill, whisper's
        # encoder, cross and decoder attention (its training forward's),
        # and whisper's per-device train_4k decoder and cross attention
        k3_lse_new = {"mla": k3_lse_case(dev, 1, 128, 128, 2048, 2048, 192, 128, True, 0, 1),
                      "mla_train_4k": k3_lse_case(dev, 16, 8, 8, 4096, 4096, 192, 128, True,
                                                  0, 7),
                      "whisper_encoder": k3_lse_case(dev, 4, 6, 6, 1500, 1500, 64, 64, False, 0, 4),
                      "whisper_cross": k3_lse_case(dev, 4, 6, 6, 2048, 1500, 64, 64, False, 0, 5),
                      "whisper_decoder": k3_lse_case(dev, 4, 6, 6, 2048, 2048, 64, 64, True, 0, 6),
                      "whisper_decoder_4k": k3_lse_case(dev, 16, 6, 6, 4096, 4096, 64, 64, True,
                                                        0, 8),
                      "whisper_cross_4k": k3_lse_case(dev, 16, 6, 6, 4096, 1500, 64, 64, False,
                                                      0, 9)}

        # the vision prefix: internvl2-76b at full width in process (its
        # train step needs the card nearly empty, so it runs first), K3's
        # counts from 0 just before, read just after; nothing published
        vision = run_vision(dev)
        by_path = {"vision": {"flash_attention": vision["launches"]["flash_attention"],
                              "flash_attention_bwd": vision["train_step"]["k3_backward_launches"]}}
        emit("vision", **vision, k3=k3["at_internvl2"], disk=disk.mark("vision", 0))
        del vision

        # the dry run and its cells' per-device steps on a 1x1 mesh, the
        # card nearly empty (the decode cell's cache is 30 GB), then
        # command-r's, the MoE families' and the hybrid, mLSTM and
        # encoder-decoder families' tensor-parallel steps under a fake
        # 16x16 group; K3's counts from 0 just before each step, read just
        # after
        dry = run_dryrun(work / "dryrun", dev)
        by_path["dryrun"] = {"flash_attention": dry["launches"]["flash_attention"],
                             "flash_attention_bwd": dry["launches"]["flash_attention_bwd"]}
        emit("dryrun", **dry, k3=k3["at_prefill_32k"], k3_tensor_parallel=k3["at_command_r_32k"],
             k3_moe={"deepseek_prefill_32k": k3["at_mla_32k"],
                     "deepseek_train_4k": k3["at_mla_train_4k"],
                     "deepseek_train_4k_lse": k3_lse_new["mla_train_4k"],
                     "granite_prefill_32k": k3["at_granite_32k"]},
             k3_mixers={"hymba_prefill_32k": k3["at_hymba_32k"],
                        "whisper_train_4k_decoder": k3["at_whisper_decoder_4k"],
                        "whisper_train_4k_decoder_lse": k3_lse_new["whisper_decoder_4k"],
                        "whisper_train_4k_cross": k3["at_whisper_cross_4k"],
                        "whisper_train_4k_cross_lse": k3_lse_new["whisper_cross_4k"]},
             k3_head_slices=k3["head_slices"], nvidia_smi=smi,
             disk=disk.mark("dryrun", dir_bytes(work / "dryrun")))
        del dry

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
        by_path.update({"itinerary+publish": dict(launches),
                        "fabric": {k: sum(fab[run]["launches"][k]
                                          for run in ("calm", "calm_warm", "interrupted",
                                                      "delta"))
                                   for k in ("delta_encode", "colocate")}})
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
        metrics, serve_launches, windows, _ = serve_counted(dev, SERVE_ARCH)
        launches["flash_attention"] = (by_path["vision"]["flash_attention"]
                                       + by_path["dryrun"]["flash_attention"]
                                       + serve_launches["flash_attention"])
        by_path["serve"] = {"flash_attention": serve_launches["flash_attention"]}
        served = check_serve(metrics, dev)
        cfg = served["engine"].cfg
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                cfg.d_ff, cfg.vocab, cfg.dtype, cfg.tie_embeddings) == \
            (28, 2048, 16, 8, 128, 6144, 151936, "bfloat16", True), cfg
        n_layers = cfg.n_layers
        assert serve_launches == {"delta_encode": 0, "colocate": 0,
                                  "flash_attention": BATCH * n_layers,
                                  "flash_attention_wgmma": BATCH * n_layers}, serve_launches
        assert windows == {0: BATCH * n_layers}, windows
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
        # the chaos cells run beside the serve CLI's routed mode: both are
        # worker processes that wait on their starts most of the time
        chaos = start_chaos(dev)
        try:
            fleet["cli_workers_2"] = run_serve_cli(metrics)
        except BaseException:
            stop_chaos(chaos)
            raise
        emit("serve_fleet", **fleet, disk=disk.mark("serve_fleet", dir_bytes(work / "fleet")))
        del fleet
        emit("chaos", **finish_chaos(chaos), disk=disk.mark("chaos", 0))

        # the training path: each launcher process counts its own K3
        # launches from 0 and reports them at its end
        train = run_train(work / "train")
        for run in ("A", "B"):
            launches["flash_attention"] += train["launches"][run]["flash_attention"]
        by_path["train"] = {k: sum(train["launches"][run][k] for run in ("A", "B"))
                            for k in ("flash_attention", "flash_attention_bwd")}
        from repro_torch.configs import get_config

        emit("train", **train, k3=k3_train,
             disk=disk.mark("train", train_files(work / "train", train)))
        shutil.rmtree(work / "train", ignore_errors=True)  # room for train_moe's states
        del train

        # the MoE training path: granite through the launcher, each
        # process counting its own K3 launches from 0
        train = run_train(work / "train_moe", MOE_ARCH, MOE_TRAIN_WRITE_BUDGET)
        by_path["train_moe"] = {k: sum(train["launches"][run][k] for run in ("A", "B"))
                                for k in ("flash_attention", "flash_attention_bwd")}
        launches["flash_attention"] += by_path["train_moe"]["flash_attention"]
        emit("train_moe", **train, k3=k3_train_moe,
             disk=disk.mark("train_moe", train_files(work / "train_moe", train)))
        shutil.rmtree(work / "train_moe", ignore_errors=True)  # room for train_hybrid's
        del train

        # the hybrid serve path: hymba-1.5b, counts from 0 just before, read
        # just after
        hybrid = run_serve_hybrid(work / "serve_hybrid", dev)
        launches["flash_attention"] += hybrid["launches"]["flash_attention"]
        by_path["serve_hybrid"] = {"flash_attention": hybrid["launches"]["flash_attention"]}
        emit("serve_hybrid", **hybrid,
             disk=disk.mark("serve_hybrid", dir_bytes(work / "serve_hybrid")))
        del hybrid

        # the hybrid training path: each launcher process counting its own
        # K3 launches from 0
        train = run_train(work / "train_hybrid", HYBRID_ARCH, HYBRID_TRAIN_WRITE_BUDGET,
                          HYBRID_TRAIN_SEQ, HYBRID_TRAIN_BATCH)
        by_path["train_hybrid"] = {k: sum(train["launches"][run][k] for run in ("A", "B"))
                                   for k in ("flash_attention", "flash_attention_bwd")}
        launches["flash_attention"] += by_path["train_hybrid"]["flash_attention"]
        emit("train_hybrid", **train, k3=k3_train_hybrid,
             disk=disk.mark("train_hybrid", train_files(work / "train_hybrid", train)))
        shutil.rmtree(work / "train_hybrid", ignore_errors=True)
        del train

        # the mLSTM: xlstm-1.3b served (counts from 0 just before, read just
        # after: it launches none)
        emit("xlstm", **run_xlstm(work / "xlstm", dev),
             disk=disk.mark("xlstm", dir_bytes(work / "xlstm")))

        # MLA: deepseek-v3 at full width, depth cut to 4 layers, served
        # (counts from 0 just before, read just after)
        mla = run_serve_mla(work / "serve_mla", dev)
        launches["flash_attention"] += mla["launches"]["flash_attention"]
        by_path["serve_mla"] = {"flash_attention": mla["launches"]["flash_attention"]}
        emit("serve_mla", **mla, k3=k3_lse_new["mla"],
             disk=disk.mark("serve_mla", dir_bytes(work / "serve_mla")))
        shutil.rmtree(work / "serve_mla", ignore_errors=True)
        del mla

        # the encoder-decoder: whisper-tiny through the launcher, each
        # process counting its own K3 launches from 0
        train = run_train(work / "train_encdec", ENCDEC_ARCH, ENCDEC_TRAIN_WRITE_BUDGET)
        by_path["train_encdec"] = {k: sum(train["launches"][run][k] for run in ("A", "B"))
                                   for k in ("flash_attention", "flash_attention_bwd")}
        launches["flash_attention"] += by_path["train_encdec"]["flash_attention"]
        assert train["depth_cut"] is None, train["depth_cut"]  # full width and depth
        torch.cuda.reset_peak_memory_stats(dev)
        train["in_process_step"] = profile_train(dev, get_config(ENCDEC_ARCH).n_layers,
                                                 ENCDEC_ARCH)
        by_path["train_encdec"]["flash_attention_bwd"] += \
            train["in_process_step"]["k3_backward_launches"]
        emit("train_encdec", **train,
             k3={key: k3_lse_new[key] for key in ("whisper_encoder", "whisper_cross",
                                                  "whisper_decoder")},
             disk=disk.mark("train_encdec", train_files(work / "train_encdec", train)))
        from repro_torch.checkpoint import load_manifest
        from repro_torch.core import JobStore

        job_id, cmi = train["final_cmis"]["A"]
        no_mesh = {"losses": train["losses"], "digests": _digests(load_manifest(
            JobStore(work / "train_encdec" / "jobs").cmi_root(job_id), cmi))}
        shutil.rmtree(work / "train_encdec", ignore_errors=True)
        del train

        # the mesh: whisper-tiny through the launcher on a 1x1 cuda mesh,
        # each process counting its own K3 launches from 0
        mesh = run_mesh(work / "mesh", dev, no_mesh)
        by_path["mesh"] = {k: mesh["launches"][k]
                           for k in ("flash_attention", "flash_attention_bwd")}
        launches["flash_attention"] += by_path["mesh"]["flash_attention"]
        emit("mesh", **mesh, disk=disk.mark("mesh", dir_bytes(work / "mesh")))
        shutil.rmtree(work / "mesh", ignore_errors=True)
        del mesh

        emit("examples", quickstart=run_quickstart(), disk=disk.mark("examples", 0))

        total = disk.total()
        emit("disk", phases=disk.phases, total_written_bytes=total, limit_bytes=DISK_WRITE_LIMIT)
        assert total < DISK_WRITE_LIMIT, (total, disk.phases)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    assert len(k2_entry) == 1 and k2_spills == 0, k2_entry  # K2 spills nothing
    assert len(k3_wgmma) == 3 and k3_spills == 0, k3_wgmma  # the tensor-core K3 spills nothing
    assert len(k3_bwd_wgmma) == 6 and k3_bwd_spills == 0, k3_bwd_wgmma  # nor does its backward
    assert not k3_bwd_serialized, k3_bwd_serialized
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
                     **({"at_d64": k["at_d64"], "at_hymba": k["at_hymba"], "at_mla": k["at_mla"],
                         "at_whisper_encoder": k["at_whisper_encoder"],
                         "at_whisper_cross": k["at_whisper_cross"],
                         "at_whisper_decoder": k["at_whisper_decoder"],
                         "at_internvl2": k["at_internvl2"],
                         "at_prefill_32k": k["at_prefill_32k"],
                         "at_command_r_32k": k["at_command_r_32k"],
                         "at_mla_32k": k["at_mla_32k"],
                         "at_granite_32k": k["at_granite_32k"],
                         "at_mla_train_4k": k["at_mla_train_4k"],
                         "at_hymba_32k": k["at_hymba_32k"],
                         "at_whisper_decoder_4k": k["at_whisper_decoder_4k"],
                         "at_whisper_cross_4k": k["at_whisper_cross_4k"],
                         "head_slices": k["head_slices"], "training": k3_train,
                         "training_d64": k3_train_moe, "training_hymba": k3_train_hybrid,
                         "lse_new_shapes": k3_lse_new}
                        if name == "flash_attention" else {})})
    # K3's backward: its own kernels, timed at each K3 shape with lse; the
    # row's numbers at qwen3's training shape (B 4)
    bwd_cases = {"qwen3_b1": k3_train["serve_shape"], "qwen3_b4": k3_train["train_shape"],
                 "d64_b1": k3_train_moe["serve_shape"], "d64_b4": k3_train_moe["train_shape"],
                 "hymba_b1": k3_train_hybrid["serve_shape"],
                 "hymba_b2": k3_train_hybrid["train_shape"], **k3_lse_new}
    at = bwd_cases["qwen3_b4"]
    bwd_keys = ("shape", "attention_backward_kernel", "attention_backward_ms",
                "attention_backward_kernel_only_ms", "attention_backward_max_abs_err",
                "attention_backward_rounding_limit_use", "attention_backward_planted_fault",
                "attention_backward_plain_ms", "library_sdpa_backward_ms", "backward_bound_ms",
                "backward_floor_ms", "backward_floor_share", "visible_pairs")
    rows.append({"name": "flash_attention_bwd", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                 "replaces": "src/repro/kernels/flash_attention/flash_attention.py:120",
                 "replaces_note": "the gradient of that kernel: the JAX package has no Pallas "
                                  "backward and differentiates blockwise_attention "
                                  "(src/repro/models/attention.py) with jax.grad",
                 "launches": sum(n.get("flash_attention_bwd", 0) for n in by_path.values()),
                 "launches_by_path": {path: n["flash_attention_bwd"]
                                      for path, n in by_path.items() if "flash_attention_bwd" in n},
                 "max_abs_err": max(c["attention_backward_max_abs_err"]
                                    for c in bwd_cases.values()),
                 "ms": at["attention_backward_ms"], "plain_ms": at["attention_backward_plain_ms"],
                 "bound_ms": at["backward_bound_ms"], "bound_by": at["backward_bound_by"],
                 "library_ms": at["library_sdpa_backward_ms"],
                 "kernel_only_ms": at["attention_backward_kernel_only_ms"],
                 "floor_hi_lo_ms": at["backward_floor_ms"],
                 "floor_share": at["backward_floor_share"], "shape": at["shape"],
                 "parity": f"dq, dk, dv within {BWD_BF16_TOL} (atol and rtol) of the plain "
                           "backward on the same bf16 inputs, and within 2**-8 |x| + 2**-10 "
                           "rms of its float32 answer (a skipped far key tile fails that); two "
                           "calls bitwise equal",
                 "rounding_limit_use": max(c["attention_backward_rounding_limit_use"]
                                           for c in bwd_cases.values()),
                 "at": {key: {f: c[f] for f in bwd_keys} for key, c in bwd_cases.items()}})
    assert rows[-1]["launches"] > 0 and all(n > 0 for n in rows[-1]["launches_by_path"].values()
                                            if n is not None), rows[-1]["launches_by_path"]
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
