#!/usr/bin/env python3
"""Drive repro_torch's main path on one CUDA card and check every result.

Run from the root of a checkout: ``python3 chip_smoke.py`` (no arguments,
one card). It builds the CUDA kernels from ``src/repro_torch/kernels/csrc``
with nvcc and prints one JSON line per phase:

  env        torch / CUDA versions, the card, nvidia-smi's name and power limit
  build      nvcc wall time and each kernel's registers and shared memory
  kernels    each kernel against its plain PyTorch version on the card, at the
             main path's shapes (bitwise), with its time, the plain version's,
             one PyTorch library call's and the card's lower bound
  itinerary  the Fig. 8 tour at full granule size on two CUDA nodes, every hop
             through a transit CMI, preempted after the match publish and
             resumed; the product equals an uninterrupted run's
  publish    the Fig. 7 form: a publish after each stage with device change
             hints (K1), its wall time and bytes written

then the summary line ``{"kernels": [...]}`` with the launches each kernel
made on the main path (the itinerary and publish phases), the nvidia-smi
line, and last ``{"ok": true, "device": {...}}``. Any failure raises and the
script exits non-zero before the last line; so does a machine without a CUDA
card, or a directory without the rest of the repository.
"""

from __future__ import annotations

import functools
import json
import math
import shutil
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


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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
    flops = 2 * 3 * N_PIXELS * M_FOVS
    timing = {
        "ms": cuda_ms(lambda: colocate_match(u, los), 5),
        "kernel_only_ms": profiled_ms(lambda: colocate_match(u, los), "colocate_kernel", 3),
        "plain_ms": plain_ms,
        "library_ms": cuda_ms(library, 3),
        "bound_ms": flops / FP32_FLOPS * 1e3,
        "bound_by": "operations",
        "shape": f"u f32[{N_PIXELS},3] x los f32[{M_FOVS},3]",
        "flops": flops,
        "library_idx_agreement": float((la.to(torch.int32) == ki).float().mean()),
        "library_tf32": torch.backends.cuda.matmul.allow_tf32,
    }
    return {"name": "colocate", "cases": cases, "max_abs_err": max_err, **timing}


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
         count=torch.cuda.device_count(), nvidia_smi=smi, python=sys.version.split()[0])

    t0 = time.perf_counter()
    reports = _build.build()
    build_s = time.perf_counter() - t0
    regs = {name: [ln.strip() for ln in log.splitlines() if "registers" in ln]
            for name, log in reports.items()}
    emit("build", seconds=build_s, sources=list(_build.SOURCES), ptxas=regs)

    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    try:
        from repro_torch.core import colocation as co

        geo = co.stage_geometry(co.stage_read({}, device=dev, seed=0, **GRANULES))
        k1 = check_delta_encode(dev)
        k2 = check_colocate(dev, geo)
        del geo
        emit("kernels", delta_encode=k1, colocate=k2)

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
             launches={k: launches[k] - launches_itin[k] for k in launches})
        assert launches["delta_encode"] > launches_itin["delta_encode"] >= 0
        assert launches["colocate"] > 0
    finally:
        shutil.rmtree(work, ignore_errors=True)

    rows = []
    for k, name, replaces in ((k1, "delta_encode", "src/repro/kernels/delta_encode/delta_encode.py:48"),
                              (k2, "colocate", "src/repro/kernels/colocate/colocate.py:66")):
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{name}.cu", "replaces": replaces,
                     "launches": launches[name], "max_abs_err": k["max_abs_err"],
                     "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": k["library_ms"],
                     "kernel_ms": k["ms"], "kernel_only_ms": k["kernel_only_ms"],
                     "shape": k["shape"],
                     "parity": "bitmaps equal" if name == "delta_encode"
                     else "idx equal, cos bitwise equal"})
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
