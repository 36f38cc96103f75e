"""Multi-pod dry run: trace every (arch × shape × mesh) cell on a fake group.

Port of the JAX package's ``repro/launch/dryrun.py``, which lowers and
compiles each cell for 256 or 512 host devices and reads XLA's cost and
memory analysis. Here one process joins a ``"fake"`` process group
(``FakeStore``, rank 0 of 256 or 512: every collective returns at once)
and makes the production mesh over it (``launch/mesh.py``); under
``FakeTensorMode`` (nothing computed or allocated) it builds the cell's
DTensor state from specs placed by the step's shardings, the batch from
``input_specs``, and runs one step of ``make_train_step``,
``make_prefill_step`` or ``make_decode_step`` under
:class:`~repro_torch.launch.hlo_stats.StepCounter`, which counts rank
0's FLOPs, bytes, collectives and live memory.

Each cell writes ``<out>/<arch>__<shape>__pod1|pod2[__variant].json``
with the reference's keys (``arch``, ``shape``, ``mesh``, ``chips``,
``params``, ``active_params``, ``ok``/``error``/``traceback`` or
``skipped``, ``total_s``, ``cost`` with ``flops`` and ``bytes
accessed``, ``hlo``, ``collectives``, ``memory``), ``trace_s`` in place
of ``lower_s``/``compile_s``, ``path``: how the steps compute
(``distributed/steps.py``), ``moe_buf_shard`` and ``experts`` (the mesh
axes the MoE experts lie over). Every number is per device. A rank
computes on its shards (the ``tp`` path, every family's), as the
reference's GSPMD program does: its heads, hidden units and vocab rows
where they split the model axis, the whole where they do not (hymba's 25
heads and xlstm's 4 on 16), its experts on their (data, model) block,
their tokens moved by all-to-alls.

``--seq-shard`` (the sequence-parallel residual stream of the train
step; ``__seqshard`` in a train cell's file name) and ``--moe-buf-shard``
(the train step's expert-placed dispatch buffer; ``__moebuf``) are taken
for every arch; each changes nothing where the reference's does not (the
second for a model without MoE layers, the first for the
encoder–decoder, whose reference constrains no residual stream).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu --arch qwen3-1.7b \\
        --shape prefill_32k [--multi-pod | --both-meshes] [--out DIR]

``--device cuda`` (the default) makes the fake tensors and the mesh cuda,
which needs a CUDA build of PyTorch (no card is used). A failed cell is
recorded and counted, and the run exits non-zero at its end.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import ArchConfig, InputShape


def should_skip(cfg: ArchConfig, shape: InputShape) -> str | None:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return (
            "long_500k needs sub-quadratic attention; this arch is pure "
            "full-attention (see DESIGN.md §4)"
        )
    return None


def join_fake_group(world: int) -> None:
    """This process as rank 0 of a ``"fake"`` group of ``world`` ranks (the
    one it is in first left)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _fake_dtensors(specs, shardings, device):
    """A DTensor a leaf of ``specs`` (TensorSpecs), placed by the parallel
    ``shardings``, each local block a fake tensor (call under
    ``FakeTensorMode``)."""
    import torch

    from repro_torch.distributed.sharding import from_local
    from repro_torch.utils import flatten_with_paths

    flat, treedef = flatten_with_paths(specs)
    sh, _ = flatten_with_paths(shardings)
    out = {}
    for path, spec in flat.items():
        index = sh[path].shard_index(spec.shape, sh[path].mesh.get_coordinate())
        local = torch.empty([b - a for a, b in index], dtype=spec.dtype, device=device)
        out[path] = from_local(local, spec.shape, sh[path])
    return treedef.unflatten(out)


def build_lowered(cfg: ArchConfig, shape: InputShape, mesh, device: str, *,
                  seq_shard: bool = False, moe_buf_shard: bool = False) -> tuple:
    """``(step, args)``: the cell's step and its arguments, DTensors of fake
    blocks placed by the step's shardings (call under ``FakeTensorMode``).
    The reference's function of this name lowers the jitted step; here the
    trace is the run (:func:`trace_cell`). ``seq_shard`` and
    ``moe_buf_shard`` go to the train step."""
    import torch

    from repro_torch.distributed.steps import (batch_shardings, make_decode_step,
                                               make_prefill_step, make_train_step,
                                               model_axes_for, state_struct_for,
                                               train_state_shardings)
    from repro_torch.models.model import input_specs
    from repro_torch.optim.adamw import AdamWConfig

    specs = input_specs(cfg, shape)
    if shape.kind == "train":
        opt_cfg = AdamWConfig(moment_dtype=cfg.opt_moment_dtype)
        step = make_train_step(cfg, opt_cfg, mesh=mesh, seq_shard=seq_shard,
                               moe_buf_shard=moe_buf_shard)
        state = _fake_dtensors(state_struct_for(cfg, opt_cfg),
                               train_state_shardings(cfg, opt_cfg, mesh), device)
        # the train step takes the global batch whole on every rank
        batch = {k: torch.empty(s.shape, dtype=s.dtype, device=device) for k, s in specs.items()}
        return step, (state, batch)
    if shape.kind == "prefill":
        step, p_sh, _ = make_prefill_step(cfg, mesh, shape)
        params = _fake_dtensors(model_axes_for(cfg)[1], p_sh, device)
        return step, (params, _fake_dtensors(specs, batch_shardings(specs, mesh), device))
    if shape.kind == "decode":
        step, p_sh, c_sh = make_decode_step(cfg, mesh, shape)
        params = _fake_dtensors(model_axes_for(cfg)[1], p_sh, device)
        caches = _fake_dtensors(specs["caches"], c_sh, device)
        tok = {"tokens": specs["tokens"]}
        tokens = _fake_dtensors(tok, batch_shardings(tok, mesh), device)["tokens"]
        return step, (params, caches, tokens, shape.seq_len - 1)
    raise ValueError(shape.kind)


def trace_cell(cfg: ArchConfig, shape: InputShape, mesh, device: str, *,
               seq_shard: bool = False, moe_buf_shard: bool = False) -> dict:
    """One step of the cell on ``mesh`` under ``FakeTensorMode``, counted:
    ``{"hlo": StepCounter.result(), "memory": ..., "trace_s": ...,
    "flops_by_op": ..., "path": ..., "experts": ...}``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.hlo_stats import StepCounter

    counter = StepCounter()
    with FakeTensorMode():
        step, args = build_lowered(cfg, shape, mesh, device, seq_shard=seq_shard,
                                   moe_buf_shard=moe_buf_shard)
        counter.hold(args)
        t0 = time.perf_counter()
        with counter:
            out = step(*args)
        trace_s = time.perf_counter() - t0
        memory = counter.memory(out)
    return {"hlo": counter.result(), "memory": memory, "trace_s": trace_s,
            "flops_by_op": counter.by_op, "path": step.path, "experts": step.experts}


PRODUCTION = {False: "16x16", True: "2x16x16"}  # multi_pod -> the mesh


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path, force: bool = False,
             *, variant: str = "", cfg_overrides: dict | None = None, device: str = "cuda",
             mesh_spec: str = "", smoke: bool = False, seq_len: int = 0,
             seq_shard: bool = False, moe_buf_shard: bool = False, layers: int = 0) -> dict:
    """Trace one cell and write its JSON (or read it back, without
    ``force``). For small cells (tests): ``mesh_spec`` ("4x4", "2x2x2")
    replaces the production mesh, ``smoke`` takes the arch's smoke config,
    ``seq_len`` replaces the shape's, ``layers`` cuts the depth (widths
    kept; ``__l<N>`` in the name). ``seq_shard`` and ``moe_buf_shard``
    apply to train cells (``__seqshard``, ``__moebuf`` in their name)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.train import mesh_for, parse_mesh

    spec = mesh_spec or PRODUCTION[multi_pod]
    tag = f"{arch}__{shape_name}__" + (f"mesh{spec}" if mesh_spec else
                                       ("pod2" if multi_pod else "pod1"))
    seq_shard = seq_shard and SHAPES[shape_name].kind == "train"
    moe_buf_shard = moe_buf_shard and SHAPES[shape_name].kind == "train"
    for suffix in ("smoke" if smoke else "", f"s{seq_len}" if seq_len else "",
                   f"l{layers}" if layers else "", "seqshard" if seq_shard else "",
                   "moebuf" if moe_buf_shard else "", variant):
        if suffix:
            tag += f"__{suffix}"
    out_file = out_dir / f"{tag}.json"
    if out_file.exists() and not force:
        return json.loads(out_file.read_text())
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if cfg_overrides:
        cfg = cfg.with_(**cfg_overrides)
    if layers:
        cfg = cfg.with_(n_layers=layers)
    shape = SHAPES[shape_name]
    if seq_len:
        shape = dataclasses.replace(shape, seq_len=seq_len)
    dims = parse_mesh(spec)[0]
    rec: dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": spec,
        "chips": math.prod(dims),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "device": device,
        "seq_shard": seq_shard,
        "moe_buf_shard": moe_buf_shard,
        "layers": layers,
    }
    skip = should_skip(cfg, shape)
    if skip:
        rec["skipped"] = skip
        out_dir.mkdir(parents=True, exist_ok=True)
        out_file.write_text(json.dumps(rec, indent=1))
        return rec
    t0 = time.time()
    try:
        join_fake_group(rec["chips"])
        mesh = (mesh_for(spec, device) if mesh_spec
                else make_production_mesh(multi_pod=multi_pod, device_type=device))
        traced = trace_cell(cfg, shape, mesh, device, seq_shard=seq_shard,
                            moe_buf_shard=moe_buf_shard)
        rec["path"] = traced["path"]
        rec["experts"] = traced["experts"]
        rec["trace_s"] = round(traced["trace_s"], 2)
        rec["memory"] = traced["memory"]
        rec["cost"] = {"flops": traced["hlo"]["flops"], "bytes accessed": traced["hlo"]["bytes"]}
        rec["hlo"] = traced["hlo"]
        rec["collectives"] = rec["hlo"]["collectives"]
        rec["flops_by_op"] = traced["flops_by_op"]
        rec["ok"] = True
        print({k: v for k, v in rec["cost"].items()}, rec["memory"])
    except Exception as e:  # a failed cell is recorded, counted, and the run goes on
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 2)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_file.write_text(json.dumps(rec, indent=1))
    status = "OK" if rec.get("ok") else ("SKIP" if "skipped" in rec else "FAIL")
    print(f"[dryrun] {tag}: {status} ({rec.get('total_s', 0)}s)", flush=True)
    return rec


def trace_in_group(arch: str, shape_name: str, multi_pod: bool, device: str) -> dict:
    """One cell's counts, nothing written (``launch/hlo_stats.py``'s CLI)."""
    from repro_torch.launch.mesh import make_production_mesh

    join_fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
    traced = trace_cell(get_config(arch), SHAPES[shape_name], mesh, device)
    return {**traced["hlo"], "memory": traced["memory"], "trace_s": traced["trace_s"],
            "path": traced["path"], "experts": traced["experts"]}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, choices=[*SHAPES, None], help="shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true", help="2x16x16 (512 devices) mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="", help="suffix for perf-iteration cells")
    ap.add_argument("--seq-shard", action="store_true", help="sequence-parallel residual stream")
    ap.add_argument("--moe-buf-shard", action="store_true", help="expert-local grouped GEMM")
    ap.add_argument("--remat", default=None, choices=["nothing", "dots", "full", None])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' and the mesh's device type (default cuda)")
    ap.add_argument("--mesh", default="", help="a mesh in place of the production one (4x4)")
    ap.add_argument("--smoke", action="store_true", help="the archs' smoke configs")
    ap.add_argument("--seq-len", type=int, default=0, help="in place of each shape's")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut each config's depth to this many layers (0: keep it); widths stay")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cfg_overrides = {"remat": args.remat} if args.remat else None
    n_fail = 0
    for mp in meshes:  # one fake group a mesh size
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mp, out_dir, force=args.force, variant=args.variant,
                               cfg_overrides=cfg_overrides, device=args.device,
                               mesh_spec=args.mesh, smoke=args.smoke, seq_len=args.seq_len,
                               seq_shard=args.seq_shard, moe_buf_shard=args.moe_buf_shard,
                               layers=args.layers)
                if not rec.get("ok") and "skipped" not in rec:
                    n_fail += 1
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")
    return 0


if __name__ == "__main__":
    main()
