"""Preemptible training driver — the paper's Figure 7 loop, end to end.

Port of the JAX package's ``repro/launch/train.py`` on one device:

    (1) request svc/get_job to get job_id/status
    (2) if status == "new":   main(job_id)          # fresh start
    (4) elif status == "ckpt": DHP.restart(job_id)   # resume from CMI
    ...
    (9/12) DHP.publish(job_id, "ckpt")    at application-chosen boundaries
    (15)   DHP.publish(job_id, "finished")

plus the spot-market supervision loop: on a (simulated or SIGTERM) notice
the worker finishes its step, publishes, and exits; the supervisor
provisions the next incarnation, which resumes from the CMI. A resumed run
ends bitwise equal to an uninterrupted one: the data cursor, the step and
the optimizer state are all in the CMI, and the step is deterministic
(``deterministic()``). The CMI has the reference's paths and dtypes, so a
job published by one package resumes in the other.

The model runs on the CUDA card unless ``--device cpu`` is given. Without
``--mesh`` it runs in this process on one device. With ``--mesh DxM`` (or
``PxDxM``) the state is DTensors on a ``("data", "model")`` mesh
(``distributed/steps.py``), one process per rank in every incarnation,
each incarnation in a fresh process group: a reclaim ends the group, and
``--remesh 2x2,2x1`` gives each incarnation its mesh (the spot market's
elastic restart onto a smaller instance: the CMI's specs are remapped onto
the new mesh, then re-pinned to its placements). Rank 0 owns the job
store and the publishes; every rank reads its own shards of a CMI. A
one-rank mesh runs in this process. ``--device cuda`` gives each rank a
card (NCCL) and raises when there are fewer cards than ranks; ``--device
cpu`` runs gloo ranks on the host. An incarnation lasts as long as its
ranks keep stepping: one that goes ``--rank-timeout`` seconds without a
step or a publish is ended as hung. SIGTERM to the launcher (or to its
whole process group: the ranks ignore it) is the reclaim notice: rank 0
publishes after the step it is on, and the next incarnation resumes.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --smoke \\
        --device cpu --steps 30 --publish-every 10 --preempt-at 17 --store /tmp/navp-jobs
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --smoke \\
        --device cpu --steps 8 --publish-every 3 --preempt-at 5 --remesh 2x2,2x1

``--metrics FILE`` appends one JSON line per step, publish and
incarnation (losses, seconds, CMI names, model FLOPs a step, K3 launches,
peak device memory).
``main`` returns the final loss.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import multiprocessing
import os
import signal
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import DHP, NBS, JobStore
from repro_torch.core.delta import DeltaPolicy
from repro_torch.core.dhp import Preempted
from repro_torch.core.preemption import SpotSchedule, run_preemptible
from repro_torch.data import TokenPipeline
from repro_torch.distributed.steps import batch_to_device, make_init_fn, make_train_step
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import AdamWConfig
from repro_torch.utils import logger, resolve_device, warm_cpu_math

RANK_TIMEOUT_S = 1800.0  # default --rank-timeout


def parse_mesh(spec: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """``"4x2"`` -> ((4, 2), ("data", "model")); three dims add ``"pod"``."""
    dims = tuple(int(x) for x in spec.split("x"))
    names = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    return dims, names[: len(dims)]


def mesh_for(spec: str, device_type: str):
    """The mesh of ``spec`` over the default group's ranks."""
    return make_mesh(*parse_mesh(spec), device_type)


@contextlib.contextmanager
def deterministic():
    """Deterministic kernels for the body, the earlier settings restored
    after: ``torch.use_deterministic_algorithms(True)``, cuBLAS's fixed
    workspace (``CUBLAS_WORKSPACE_CONFIG``, set where unset; cuBLAS reads it
    when it starts, so a process enters this before its first CUDA call),
    and no TF32."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[1:]


def causal_pairs(seq_len: int, window: int = 0) -> int:
    """(q, k) pairs a causal mask keeps over ``seq_len`` positions, within
    a sliding ``window`` when one is set."""
    if not window or window >= seq_len:
        return seq_len * (seq_len + 1) // 2
    return window * (window + 1) // 2 + (seq_len - window) * window


def token_params(cfg) -> int:
    """Parameters one token multiplies: the configuration's analytic count
    (``active_param_count``: a MoE layer's top-k experts, not all of them;
    an MLA layer's five LoRA and projection matrices), which gives every
    other layer the GQA projections; an mLSTM block has none of those, and
    five (E, H·Dh) projections (q, k, v, the output gate, o) where that
    count takes four. The encoder-decoder: :func:`encdec_token_params`."""
    if cfg.encdec:
        raise ValueError("the encoder-decoder's tokens and frames differ: encdec_token_params")
    n = cfg.active_param_count()
    if cfg.mlstm:
        e, dh = cfg.d_model, cfg.resolved_head_dim
        gqa = 2 * e * cfg.n_heads * dh + 2 * e * cfg.n_kv_heads * dh
        n += cfg.n_layers * (e * cfg.n_heads * dh - gqa)
    return n


def encdec_token_params(cfg) -> tuple[int, int]:
    """(parameters an encoder frame multiplies, parameters a decoder token
    multiplies) of the encoder-decoder: a frame every encoder layer's q, k,
    v, o and MLP, and every decoder layer's cross-attention k and v (they
    project the encoder's output); a token every decoder layer's self q,
    k, v, o, cross q and o and MLP, and the (tied) unembedding. The
    learned position tables are added, not multiplied."""
    e, h, kv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                       cfg.d_ff)
    qo, kv_proj, mlp = 2 * e * h * dh, 2 * e * kv * dh, 2 * e * f
    frame = cfg.enc_layers * (qo + kv_proj + mlp) + cfg.n_layers * kv_proj
    token = cfg.n_layers * (qo + kv_proj + qo + mlp) + cfg.vocab * e
    return frame, token


def attention_pair_flops(cfg) -> int:
    """Forward FLOPs of softmax attention a visible (q, k) pair, all heads:
    QK^T over the qk head dim and PV over the v head dim (MLA: nope + rope
    192 and v 128; else both the head dim)."""
    if cfg.mla:
        return 2 * cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim + cfg.v_head_dim)
    return 4 * cfg.n_heads * cfg.resolved_head_dim


def recurrence_flops(cfg, batch: int, seq_len: int) -> int:
    """Forward FLOPs of one layer's chunked linear recurrence
    (``models.ssm.chunked_linear_recurrence``), 0 without one: per token
    and head, over chunks of Q (the sequence padded to whole chunks), the
    Q×Q tile's scores (2 Q N) and outputs (2 Q P), whole tiles as computed,
    and the N×P state terms, the carry's contribution and the inter-chunk
    output (2 N P each). SSD: N the state size, P the head dim; mLSTM: N
    the head dim, P the head dim plus the normaliser's column."""
    if not (cfg.ssm or cfg.mlstm):
        return 0
    dh = cfg.resolved_head_dim
    n, p = (cfg.ssm_state, dh) if cfg.ssm else (dh, dh + 1)
    q = min(cfg.chunk, seq_len)
    tokens = batch * -(-seq_len // q) * q
    return 2 * tokens * cfg.n_heads * (q * (n + p) + 2 * n * p)


def step_flops(cfg, batch: int, seq_len: int) -> int:
    """Model FLOPs of one training step: 6 N T, N the parameters a token
    multiplies (:func:`token_params`), plus, in every layer, three times
    (forward, and backward twice) each mixer's own products: softmax
    attention's :func:`attention_pair_flops` a visible (q, k) pair times B
    where the mixer has attention (all but the mLSTM; within the sliding
    window when one is set), and the chunked recurrence's
    (:func:`recurrence_flops`) where it has one (hybrid's SSD, the mLSTM).
    A vision prefix's P patch embeddings count as tokens.
    The encoder-decoder counts its B x enc_seq frames and B x S tokens
    (:func:`encdec_token_params`) and three attentions: the encoder's over
    enc_seq^2 pairs, the decoder's causal one and the cross-attention's S x
    enc_seq pairs."""
    if cfg.encdec:
        frame, token = encdec_token_params(cfg)
        pairs = (cfg.enc_layers * cfg.enc_seq ** 2
                 + cfg.n_layers * (causal_pairs(seq_len) + seq_len * cfg.enc_seq))
        return (6 * batch * (frame * cfg.enc_seq + token * seq_len)
                + 3 * batch * attention_pair_flops(cfg) * pairs)
    seq_len += cfg.vision_prefix  # the patch embeddings run through every layer too
    per_layer = 3 * recurrence_flops(cfg, batch, seq_len)
    if not cfg.mlstm:
        pairs = causal_pairs(seq_len, cfg.window)
        per_layer += 3 * batch * attention_pair_flops(cfg) * pairs
    return 6 * token_params(cfg) * batch * seq_len + per_layer * cfg.n_layers


class _Metrics:
    """One JSON line per record, appended to ``path`` (nothing without one)."""

    def __init__(self, path: str | None):
        self.path = path

    def __call__(self, event: str, **fields) -> None:
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps({"event": event, **fields}) + "\n")


def state_digest(tree) -> str:
    """One content hash of every array leaf's whole bytes, path by path (a
    ``HostShards`` snapshot's shards placed back at their slices)."""
    import hashlib

    import numpy as np

    from repro_torch.checkpoint.format import storage_dtype, tensor_to_storage
    from repro_torch.checkpoint.serializer import HostShards
    from repro_torch.utils import flatten_with_paths

    h = hashlib.blake2b(digest_size=16)
    for path, leaf in sorted(flatten_with_paths(tree)[0].items()):
        if isinstance(leaf, HostShards):
            full = np.empty(leaf.shape, storage_dtype(leaf.dtype))
            for index, block in leaf.shards:
                full[tuple(slice(a, b) for a, b in index)] = block
        elif isinstance(leaf, torch.Tensor):
            full = tensor_to_storage(leaf)
        else:
            continue
        h.update(path.encode())
        h.update(np.ascontiguousarray(full).tobytes())
    return h.hexdigest()


K3_COUNTS = ("flash_attention", "flash_attention_wgmma", "flash_attention_lse",
             "flash_attention_bwd", "flash_attention_bwd_mma")


def _k3_counts() -> tuple[int, ...]:
    """K3's launch counts, in the order of :data:`K3_COUNTS`."""
    return (flash_attention.launches, flash_attention.wgmma_launches,
            flash_attention.lse_launches, flash_attention.bwd_launches,
            flash_attention.bwd_mma_launches)


def _local(x):
    """A DTensor's block on this rank; any other value as it is."""
    return x.to_local() if hasattr(x, "to_local") else x


def _from_lead(values: list, mesh) -> list:
    """``values`` as rank 0 holds them, on every rank of ``mesh`` (as they
    are without one)."""
    if mesh is not None:
        import torch.distributed as dist

        dist.broadcast_object_list(values, src=0)
    return values


def _incarnation(job: dict, rank: int = 0) -> dict:
    """One incarnation of the job on one rank (the caller holds
    :func:`deterministic`): restore the CMI (or init), train until the end
    or a reclaim, publish. Without a mesh (``job["mesh"]`` None) it runs
    on ``job["device"]`` as the only rank; with one, on this rank of that
    mesh in the default group: rank 0 owns the job store and the
    publishes, every rank sends its shards to rank 0 and reads its own
    from a CMI. Every rank returns its outcome; rank 0's carries the
    schedule on to the next incarnation, its K3 launches and its peak
    memory."""
    from repro_torch.core.cmi import restore_cmi, snapshot_to_host
    from repro_torch.distributed.group import beat
    from repro_torch.distributed.sharding import mesh_device, place_tree
    from repro_torch.distributed.steps import train_state_shardings

    args, cfg, incarnation = job["args"], job["cfg"], job["incarnation"]
    schedule, reclaim, job_id = job["schedule"], job["reclaim"], job["job_id"]
    mesh = mesh_for(job["mesh"], job["device_type"]) if job["mesh"] else None
    device = mesh_device(mesh) if mesh is not None else job["device"]
    # ranks start at once and are held bitwise: see utils.warm_cpu_math
    warm_cpu_math(torch.zeros(1, device=device))
    lead = rank == 0
    metrics = _Metrics(args.metrics if lead else None)
    counts = _k3_counts()
    store = JobStore(args.store)
    node = f"instance-{incarnation}"
    opt_cfg = AdamWConfig(moment_dtype=cfg.opt_moment_dtype)
    step_fn = make_train_step(cfg, opt_cfg, peak_lr=args.peak_lr, warmup=args.warmup,
                              total_steps=args.steps, mesh=mesh)
    pipe = TokenPipeline(cfg, args.seq_len, args.batch, seed=args.seed)
    t0 = time.perf_counter()
    dhp, seen = None, [None, None]
    if lead:
        nbs = NBS(args.store + "/nbs")
        nbs.add_node(node, device=device, mesh=mesh)
        dhp = DHP(nbs, node, store, delta=DeltaPolicy(enabled=not args.no_delta),
                  async_publish=args.async_publish)
        rec = store.svc_get_job(job_id, worker=node)
        seen = [rec.status, rec.cmi]
    status, cmi = _from_lead(seen, mesh)
    if status == "ckpt":
        if lead:
            state, _ = dhp.restart(job_id, node=node)
        else:
            state, _ = restore_cmi(store.cmi_root(job_id), cmi, mesh=mesh)
        if mesh is not None:
            # re-pin to this incarnation's placements (a no-op where the
            # remapped spec is already the rules'; a resharding otherwise)
            state = place_tree(state, train_state_shardings(cfg, opt_cfg, mesh))
        if lead:
            logger.info("resumed job %s at step %d on %s (mesh %s)", job_id,
                        int(_local(state["step"])), node, job["mesh"])
    else:
        state = make_init_fn(cfg, opt_cfg, seed=args.seed, device=device, mesh=mesh)()
        if lead:
            logger.info("fresh start for job %s on %s (mesh %s)", job_id, node, job["mesh"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    beat()
    extra = {}
    if args.metrics and status == "ckpt" and mesh is not None:
        # what the remap and the re-pin restored: a host copy of the whole
        # state, so only where a mesh remaps it (without one the restore is
        # the CMI's own arrays, and the resumed run's end state checks it)
        digest = state_digest(snapshot_to_host(state))
        extra = {"restored_digest": digest} if lead else {}
    metrics("start", incarnation=incarnation, node=node, resumed=status == "ckpt",
            step=int(_local(state["step"])), s=time.perf_counter() - t0,
            mesh=job["mesh"], model_flops_per_step=step_flops(cfg, args.batch, args.seq_len),
            **extra)
    loss, outcome = float("nan"), "finished"
    while int(_local(state["step"])) < args.steps:
        step = int(_local(state["step"]))
        t0 = time.perf_counter()
        batch, _ = pipe.batch_at({"data_step": int(_local(state["data"]["data_step"])),
                                  "seed": args.seed})
        state, m = step_fn(state, batch_to_device(batch, device))
        step += 1
        loss = float(m["loss"])  # waits for the whole step
        beat()
        metrics("step", step=step, loss=loss, lr=float(m["lr"]),
                grad_norm=float(m["grad_norm"]), s=time.perf_counter() - t0,
                incarnation=incarnation)
        if lead and args.log_every and step % args.log_every == 0:
            logger.info("step %d loss %.4f lr %.2e", step, loss, float(m["lr"]))
        preempting, = _from_lead(
            [lead and (bool(reclaim.value) or schedule.should_preempt(step))], mesh)
        if step % args.publish_every == 0 or preempting or step >= args.steps:
            t0 = time.perf_counter()
            # on a mesh every rank sends its shards to rank 0
            snap = snapshot_to_host(state) if mesh is not None else state
            if lead:
                name = dhp.publish(job_id, "ckpt", snap, step=step)
                metrics("publish", step=step, cmi=name, s=time.perf_counter() - t0,
                        incarnation=incarnation)
            del snap
            beat()
        if preempting and step < args.steps:
            outcome = "preempted"
            break
    step = int(_local(state["step"]))
    if lead:
        if outcome == "preempted":
            dhp.flush()
            store.release(job_id)
            reclaim.value = 0
        else:
            dhp.publish(job_id, "finished", product={"final_loss": loss, "steps": step},
                        step=step)
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()
    now = _k3_counts()
    return {"outcome": outcome, "loss": loss, "step": step,
            "schedule": schedule if lead else None,
            "launches": [b - a for a, b in zip(counts, now)],
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else None)}


def _rank(rank: int, job: dict) -> dict:
    """A rank process's entry: :func:`_incarnation` under
    :func:`deterministic`, entered before the process's first CUDA call.
    SIGTERM is ignored here: the launcher takes the reclaim notice and rank
    0 reads it from ``job["reclaim"]``, so a signal to the whole process
    group leaves every rank alive to publish."""
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    with deterministic():
        return _incarnation(job, rank)


def build_worker(args, cfg, job_id, device, mesh_specs, box):
    """The supervisor's side: incarnation i runs :func:`_incarnation` on
    ``mesh_specs[i]`` (the last spec for later ones; no mesh when
    ``mesh_specs`` is None), in this process for one device or a one-rank
    mesh, else in one process a rank of a fresh group, which is ended when
    its ranks make no progress (no step, no publish) for
    ``args.rank_timeout`` seconds. Raises :class:`Preempted` when the
    incarnation was reclaimed. ``box`` carries the schedule and the reclaim
    flag between incarnations and sums rank 0's launches."""
    from repro_torch.distributed.group import free_port, in_group, run_ranks

    def make_worker(incarnation: int):
        def worker():
            spec = mesh_specs[min(incarnation, len(mesh_specs) - 1)] if mesh_specs else None
            world = math.prod(parse_mesh(spec)[0]) if spec else 1
            job = {"args": args, "cfg": cfg, "incarnation": incarnation, "mesh": spec,
                   "device": device, "device_type": device.type, "job_id": job_id,
                   "schedule": box["schedule"], "reclaim": box["reclaim"]}
            if spec is None:
                out = _incarnation(job)
            elif world == 1:
                with in_group(0, 1, free_port(), device.type, args.rank_timeout):
                    out = _incarnation(job)
            else:
                out = run_ranks(_rank, world, args=(job,), device_type=device.type,
                                timeout_s=args.rank_timeout,
                                threads=max(1, (os.cpu_count() or 1) // world))[0]
            box["schedule"] = out["schedule"]
            box["launches"] = [a + b for a, b in zip(box["launches"], out["launches"])]
            box["peak_memory_bytes"] = out["peak_memory_bytes"]
            if out["outcome"] == "preempted":
                where = f" (mesh {spec})" if spec else ""
                raise Preempted(f"instance reclaimed at step {out['step']}{where}")
            return out["loss"]

        return worker

    return make_worker


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config's depth to this many layers (0: keep it); widths stay")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--publish-every", type=int, default=10)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mesh", default=None,
                    help="e.g. 2x2 = data×model ranks (default: one device, no mesh)")
    ap.add_argument("--remesh", default=None,
                    help="comma-separated mesh per incarnation (elastic restart), e.g. 2x2,2x1")
    ap.add_argument("--rank-timeout", type=float, default=RANK_TIMEOUT_S,
                    help="seconds a mesh incarnation's ranks may go without a step or a "
                         "publish before they are ended (a hang); also each collective's limit")
    ap.add_argument("--preempt-at", default="", help="simulated reclaim steps, e.g. 17,29")
    ap.add_argument("--store", default="/tmp/navp-jobs")
    ap.add_argument("--job-id", default=None)
    ap.add_argument("--peak-lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-delta", action="store_true")
    ap.add_argument("--async-publish", action="store_true")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (default: the CUDA card)")
    ap.add_argument("--metrics", default=None,
                    help="append one JSON line per step, publish and incarnation here")
    args = ap.parse_args(argv)
    spec = args.remesh or args.mesh
    mesh_specs = spec.split(",") if spec else None
    # the reclaim notice: SIGTERM sets it here and the incarnation's rank 0
    # reads it, in this process or in its own (a flag in shared memory,
    # which a signal handler sets without taking a lock)
    reclaim = multiprocessing.get_context("spawn").RawValue("b", 0)

    def on_sigterm(*_):
        reclaim.value = 1
        logger.warning("reclaim notice (SIGTERM): publishing after this step")

    previous = signal.signal(signal.SIGTERM, on_sigterm)
    try:
        with deterministic():
            device = resolve_device(args.device)
            cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
            if args.layers:
                cfg = cfg.with_(n_layers=args.layers)
            store = JobStore(args.store)
            job_id = args.job_id
            if job_id is None:
                job_id = store.create_job(
                    {"arch": args.arch, "steps": args.steps, "seq_len": args.seq_len,
                     "batch": args.batch}
                ).job_id
            schedule = SpotSchedule(
                preempt_steps=tuple(int(x) for x in args.preempt_at.split(",") if x),
            )
            box = {"schedule": schedule, "reclaim": reclaim, "launches": [0] * len(K3_COUNTS),
                   "peak_memory_bytes": None}
            loss, incarnations = run_preemptible(
                build_worker(args, cfg, job_id, device, mesh_specs, box))
            _Metrics(args.metrics)(
                "end", job_id=job_id, final_loss=loss, incarnations=incarnations, mesh=mesh_specs,
                launches=dict(zip(K3_COUNTS, box["launches"])),
                peak_memory_bytes=box["peak_memory_bytes"])
    finally:
        signal.signal(signal.SIGTERM, previous)
    logger.info(
        "job %s finished: loss=%.4f after %d incarnation(s); jobs=%s",
        job_id, loss, incarnations, store.svc_list_jobs(),
    )
    return loss


if __name__ == "__main__":
    main()
