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

The model runs on the CUDA card unless ``--device cpu`` is given. Meshes
other than ``1x1`` and ``--remesh`` (elastic restart onto another mesh)
come with the multi-card slice.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --smoke \\
        --device cpu --steps 30 --publish-every 10 --preempt-at 17 --store /tmp/navp-jobs

``--metrics FILE`` appends one JSON line per step, publish and
incarnation (losses, seconds, CMI names, model FLOPs a step, K3 launches,
peak device memory).
``main`` returns the final loss.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import DHP, NBS, JobStore
from repro_torch.core.delta import DeltaPolicy
from repro_torch.core.dhp import Preempted
from repro_torch.core.preemption import PreemptionNotice, SpotSchedule, run_preemptible
from repro_torch.data import TokenPipeline
from repro_torch.distributed.steps import batch_to_device, make_init_fn, make_train_step
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.optim import AdamWConfig
from repro_torch.utils import logger, resolve_device

_MESH_LATER = ("{what} is not ported yet: meshes and elastic restart come with the "
               "multi-card slice (ROADMAP queue 1, item 11: distributed/*)")


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


def build_worker(args, cfg, store, nbs, schedule, notice, job_id, device, metrics):
    def make_worker(incarnation: int):
        def worker():
            node = f"instance-{incarnation}"
            if node not in nbs.nodes:
                nbs.add_node(node, device=device)
            dhp = DHP(
                nbs, node, store,
                delta=DeltaPolicy(enabled=not args.no_delta),
                async_publish=args.async_publish,
            )
            opt_cfg = AdamWConfig(moment_dtype=cfg.opt_moment_dtype)
            step_fn = make_train_step(cfg, opt_cfg, peak_lr=args.peak_lr, warmup=args.warmup,
                                      total_steps=args.steps)
            pipe = TokenPipeline(cfg, args.seq_len, args.batch, seed=args.seed)
            job = store.svc_get_job(job_id, worker=node)
            t0 = time.perf_counter()
            if job.status == "ckpt":
                state, _ = dhp.restart(job_id, node=node)
                logger.info("resumed job %s at step %d on %s", job_id, int(state["step"]), node)
            else:
                state = make_init_fn(cfg, opt_cfg, seed=args.seed, device=device)()
                logger.info("fresh start for job %s on %s", job_id, node)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            metrics("start", incarnation=incarnation, node=node, resumed=job.status == "ckpt",
                    step=int(state["step"]), s=time.perf_counter() - t0,
                    model_flops_per_step=step_flops(cfg, args.batch, args.seq_len))
            loss = float("nan")
            while int(state["step"]) < args.steps:
                step = int(state["step"])
                t0 = time.perf_counter()
                batch, _ = pipe.batch_at({"data_step": int(state["data"]["data_step"]),
                                          "seed": args.seed})
                state, m = step_fn(state, batch_to_device(batch, device))
                step += 1
                loss = float(m["loss"])  # waits for the whole step
                metrics("step", step=step, loss=loss, lr=float(m["lr"]),
                        grad_norm=float(m["grad_norm"]), s=time.perf_counter() - t0,
                        incarnation=incarnation)
                if args.log_every and step % args.log_every == 0:
                    logger.info("step %d loss %.4f lr %.2e", step, loss, float(m["lr"]))
                preempting = notice.imminent() or schedule.should_preempt(step)
                if step % args.publish_every == 0 or preempting or step >= args.steps:
                    t0 = time.perf_counter()
                    name = dhp.publish(job_id, "ckpt", state, step=step)
                    metrics("publish", step=step, cmi=name, s=time.perf_counter() - t0,
                            incarnation=incarnation)
                if preempting and step < args.steps:
                    dhp.flush()
                    store.release(job_id)
                    notice.clear()
                    raise Preempted(f"instance reclaimed at step {step}")
            dhp.publish(
                job_id, "finished",
                product={"final_loss": loss, "steps": int(state["step"])},
                step=int(state["step"]),
            )
            return loss

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
    ap.add_argument("--mesh", default="1x1", help="only 1x1 (one device) so far")
    ap.add_argument("--remesh", default=None, help="elastic restart: not ported yet")
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
    if args.mesh != "1x1":
        raise NotImplementedError(_MESH_LATER.format(what=f"--mesh {args.mesh}"))
    if args.remesh:
        raise NotImplementedError(_MESH_LATER.format(what="--remesh"))

    with deterministic():
        device = resolve_device(args.device)
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
        if args.layers:
            cfg = cfg.with_(n_layers=args.layers)
        store = JobStore(args.store)
        nbs = NBS(args.store + "/nbs")
        job_id = args.job_id
        if job_id is None:
            job_id = store.create_job(
                {"arch": args.arch, "steps": args.steps, "seq_len": args.seq_len,
                 "batch": args.batch}
            ).job_id
        schedule = SpotSchedule(
            preempt_steps=tuple(int(x) for x in args.preempt_at.split(",") if x),
        )
        notice = PreemptionNotice()
        notice.install_sigterm()
        metrics = _Metrics(args.metrics)
        launches = (flash_attention.launches, flash_attention.wgmma_launches,
                    flash_attention.lse_launches)
        make_worker = build_worker(args, cfg, store, nbs, schedule, notice, job_id, device,
                                   metrics)
        loss, incarnations = run_preemptible(make_worker)
        metrics("end", job_id=job_id, final_loss=loss, incarnations=incarnations,
                launches={"flash_attention": flash_attention.launches - launches[0],
                          "flash_attention_wgmma": flash_attention.wgmma_launches - launches[1],
                          "flash_attention_lse": flash_attention.lse_launches - launches[2]},
                peak_memory_bytes=(torch.cuda.max_memory_allocated(device)
                                   if device.type == "cuda" else None))
    logger.info(
        "job %s finished: loss=%.4f after %d incarnation(s); jobs=%s",
        job_id, loss, incarnations, store.svc_list_jobs(),
    )
    return loss


if __name__ == "__main__":
    main()
