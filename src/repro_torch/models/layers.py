"""Shared layers: norms, RoPE, embeddings, SwiGLU and the GELU MLP.

Port of the JAX package's ``repro/models/layers.py`` with its float32
upcasts kept: norms and RoPE compute in float32 and round once to the
activation dtype, and the unembedding returns float32 logits from bf16
operands. ``softmax_xent_chunked`` keeps the reference's float32 logits
per sequence chunk, each chunk recomputed in the backward pass.
``gelu_mlp`` uses GELU's tanh approximation, ``jax.nn.gelu``'s default
(PyTorch's default is the exact erf form).
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import spans
from repro_torch.configs.base import ArchConfig

# Vocabulary rows per float32 block of the unembedding: 16,384 rows at
# d_model 2048 is a 134 MB transient, in place of a 1.24 GB float32 copy
# of qwen3-1.7b's tied 151,936-row embedding.
UNEMBED_BLOCK_ROWS = 16384


def pdtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# While a recording is on, every parameter the init functions make is
# recorded with its logical axes (``Model.param_axes``), by identity.
_AXES: contextvars.ContextVar[dict | None] = contextvars.ContextVar("param_axes", default=None)


@contextlib.contextmanager
def recording_axes():
    """Yields ``{id(parameter): axes}``, filled by the inits in the body."""
    rec: dict[int, tuple] = {}
    token = _AXES.set(rec)
    try:
        yield rec
    finally:
        _AXES.reset(token)


def with_axes(t: torch.Tensor, axes) -> torch.Tensor:
    """``t``, its logical axes recorded when a recording is on."""
    rec = _AXES.get()
    if rec is not None:
        rec[id(t)] = tuple(axes)
    return t


def init_const(shape, value: float, axes, dtype: torch.dtype,
               device: torch.device | str) -> torch.Tensor:
    """A parameter filled with ``value`` (norm scales, biases), with its
    logical axes."""
    return with_axes(torch.full(shape, value, dtype=dtype, device=device), axes)


def init_dense(gen: torch.Generator | None, shape, axes, dtype: torch.dtype,
               device: torch.device | str, scale: float | None = None) -> torch.Tensor:
    """Truncated normal in [-2, 2] times ``scale`` (fan-in scaling by
    default: ``1/sqrt`` of the product of the non-``layers`` axes but the
    last). On the ``meta`` device only the shape and dtype are made."""
    fan_in = math.prod([s for s, a in zip(shape, axes) if a != "layers"][:-1]) or 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    if w.device.type != "meta":
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        w.mul_(scale)
    return with_axes(w.to(dtype), axes)


def init_embedding(gen: torch.Generator | None, cfg: ArchConfig,
                   device: torch.device | str) -> torch.Tensor:
    emb = torch.empty((cfg.vocab, cfg.d_model), dtype=torch.float32, device=device)
    if emb.device.type != "meta":
        emb.normal_(0.0, 1.0, generator=gen).mul_(0.02)
    return with_axes(emb.to(pdtype(cfg)), ("vocab", "embed"))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu).square(), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (GPT-NeoX half-rotation)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: (S,) or (..., S) int."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)  # (half,)
    angles = positions.float()[..., :, None] * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., :, None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embedding / unembedding / FFN
# ---------------------------------------------------------------------------


def embed(tokens: torch.Tensor, emb: torch.Tensor, plan=None) -> torch.Tensor:
    """Rows of ``emb``; the backward sums each token's gradient into its row
    in a fixed order (deterministic on the card). Under a plan whose vocab
    is split, ``emb`` is this rank's block of rows: each rank looks up the
    tokens it owns (zeros for the others) and the ranks' lookups are added."""
    if plan is None or not plan.vocab:
        return F.embedding(tokens, emb)
    rows = emb.shape[0]
    local = tokens - plan.rank * rows
    own = (local >= 0) & (local < rows)
    out = F.embedding(torch.where(own, local, 0), emb)
    return plan.reduce_from(torch.where(own[..., None], out, 0.0))


def unembed_logits(h: torch.Tensor, emb_out: torch.Tensor, plan=None) -> torch.Tensor:
    """h: (..., E) -> float32 logits (..., V).

    The reference's ``preferred_element_type=float32``: the bf16 operands
    are widened to float32 (exactly) and multiplied in float32, block by
    block of :data:`UNEMBED_BLOCK_ROWS` vocabulary rows, so no float32
    copy of the whole table is kept. Greedy argmax over bf16-rounded
    logits would tie far more often. Under a plan whose vocab is split,
    each rank computes its rows' logits and the whole (..., V) is gathered
    (the serve steps return it).
    """
    hf = h.float()
    v = emb_out.shape[0]
    out = torch.empty(h.shape[:-1] + (v,), dtype=torch.float32, device=h.device)
    for r0 in range(0, v, UNEMBED_BLOCK_ROWS):
        blk = emb_out[r0:r0 + UNEMBED_BLOCK_ROWS].float()
        out[..., r0:r0 + blk.shape[0]] = torch.matmul(hf, blk.T)
    if plan is not None and plan.vocab:
        out = plan.all_gather(out, -1)
    return out


def _xent_chunk(h: torch.Tensor, emb_out: torch.Tensor, labels: torch.Tensor):
    """(sum of -log p(label), count) over one chunk's valid labels, from
    float32 logits: the bf16 operands widened exactly and multiplied in
    float32 (the reference's ``preferred_element_type=float32``)."""
    logits = torch.matmul(h.float(), emb_out.float().T)  # (B, chunk, V)
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.clamp(labels, 0, logits.shape[-1] - 1)
    gold = torch.gather(logits, -1, lab[..., None].long())[..., 0]
    valid = (labels >= 0).float()
    return torch.sum((lse - gold) * valid), torch.sum(valid)


def _xent_chunk_vocab_split(h: torch.Tensor, emb_out: torch.Tensor, labels: torch.Tensor,
                            plan):
    """:func:`_xent_chunk` over a vocab split on the model axis: each rank's
    float32 logits of its rows; the row maximum and the sum of
    exponentials all-reduced over the ranks, the gold logit from the rank
    that owns the label."""
    logits = torch.matmul(h.float(), emb_out.float().T)  # (B, chunk, V / ranks)
    m = plan.all_reduce(logits.detach().amax(dim=-1), "max")
    se = plan.reduce_from(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
    lse = m + torch.log(se)
    rows = logits.shape[-1]
    lab = labels - plan.rank * rows
    own = (lab >= 0) & (lab < rows)
    gold = torch.gather(logits, -1, torch.where(own, lab, 0)[..., None].long())[..., 0]
    gold = plan.reduce_from(torch.where(own, gold, 0.0))
    valid = (labels >= 0).float()
    return torch.sum((lse - gold) * valid), torch.sum(valid)


def softmax_xent_chunked(h: torch.Tensor, emb_out: torch.Tensor, labels: torch.Tensor,
                         chunk: int, plan=None) -> torch.Tensor:
    """Mean next-token loss with float32 logits made only per S-chunk.

    h (B, S, E) final hidden states, emb_out (V, E), labels (B, S) with -1
    ignored. S is padded to a multiple of the chunk with ignored labels;
    each chunk runs under ``torch.utils.checkpoint``, as the reference's
    under ``jax.checkpoint``, so the backward recomputes one chunk's
    (B, chunk, V) logits at a time instead of keeping all of them.

    Under a plan: with the vocab split, ``emb_out`` is this rank's rows and
    ``h`` enters the split region (gathered along S under ``seq_shard``);
    with it whole under ``seq_shard``, each rank takes its own positions
    and the sums are added over the ranks.

    The loss head runs under the span ``loss_head``; its backward pass,
    each chunk's recomputation and gradient, is the span ``loss_head.bwd``.
    """
    with spans.span("loss_head"):
        return spans.backward_span("loss_head", (h, emb_out),
                                   lambda h, emb_out: _xent_chunks(h, emb_out, labels, chunk, plan))


def _xent_chunks(h: torch.Tensor, emb_out: torch.Tensor, labels: torch.Tensor, chunk: int,
                 plan) -> torch.Tensor:
    xent = _xent_chunk
    if plan is not None and plan.vocab:
        h = plan.gather_seq(h) if plan.seq_shard else plan.copy_to(h)
        xent = functools.partial(_xent_chunk_vocab_split, plan=plan)
    elif plan is not None and plan.seq_shard:
        a, b = plan.block(labels.shape[1])
        labels = labels[:, a:b]
        emb_out = plan.copy_to(emb_out)
    b, s, _ = h.shape
    chunk = min(chunk, s)
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    tot = cnt = None
    for i in range(nc):
        sl = slice(i * chunk, (i + 1) * chunk)
        t, c = checkpoint(xent, h[:, sl], emb_out, labels[:, sl], use_reentrant=False)
        tot, cnt = (t, c) if tot is None else (tot + t, cnt + c)
    if plan is not None and plan.seq_shard and not plan.vocab:
        tot, cnt = plan.reduce_from(tot), plan.reduce_from(cnt)
    return tot / torch.clamp(cnt, min=1.0)


def _mlp_enter(x: torch.Tensor, weights: tuple, plan) -> tuple:
    """``(x, weights)`` as a rank computes an MLP with them: where ``mlp``
    is split, ``x`` enters the rank's hidden units (all-gathered along S
    under ``seq_shard``); where it is whole under ``seq_shard``, the rank
    computes it all on its own positions, so each weight's gradient is a
    partial sum (``copy_to``)."""
    if plan is not None and plan.mlp:
        return (plan.gather_seq(x) if plan.seq_shard else plan.copy_to(x)), weights
    if plan is not None and plan.seq_shard:
        return x, tuple(plan.copy_to(w) for w in weights)
    return x, weights


def _mlp_leave(y: torch.Tensor, plan) -> torch.Tensor:
    """An MLP's output from :func:`_mlp_enter`'s input: the ranks' partial
    sums over their hidden units added where ``mlp`` is split
    (reduce-scattered along S under ``seq_shard``)."""
    if plan is not None and plan.mlp:
        return plan.scatter_seq(y) if plan.seq_shard else plan.reduce_from(y)
    return y


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, plan=None) -> torch.Tensor:
    """SwiGLU. Under a plan whose ``mlp`` is split, column-parallel then
    row-parallel on this rank's hidden units (:func:`_mlp_enter`,
    :func:`_mlp_leave`)."""
    x, (w_gate, w_up, w_down) = _mlp_enter(x, (w_gate, w_up, w_down), plan)
    g = torch.matmul(x, w_gate)
    u = torch.matmul(x, w_up)
    return _mlp_leave(torch.matmul(F.silu(g) * u, w_down), plan)


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor, w_out: torch.Tensor,
             b_out: torch.Tensor, plan=None) -> torch.Tensor:
    """The encoder-decoder's MLP (tanh GELU, biases). Under a plan as
    :func:`swiglu`, ``b_in`` with ``w_in``; ``b_out`` added once, after the
    partial sums are added (on each rank before, it would count once a
    rank)."""
    x, (w_in, b_in, w_out) = _mlp_enter(x, (w_in, b_in, w_out), plan)
    h = torch.matmul(x, w_in) + b_in
    y = _mlp_leave(torch.matmul(F.gelu(h, approximate="tanh"), w_out), plan)
    return y + (plan.copy_to(b_out) if plan is not None and plan.seq_shard else b_out)
