"""Attention: GQA and MLA, train/prefill through K3 and one-token decode.

Port of the JAX package's ``repro/models/attention.py``.
Layouts are the reference's: activations (B, S, E); q (B, S, H, Dh); k and
v (B, S, KV, Dh), where query head ``h`` reads kv head ``h // G`` with
G = n_heads // n_kv_heads, so k/v are never physically repeated.

Prefill/train attention is K3 (``repro_torch.kernels.flash_attention``)
where the reference calls ``blockwise_attention``: the same function with
the probabilities kept in float32 for the PV product (the reference rounds
them to bf16 first, so bf16 models differ by that rounding). The kernel
reads (B, S, H, Dh) through strides, so the (B, H, S, Dh) view costs no
copy.

KV cache: ``{"k": (B, S_max, KV, Dh), "v": ...}``; with a sliding window
S_max = window and slot = pos % W. Decode writes its one position into
the cache in place (the reference returns an updated copy): the cache is
the request's state and is never read at an older version. Cross
attention (the encoder-decoder's) takes k/v from ``kv_source``.

MLA (deepseek): q through a LoRA (``wq_a``, RMSNorm, ``wq_b``), k/v from a
compressed latent ``ckv`` (``wkv_a``, RMSNorm) expanded per head by
``wkv_b``, and a RoPE key shared by every head. Train and prefill expand
it: q and k are (B, S, H, nope + rope) = 192 wide and v is 128, and K3
takes both head dims (scale 1/sqrt(192)); the shared rope key is
concatenated into one dense k, so the kernel reads no zero-stride head.
Decode is the absorbed form over the latent cache ``{"ckv": (B, S_max,
KVr), "kr": (B, S_max, Rr)}``, with the reference's roundings: ``q_lat``
a bf16 product, the scores float32, the probabilities rounded to the
cache's dtype before the latent product. The projections and the
absorbed decode run in the profiler range ``mla`` (K3 outside it).

Under a tensor-parallel plan (``distributed/tp.py``) GQA runs on the
rank's q heads (:func:`_tp_attend`: self or cross attention, windowed or
not; the hybrid mixer adds its SSD's partial sums to the attention's
before one reduction, ``models/transformer.py``), its prefill keeps the
rank's block of positions of the cache with every kv head (a rolling
window's block of its slots; the cross attention's block of the
encoder's frames) and decode attends over the blocks where they lie,
combined over the model axis (:func:`attend_block`). MLA runs on the
rank's heads: ``wq_b`` and ``wkv_b`` column-parallel on ``heads``, ``wo``
row-parallel, the low-rank ``wq_a``/``wkv_a`` and their norms whole
(every model rank computes the latent rows; their gradients are summed
over the axis), K3 on the rank's H/M heads. Prefill keeps the rank's
block of positions of the latent cache; the absorbed decode scores every
head over that block (see :func:`mla_decode`).
"""

from __future__ import annotations

import math

import torch

from repro_torch import spans
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import apply_rope, init_const, init_dense, pdtype, rmsnorm

NEG = -1e30


def init_gqa(gen, cfg: ArchConfig, n_layers: int, device) -> dict:
    e, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh = cfg.resolved_head_dim
    dt = pdtype(cfg)
    p = {
        "wq": init_dense(gen, (n_layers, e, h, dh), ("layers", "embed", "heads", "head_dim"), dt, device),
        "wk": init_dense(gen, (n_layers, e, kv, dh), ("layers", "embed", "kv_heads", "head_dim"), dt, device),
        "wv": init_dense(gen, (n_layers, e, kv, dh), ("layers", "embed", "kv_heads", "head_dim"), dt, device),
        "wo": init_dense(gen, (n_layers, h, dh, e), ("layers", "heads", "head_dim", "embed"), dt, device),
    }
    if cfg.attn_bias:
        p["bq"] = init_const((n_layers, h, dh), 0.0, ("layers", "heads", "head_dim"), dt, device)
        p["bk"] = init_const((n_layers, kv, dh), 0.0, ("layers", "kv_heads", "head_dim"), dt,
                             device)
        p["bv"] = init_const((n_layers, kv, dh), 0.0, ("layers", "kv_heads", "head_dim"), dt,
                             device)
        p["bo"] = init_const((n_layers, e), 0.0, ("layers", "embed"), dt, device)
    if cfg.qk_norm:
        p["q_norm"] = init_const((n_layers, dh), 1.0, ("layers", "head_dim"), dt, device)
        p["k_norm"] = init_const((n_layers, dh), 1.0, ("layers", "head_dim"), dt, device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bse,ehd->bshd") as one matrix product."""
    e = w.shape[0]
    return torch.matmul(x, w.reshape(e, -1)).unflatten(-1, w.shape[1:])


def _proj_qkv(p, x, cfg: ArchConfig, src=None):
    """q from ``x``; k and v from ``src`` (cross attention) or ``x``."""
    src = x if src is None else src
    q, k, v = _proj(x, p["wq"]), _proj(src, p["wk"]), _proj(src, p["wv"])
    if cfg.attn_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _out(p, o: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """einsum("bshd,hde->bse", o, wo)."""
    y = torch.matmul(o.flatten(-2), p["wo"].flatten(0, 1))
    return y + p["bo"] if cfg.attn_bias else y


def _rope_qkv(p, x, cfg: ArchConfig, use_rope: bool, src=None):
    q, k, v = _proj_qkv(p, x, cfg, src)
    if use_rope:
        q = apply_rope(q, torch.arange(q.shape[1], device=x.device), cfg.rope_theta)
        k = apply_rope(k, torch.arange(k.shape[1], device=x.device), cfg.rope_theta)
    return q, k, v


def _attend(p, q, k, v, cfg: ArchConfig, causal: bool) -> torch.Tensor:
    """K3 over (B, H, S, Dh) views of the (B, S, H, Dh) activations."""
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=causal, window=cfg.window)
    return _out(p, o.transpose(1, 2), cfg)


def _cache_from(k: torch.Tensor, v: torch.Tensor, s: int, s_max: int, cfg: ArchConfig) -> dict:
    """The decode cache of a prefill: k/v placed in zeros of length s_max."""
    b = k.shape[0]
    if cfg.window and cfg.window > 0:
        s_max = min(s_max, cfg.window)
        # rolling layout: slot = pos % W of the last W positions
        take = min(s, s_max)
        slots = torch.arange(s - take, s, device=k.device) % s_max
        kc = k.new_zeros((b, s_max) + tuple(k.shape[2:]))
        vc = v.new_zeros((b, s_max) + tuple(v.shape[2:]))
        kc[:, slots] = k[:, -take:]
        vc[:, slots] = v[:, -take:]
        return {"k": kc, "v": vc}
    kc = k.new_zeros((b, s_max) + tuple(k.shape[2:]))
    vc = v.new_zeros((b, s_max) + tuple(v.shape[2:]))
    kc[:, :s] = k
    vc[:, :s] = v
    return {"k": kc, "v": vc}


def gqa_train(p, x, cfg: ArchConfig, *, causal: bool = True, use_rope: bool = True,
              kv_source: torch.Tensor | None = None, plan=None):
    """Attention (B, S, E) -> (B, S, E) through K3: the training forward's
    (and the encoder's) self-attention, or cross attention with k/v from
    ``kv_source`` (B, T, E). Under autograd K3 also writes its row
    statistics and its gradient is the plain backward (``FlashAttention``).
    Under a tensor-parallel ``plan`` on the rank's q heads
    (:func:`_tp_attend`)."""
    if plan is not None:
        w = _tp_weights(p, cfg, plan)
        y, _, _ = _tp_attend(w, plan.enter(x), cfg, plan, causal=causal, use_rope=use_rope,
                             kv_source=kv_source)
        return _tp_finish(y, w, cfg, plan)
    q, k, v = _rope_qkv(p, x, cfg, use_rope, kv_source)
    return _attend(p, q, k, v, cfg, causal)


def gqa_prefill(p, x, cfg: ArchConfig, s_max: int, *, use_rope: bool = True, plan=None):
    """The prefill's attention output and its decode cache (k/v padded to
    s_max) from one projection: the reference's ``gqa_train`` and
    ``gqa_prefill_cache``, which project q/k/v twice to equal results.
    Under a ``plan`` the cache is this rank's block of positions
    (``plan.cache_seq``) with every kv head (:func:`tp_cache`)."""
    if plan is None:
        q, k, v = _rope_qkv(p, x, cfg, use_rope)
        return _attend(p, q, k, v, cfg, True), _cache_from(k, v, x.shape[1], s_max, cfg)
    w = _tp_weights(p, cfg, plan)
    y, k, v = _tp_attend(w, plan.enter(x), cfg, plan, causal=True, use_rope=use_rope)
    return _tp_finish(y, w, cfg, plan), tp_cache(k, v, s_max, cfg, plan)


def tp_cache(k: torch.Tensor, v: torch.Tensor, s_max: int, cfg: ArchConfig, plan) -> dict:
    """The decode cache of a prefill on the rank's heads, from the k/v
    projections (B, S, kv heads, Dh) of the kv heads it computes
    (:func:`_tp_attend`): this rank's block of the cache's positions
    (``plan.cache_seq``; of a rolling window's slots) with every kv head."""
    cache = _cache_from(k, v, k.shape[1], s_max, cfg)
    return {name: cache_block(c, cfg, plan, plan.cache_seq) for name, c in cache.items()}


def cache_block(c: torch.Tensor, cfg: ArchConfig, plan, seq) -> torch.Tensor:
    """Every kv head of this rank's block ``seq`` (``(start, stop,
    length)``; all of them where ``None``) of a cache's positions, from
    the model ranks' c (B, S, kv heads, Dh) of the kv heads each computes:
    exchanged over the model axis where the heads are split
    (:func:`_cache_heads`), else cut out of the whole."""
    if plan.heads or plan.kv_heads:
        return _cache_heads(c, cfg, plan, seq)
    if seq is None:
        return c
    return c[:, seq[0]:seq[1]].clone()


def _cache_heads(c: torch.Tensor, cfg: ArchConfig, plan, seq) -> torch.Tensor:
    """Every kv head of this rank's block ``seq`` of cache positions (all
    of them where ``None``) from the model ranks' caches c (B, S, H_kv
    local, Dh) of their own kv heads: an all-to-all along the positions
    where the cache splits them (each rank receives only its block), else
    an all-gather. Where only q heads are split each kv head is taken from
    the first rank whose q heads read it."""
    a, b, n = seq or (0, c.shape[1], c.shape[1])
    if (a, b) == (0, n):
        got = plan.all_gather(c, 2)
    else:
        assert (a, b) == plan.block(n), (seq, plan.size)
        parts = plan.all_to_all(c.transpose(0, 1))  # rank r's heads at my positions, by r
        got = parts.unflatten(0, (plan.size, -1)).permute(2, 1, 0, 3, 4).flatten(2, 3)
    return got if plan.kv_heads else got[:, :, _kv_sources(cfg, plan)]


def _kv_sources(cfg: ArchConfig, plan) -> list[int]:
    """Where only q heads are split: for each kv head, its place in the
    model ranks' kv projections all-gathered along the heads (rank ``r``
    projects the kv heads ``[k0, k1)`` its q heads read)."""
    out: dict[int, int] = {}
    for r in range(plan.size):
        _, _, k0, k1 = plan.with_(rank=r).head_ranges(cfg.n_heads, cfg.n_kv_heads)
        for j in range(k0, k1):
            out.setdefault(j, r * (k1 - k0) + j - k0)
    return [out[j] for j in range(cfg.n_kv_heads)]


def _tp_split(name: str, plan) -> bool:
    """Whether the attention leaf ``name`` is split on the model axis."""
    return ((plan.heads and name in ("wq", "bq", "wo"))
            or (plan.kv_heads and name in ("wk", "wv", "bk", "bv")))


def _tp_weights(p, cfg: ArchConfig, plan) -> dict:
    """The attention leaves a rank computes with. A whole leaf it uses on
    its part of the work (``q_norm`` on its heads, a whole kv projection of
    which it uses some heads, any leaf under ``seq_shard``) goes through
    ``copy_to``, so its gradient is summed over the model axis; ``bo`` is
    added once, after the partial sums (:func:`_tp_finish`). Where only q
    heads are split, ``wk``/``wv`` (``bk``/``bv``) are the view of the kv
    heads ``[h0 // G, (h1 - 1) // G + 1)`` its q heads ``[h0, h1)`` read,
    as the reference's GSPMD program projects them."""
    partial = plan.heads or plan.seq_shard
    w = {name: plan.copy_to(t) if partial and name != "bo" and not _tp_split(name, plan) else t
         for name, t in p.items()}
    if plan.heads and not plan.kv_heads:
        _, _, k0, k1 = plan.head_ranges(cfg.n_heads, cfg.n_kv_heads)
        w = {name: t[:, k0:k1] if name in ("wk", "wv") else t[k0:k1] if name in ("bk", "bv")
             else t for name, t in w.items()}
    return w


def _tp_attend(w, x, cfg: ArchConfig, plan, *, causal: bool, use_rope: bool,
               kv_source: torch.Tensor | None = None):
    """Attention on this rank's q heads: ``(y, k, v)``, y (B, S, E) the
    rank's heads through ``wo`` (the model ranks' partial sums where the
    heads are split; :func:`_tp_finish` adds them and ``bo``) and the k/v
    projections of the kv heads the rank computes (its block where
    ``kv_heads`` is split; where only q heads are split, the ones they
    read; all of them where the heads are whole). ``w`` is
    :func:`_tp_weights`' and ``x`` the input as ``plan.enter`` gives it
    (the whole sequence under ``seq_shard``). Cross attention takes k/v
    from ``kv_source`` (B, T, E), which every model rank holds whole (the
    encoder's output), through ``copy_to`` where the rank uses it on its
    part of the work. K3 runs on the rank's q heads and the kv heads they
    read, windowed where the config is."""
    src = kv_source
    if src is not None and (plan.heads or plan.seq_shard):
        src = plan.copy_to(src)
    q, k, v = _rope_qkv(w, x, cfg, use_rope, src)
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=causal, window=cfg.window)
    return torch.matmul(o.transpose(1, 2).flatten(-2), w["wo"].flatten(0, 1)), k, v


def _tp_finish(y: torch.Tensor, w, cfg: ArchConfig, plan) -> torch.Tensor:
    """A mixer's output on this rank's heads (``plan.leave``: the partial
    sums added where the heads are split, the rank's positions kept under
    ``seq_shard``), ``bo`` added once after."""
    y = plan.leave(y)
    if not cfg.attn_bias:
        return y
    return y + (plan.copy_to(w["bo"]) if plan.seq_shard else w["bo"])


def _tp_out(w, o: torch.Tensor, cfg: ArchConfig, plan) -> torch.Tensor:
    """``_out`` on this rank's heads: row-parallel where the heads are split
    (the ranks' partial sums added), ``bo`` added once after."""
    return _tp_finish(torch.matmul(o.flatten(-2), w["wo"].flatten(0, 1)), w, cfg, plan)


def gqa_decode(p, x, cache: dict, pos: int, cfg: ArchConfig, *, use_rope: bool = True,
               plan=None):
    """One-token decode: write the cache at ``pos`` (in place), attend over it.

    Window caches use rolling slots (pos % W); softmax permutation
    invariance makes slot order irrelevant. Under a ``plan`` see
    :func:`_tp_decode`.
    """
    if plan is not None:
        y = _tp_decode(p, x, cache, pos, cfg, plan, use_rope=use_rope)
        return _tp_finish(y, p, cfg, plan), cache
    q, k, v = _decode_qkv(p, x, pos, cfg, use_rope)
    kc, vc = cache["k"], cache["v"]
    s_max = kc.shape[1]
    slot = _slot(pos, s_max, cfg)
    kc[:, slot:slot + 1] = k
    vc[:, slot:slot + 1] = v
    out = attend_block(_decode_scores(q, kc, pos, 0, s_max, cfg), vc, None, True)
    return _out(p, decode_heads(out, cfg), cfg), cache


def _decode_qkv(p, x, pos: int, cfg: ArchConfig, use_rope: bool):
    """q, k, v (B, 1, heads, Dh) of one decode token at ``pos``."""
    q, k, v = _proj_qkv(p, x, cfg)
    if use_rope:
        posv = torch.full((x.shape[1],), pos, device=x.device)
        q = apply_rope(q, posv, cfg.rope_theta)
        k = apply_rope(k, posv, cfg.rope_theta)
    return q, k, v


def _slot(pos: int, s_max: int, cfg: ArchConfig) -> int:
    """The cache position ``pos`` is written at: a window's rolling slot
    (pos % W), else pos."""
    return pos % s_max if cfg.window and cfg.window > 0 else pos


def decode_scores(q, kc, cfg: ArchConfig):
    """(B, KV, G, 1, S) float32 scores of q (B, 1, H, Dh) against every
    position of ``kc`` (B, S, KV, Dh)."""
    b, s1, _, dh = q.shape
    qg = q.reshape(b, s1, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, dh)
    # (B,KV,G,1,Dh) x (B,KV,Dh,S) -> (B,KV,G,1,S)
    return torch.matmul(qg.permute(0, 2, 3, 1, 4).float(),
                        kc.permute(0, 2, 3, 1).float()[:, :, None]) / math.sqrt(dh)


def _decode_scores(q, kc, pos: int, start: int, s_max: int, cfg: ArchConfig):
    """:func:`decode_scores` against the cache positions ``[start, start +
    S)`` of ``kc``, a cache of ``s_max`` in all; the positions not yet
    written masked to NEG. A rolling window's slots are all valid once
    ``pos`` reaches W, in any block of them."""
    sc = decode_scores(q, kc, cfg)
    idx = torch.arange(start, start + kc.shape[1], device=q.device)
    windowed = bool(cfg.window) and cfg.window > 0
    valid = (idx <= pos) if not windowed else ((idx <= pos) | (pos >= s_max))
    return torch.where(valid, sc, NEG)


def attend_block(sc: torch.Tensor, vc: torch.Tensor, plan, whole: bool) -> torch.Tensor:
    """The (B, KV, G, 1, Dh) output of scores ``sc`` (B, KV, G, 1, S) over
    the cache positions of ``vc`` (B, S, KV, Dh): the probabilities rounded
    to ``vc``'s dtype. Where the rank holds a block of the positions (not
    ``whole``), flash-decoding's combine: the row maximum and the sum of
    exponentials all-reduced over the model axis, so the probabilities are
    the rank's block of the whole softmax, and the partial outputs added."""
    if whole:
        probs = torch.softmax(sc, dim=-1).to(vc.dtype)
        return torch.matmul(probs, vc.permute(0, 2, 1, 3)[:, :, None])  # (B,KV,G,1,Dh)
    m = plan.all_reduce(sc.amax(dim=-1, keepdim=True), "max")
    ex = torch.exp(sc - m)
    probs = (ex / plan.all_reduce(ex.sum(dim=-1, keepdim=True))).to(vc.dtype)
    out = torch.matmul(probs, vc.permute(0, 2, 1, 3)[:, :, None])  # this block's share
    return plan.all_reduce(out.float()).to(vc.dtype)


def decode_heads(out: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """(B, KV, G, 1, Dh) attention outputs as (B, 1, H, Dh)."""
    b, _, _, s1, dh = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(b, s1, cfg.n_heads, dh)


def _tp_decode(p, x, cache: dict, pos: int, cfg: ArchConfig, plan, *, use_rope: bool):
    """One-token decode over this rank's block of the cache's positions
    (``plan.cache_seq``: every kv head, the positions ``[a, b)`` of
    ``s_max``, a rolling window's slots where the config has one), where
    it lies: the new q heads (and k/v heads where they are split)
    all-gathered over the model axis (a few KB); the new k/v written only
    by the rank whose block holds the slot; every head scored over the
    rank's positions and combined over the axis (:func:`attend_block`);
    then the rank's heads through ``wo``: the ranks' partial sums, which
    :func:`_tp_finish` adds."""
    q, k, v = _decode_qkv(p, x, pos, cfg, use_rope)
    if plan.kv_heads:
        k, v = plan.all_gather(k, 2), plan.all_gather(v, 2)
    if plan.heads:
        q = plan.all_gather(q, 2)
    kc, vc = cache["k"], cache["v"]
    a, e, s_max = plan.cache_seq or (0, kc.shape[1], kc.shape[1])
    slot = _slot(pos, s_max, cfg)
    if a <= slot < e:  # this rank's block holds the new position
        kc[:, slot - a:slot - a + 1] = k
        vc[:, slot - a:slot - a + 1] = v
    out = attend_block(_decode_scores(q, kc, pos, a, s_max, cfg), vc, plan, e - a == s_max)
    h0, h1, _, _ = plan.head_ranges(cfg.n_heads, cfg.n_kv_heads)
    return torch.matmul(decode_heads(out, cfg)[:, :, h0:h1].flatten(-2), p["wo"].flatten(0, 1))


# ---------------------------------------------------------------------------
# MLA (deepseek): expanded train/prefill through K3, absorbed decode
# ---------------------------------------------------------------------------


def init_mla(gen, cfg: ArchConfig, n_layers: int, device) -> dict:
    e, h = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dt = pdtype(cfg)
    p = {"wq_a": init_dense(gen, (n_layers, e, qr), ("layers", "embed", "q_lora"), dt, device),
         "q_ln": init_const((n_layers, qr), 1.0, ("layers", "q_lora"), dt, device)}
    p["wq_b"] = init_dense(gen, (n_layers, qr, h, nd + rd),
                           ("layers", "q_lora", "heads", "head_dim"), dt, device)
    p["wkv_a"] = init_dense(gen, (n_layers, e, kvr + rd), ("layers", "embed", None), dt, device)
    p["kv_ln"] = init_const((n_layers, kvr), 1.0, ("layers", None), dt, device)
    p["wkv_b"] = init_dense(gen, (n_layers, kvr, h, nd + vd), ("layers", None, "heads", "head_dim"),
                            dt, device)
    p["wo"] = init_dense(gen, (n_layers, h, vd, e), ("layers", "heads", "head_dim", "embed"), dt,
                         device)
    return p


def _mla_qkv(p, x, cfg: ArchConfig, positions: torch.Tensor, plan=None):
    """(q_nope (B,S,H,nd), q_rope (B,S,H,rd), ckv (B,S,KVr), k_rope (B,S,rd)).
    Under a ``plan`` ``x`` is this rank's block of the sequence (see
    :func:`_mla_attend`): the low-rank products run on it and their rows
    are all-gathered along S, the rest on the whole sequence."""
    nd, kvr = cfg.qk_nope_dim, cfg.kv_lora_rank
    a, c = torch.matmul(x, p["wq_a"]), torch.matmul(x, p["wkv_a"])
    if plan is not None:
        a, c = plan.gather_seq(a), plan.gather_seq(c)
    cq = rmsnorm(a, p["q_ln"], cfg.norm_eps)
    q = _proj(cq, p["wq_b"])  # (B, S, H, nd + rd)
    q_nope, q_rope = q[..., :nd], apply_rope(q[..., nd:], positions, cfg.rope_theta)
    ckv = rmsnorm(c[..., :kvr], p["kv_ln"], cfg.norm_eps)
    k_rope = apply_rope(c[..., kvr:][:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, ckv, k_rope


def _mla_weights(p, plan):
    """The MLA leaves a rank computes with: under a plan whose heads are
    split (or under ``seq_shard``) each whole leaf, used on the rank's part
    of the work, through ``copy_to``."""
    if plan is None or not (plan.heads or plan.seq_shard):
        return p
    split = ("wq_b", "wkv_b", "wo") if plan.heads else ()
    return {name: t if name in split else plan.copy_to(t) for name, t in p.items()}


def _mla_attend(p, x, cfg: ArchConfig, causal: bool, plan=None):
    """The expanded attention through K3 and its latent cache rows:
    (y (B,S,E), ckv (B,S,KVr), k_rope (B,S,rd)). Under a plan on the
    rank's heads (y the ranks' partial sums added, this rank's positions
    under ``seq_shard``), the latent rows of the whole sequence. ``x``
    reaches only the low-rank ``wq_a`` and ``wkv_a``, which every rank holds
    whole. Under ``seq_shard`` each model rank multiplies its own
    positions and the rows are all-gathered along S (their gradient
    reduce-scattered back); in the serve steps (``plan.cache_seq`` set)
    it multiplies its block of the positions the same way, as the
    reference's GSPMD prefill does, so the products are not repeated on
    every rank. The train step without ``seq_shard`` multiplies them whole
    on every model rank, as the reference's train program does (and where
    S does not split or the heads are whole)."""
    w = _mla_weights(p, plan)
    split = plan is not None and (plan.seq_shard or (plan.heads and plan.cache_seq is not None
                                                     and x.shape[1] % plan.size == 0))
    b, s = x.shape[0], x.shape[1] * (plan.size if plan is not None and plan.seq_shard else 1)
    nd = cfg.qk_nope_dim
    with spans.span("mla"):
        if split:  # x reaches only wq_a and wkv_a: their products on the rank's positions
            xb = x if plan.seq_shard else plan.split_seq(x)
            q_nope, q_rope, ckv, k_rope = _mla_qkv(w, xb, cfg, torch.arange(s, device=x.device),
                                                   plan)
        else:
            xin = plan.copy_to(x) if plan is not None and plan.heads else x
            q_nope, q_rope, ckv, k_rope = _mla_qkv(w, xin, cfg, torch.arange(s, device=x.device))
        kvx = _proj(ckv, w["wkv_b"])  # (B, S, H, nd + vd): the rank's heads
        k_nope, v = kvx[..., :nd], kvx[..., nd:]
        # MHA == GQA with KV == H, G == 1; the rope key copied into every
        # head of one dense k (an expand's zero head stride would cost K3 a copy)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, k_nope.shape[2], -1)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal)
    with spans.span("mla"):
        if plan is None:
            y = torch.matmul(o.transpose(1, 2).flatten(-2), w["wo"].flatten(0, 1))
        else:
            y = _tp_out(w, o.transpose(1, 2), cfg, plan)
    return y, ckv, k_rope


def mla_train(p, x, cfg: ArchConfig, *, causal: bool = True, plan=None):
    """MLA (B, S, E) -> (B, S, E), expanded, through K3 at qk 192 / v 128;
    on the rank's heads under a tensor-parallel ``plan``."""
    return _mla_attend(p, x, cfg, causal, plan)[0]


def mla_prefill(p, x, cfg: ArchConfig, s_max: int, plan=None):
    """The prefill's attention output and its latent decode cache (padded
    to s_max) from one projection: the reference's ``mla_train`` and
    ``mla_prefill_cache``. Under a ``plan`` the cache is this rank's block
    of positions (``plan.cache_seq``)."""
    b, s, _ = x.shape
    y, ckv, k_rope = _mla_attend(p, x, cfg, True, plan)
    ckv_c = ckv.new_zeros((b, s_max, cfg.kv_lora_rank))
    kr_c = k_rope.new_zeros((b, s_max, cfg.qk_rope_dim))
    ckv_c[:, :s] = ckv
    kr_c[:, :s] = k_rope
    if plan is not None and plan.cache_seq is not None:
        a, e, _ = plan.cache_seq
        ckv_c, kr_c = ckv_c[:, a:e].clone(), kr_c[:, a:e].clone()
    return y, {"ckv": ckv_c, "kr": kr_c}


@spans.span("mla")
def mla_decode(p, x, cache: dict, pos: int, cfg: ArchConfig, plan=None):
    """Absorbed one-token decode: scores and output in the latent space, so
    a step reads O(S (KVr + Rr)) of cache, not O(S H Dh). Writes ``ckv``
    and ``kr`` at ``pos`` in place.

    Under a ``plan``, as ``_tp_decode``: the rank's heads' ``q_lat`` and
    ``q_rope`` all-gathered over the heads (a few KB); every head scored
    over the rank's block of the latent cache (``plan.cache_seq``), the new
    position written by the rank whose block holds it; the row maximum,
    the sum of exponentials and the latent output all-reduced
    (flash-decoding's combine); then the rank's heads of ``o_lat`` through
    its ``wkv_b`` v part and the row-parallel ``wo``."""
    b, s1, _ = x.shape
    nd, rd = cfg.qk_nope_dim, cfg.qk_rope_dim
    posv = torch.full((s1,), pos, device=x.device)
    q_nope, q_rope, ckv_new, kr_new = _mla_qkv(p, x, cfg, posv)
    ckv, kr = cache["ckv"], cache["kr"]
    a, e, s_max = plan.cache_seq if plan is not None and plan.cache_seq else (0, ckv.shape[1],
                                                                           ckv.shape[1])
    if a <= pos < e:  # this rank's block holds the new position
        ckv[:, pos - a:pos - a + s1] = ckv_new
        kr[:, pos - a:pos - a + s1] = kr_new
    wkv_k, wkv_v = p["wkv_b"][..., :nd], p["wkv_b"][..., nd:]  # (KVr, H, nd), (KVr, H, vd)
    q_lat = torch.einsum("bqhn,khn->bqhk", q_nope, wkv_k)  # absorb the k expansion
    if plan is not None and plan.heads:
        q_lat, q_rope = plan.all_gather(q_lat, 2), plan.all_gather(q_rope, 2)
    # (B,H,q,KVr) x (B,1,KVr,S) and (B,H,q,rd) x (B,1,rd,S): float32 scores
    sc = torch.matmul(q_lat.transpose(1, 2).float(), ckv.float().transpose(1, 2)[:, None])
    sc = sc + torch.matmul(q_rope.transpose(1, 2).float(), kr.float().transpose(1, 2)[:, None])
    sc = sc / math.sqrt(nd + rd)
    valid = torch.arange(a, a + ckv.shape[1], device=x.device) <= pos
    sc = torch.where(valid, sc, NEG)
    if e - a == s_max:  # the whole cache on this rank: nothing to combine
        probs = torch.softmax(sc, dim=-1).to(ckv.dtype)
        o_lat = torch.matmul(probs, ckv[:, None]).transpose(1, 2)  # (B, q, H, KVr)
    else:
        m = plan.all_reduce(sc.amax(dim=-1, keepdim=True), "max")
        ex = torch.exp(sc - m)
        probs = (ex / plan.all_reduce(ex.sum(dim=-1, keepdim=True))).to(ckv.dtype)
        o_lat = torch.matmul(probs, ckv[:, None])  # this block's share
        o_lat = plan.all_reduce(o_lat.float()).to(ckv.dtype).transpose(1, 2)
    if plan is not None and plan.heads:
        h0, h1, _, _ = plan.head_ranges(cfg.n_heads, cfg.n_kv_heads)
        o_lat = o_lat[:, :, h0:h1]
    out = torch.einsum("bqhk,khv->bqhv", o_lat, wkv_v)
    if plan is None:
        return torch.matmul(out.flatten(-2), p["wo"].flatten(0, 1)), cache
    return _tp_out(p, out, cfg, plan), cache
