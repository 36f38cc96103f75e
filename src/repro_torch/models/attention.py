"""Attention: GQA, train/prefill through K3 and one-token decode.

Port of the GQA half of the JAX package's ``repro/models/attention.py``.
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
the request's state and is never read at an older version.

MLA (``init_mla``, ``mla_*``) comes with a later slice.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import apply_rope, init_dense, pdtype, rmsnorm

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
        p["bq"] = torch.zeros((n_layers, h, dh), dtype=dt, device=device)
        p["bk"] = torch.zeros((n_layers, kv, dh), dtype=dt, device=device)
        p["bv"] = torch.zeros((n_layers, kv, dh), dtype=dt, device=device)
        p["bo"] = torch.zeros((n_layers, e), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((n_layers, dh), dtype=dt, device=device)
        p["k_norm"] = torch.ones((n_layers, dh), dtype=dt, device=device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bse,ehd->bshd") as one matrix product."""
    e = w.shape[0]
    return torch.matmul(x, w.reshape(e, -1)).unflatten(-1, w.shape[1:])


def _proj_qkv(p, x, cfg: ArchConfig):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
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


def _rope_qkv(p, x, cfg: ArchConfig, use_rope: bool):
    q, k, v = _proj_qkv(p, x, cfg)
    if use_rope:
        pos = torch.arange(x.shape[1], device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
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


def gqa_train(p, x, cfg: ArchConfig, *, causal: bool = True, use_rope: bool = True):
    """Self-attention (B, S, E) -> (B, S, E) through K3: the training
    forward's attention. Under autograd K3 also writes its row statistics
    and its gradient is the plain backward (``FlashAttention``)."""
    q, k, v = _rope_qkv(p, x, cfg, use_rope)
    return _attend(p, q, k, v, cfg, causal)


def gqa_prefill(p, x, cfg: ArchConfig, s_max: int, *, use_rope: bool = True):
    """The prefill's attention output and its decode cache (k/v padded to
    s_max) from one projection: the reference's ``gqa_train`` and
    ``gqa_prefill_cache``, which project q/k/v twice to equal results."""
    q, k, v = _rope_qkv(p, x, cfg, use_rope)
    return _attend(p, q, k, v, cfg, True), _cache_from(k, v, x.shape[1], s_max, cfg)


def gqa_decode(p, x, cache: dict, pos: int, cfg: ArchConfig, *, use_rope: bool = True):
    """One-token decode: write the cache at ``pos`` (in place), attend over it.

    Window caches use rolling slots (pos % W); softmax permutation
    invariance makes slot order irrelevant.
    """
    b, s1, _ = x.shape  # s1 == 1
    kv_n, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    dh = cfg.resolved_head_dim
    q, k, v = _proj_qkv(p, x, cfg)
    if use_rope:
        posv = torch.full((s1,), pos, device=x.device)
        q = apply_rope(q, posv, cfg.rope_theta)
        k = apply_rope(k, posv, cfg.rope_theta)
    kc, vc = cache["k"], cache["v"]
    s_max = kc.shape[1]
    windowed = bool(cfg.window) and cfg.window > 0
    slot = (pos % s_max) if windowed else pos
    kc[:, slot:slot + s1] = k
    vc[:, slot:slot + s1] = v
    qg = q.reshape(b, s1, kv_n, g, dh)
    # (B,KV,G,1,Dh) x (B,KV,Dh,S) -> (B,KV,G,1,S) float32 scores
    sc = torch.matmul(qg.permute(0, 2, 3, 1, 4).float(),
                      kc.permute(0, 2, 3, 1).float()[:, :, None]) / math.sqrt(dh)
    idx = torch.arange(s_max, device=x.device)
    valid = (idx <= pos) if not windowed else ((idx <= pos) | (pos >= s_max))
    sc = torch.where(valid, sc, NEG)
    probs = torch.softmax(sc, dim=-1).to(vc.dtype)
    out = torch.matmul(probs, vc.permute(0, 2, 1, 3)[:, :, None])  # (B,KV,G,1,Dh)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s1, cfg.n_heads, dh)
    return _out(p, out, cfg), cache
