"""Encoder-decoder backbone (whisper-style): LayerNorm + GELU MLP + biases,
learned positions, bidirectional encoder, causal decoder with cross-attention.

Port of the JAX package's ``repro/models/encdec.py``. The conv frontend is
a stub: the encoder consumes precomputed frame embeddings (B, enc_seq, E)
(``data.pipeline``'s ``enc_frames``). The decoder's learned position table
has ``MAX_DEC_POS`` rows, the reference's.

Every attention of the training forward and the prefill goes through K3
(``attention.gqa_train`` with no RoPE): the encoder's self-attention
non-causal over the frames, the decoder's causal self-attention, and its
cross-attention non-causal with k/v from the encoder's output (Sq != Sk).
Each layer of the training forward runs under ``torch.utils.checkpoint``,
as the reference's under ``jax.checkpoint``, so its backward recomputes
the layer. The decode step's self and cross attention stay plain PyTorch,
as the reference's are; self k/v are written in place at ``pos``.

Parameters are the reference's tree: ``embed`` (tied), ``pos_enc``,
``pos_dec``, ``enc/{ln1_s, ln1_b, attn/{wq, wk, wv, wo, bq, bk, bv, bo},
ln2_s, ln2_b, mlp/{w_in, b_in, w_out, b_out}}``, ``enc_final_s/_b``,
``dec/{ln1_*, self_attn, lnx_*, cross_attn, ln2_*, mlp}``, ``final_s/_b``,
stacked on L. The decode caches are one flat dict, ``{"k", "v"}: (L, B,
S, KV, Dh)`` and the cross k/v ``{"xk", "xv"}: (L, B, enc_seq, KV, Dh)``.

Under a tensor-parallel plan (``distributed/tp.py``) every attention runs
on the rank's heads (the cross attention's k/v from the encoder's output,
which every model rank holds whole) and both MLPs on its hidden units
(``layers.gelu_mlp``), each output's partial sums added and its bias
added once after; the layernorms, the position tables and the encoder's
output are whole. The prefill keeps the rank's block of positions of the
self and cross caches (``plan.cache_seq``, ``plan.cross_seq``) with every
kv head, and decode attends over each block where it lies, combined over
the model axis. The reference constrains nothing here, so ``seq_shard``
changes nothing (``tp.plan_for`` drops it).
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (embed, gelu_mlp, init_const, init_dense, init_embedding,
                                        layernorm, pdtype, with_axes)
from repro_torch.models.transformer import _layer, _unbind_layers

MAX_DEC_POS = 32768  # the reference's decoder position table


def _table(gen, shape, dt, device) -> torch.Tensor:
    """A learned position table: normal times 0.01, drawn in float32."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    if w.device.type != "meta":
        w.normal_(0.0, 1.0, generator=gen).mul_(0.01)
    return with_axes(w.to(dt), (None, "embed"))


def _init_ln(n: int, e: int, dt, name: str, p: dict, device) -> None:
    p[f"{name}_s"] = init_const((n, e), 1.0, ("layers", "embed"), dt, device)
    p[f"{name}_b"] = init_const((n, e), 0.0, ("layers", "embed"), dt, device)


def _init_mlp(gen, cfg: ArchConfig, n: int, device) -> dict:
    e, f, dt = cfg.d_model, cfg.d_ff, pdtype(cfg)
    p = {"w_in": init_dense(gen, (n, e, f), ("layers", "embed", "mlp"), dt, device),
         "b_in": init_const((n, f), 0.0, ("layers", "mlp"), dt, device)}
    p["w_out"] = init_dense(gen, (n, f, e), ("layers", "mlp", "embed"), dt, device)
    p["b_out"] = init_const((n, e), 0.0, ("layers", "embed"), dt, device)
    return p


def init_encdec(gen: torch.Generator | None, cfg: ArchConfig, device) -> dict[str, Any]:
    """The parameter tree, weights drawn from ``gen`` in the reference's
    order; on the ``meta`` device only shapes and dtypes are made."""
    dt, e = pdtype(cfg), cfg.d_model
    params: dict[str, Any] = {"embed": init_embedding(gen, cfg, device)}
    params["pos_enc"] = _table(gen, (cfg.enc_seq, e), dt, device)
    params["pos_dec"] = _table(gen, (MAX_DEC_POS, e), dt, device)
    enc: dict[str, Any] = {}
    _init_ln(cfg.enc_layers, e, dt, "ln1", enc, device)
    enc["attn"] = attn.init_gqa(gen, cfg, cfg.enc_layers, device)
    _init_ln(cfg.enc_layers, e, dt, "ln2", enc, device)
    enc["mlp"] = _init_mlp(gen, cfg, cfg.enc_layers, device)
    params["enc"] = enc
    params["enc_final_s"] = init_const((e,), 1.0, ("embed",), dt, device)
    params["enc_final_b"] = init_const((e,), 0.0, ("embed",), dt, device)
    dec: dict[str, Any] = {}
    _init_ln(cfg.n_layers, e, dt, "ln1", dec, device)
    dec["self_attn"] = attn.init_gqa(gen, cfg, cfg.n_layers, device)
    _init_ln(cfg.n_layers, e, dt, "lnx", dec, device)
    dec["cross_attn"] = attn.init_gqa(gen, cfg, cfg.n_layers, device)
    _init_ln(cfg.n_layers, e, dt, "ln2", dec, device)
    dec["mlp"] = _init_mlp(gen, cfg, cfg.n_layers, device)
    params["dec"] = dec
    params["final_s"] = init_const((e,), 1.0, ("embed",), dt, device)
    params["final_b"] = init_const((e,), 0.0, ("embed",), dt, device)
    return params


def _mlp(pl, x, plan=None):
    m = pl["mlp"]
    return gelu_mlp(x, m["w_in"], m["b_in"], m["w_out"], m["b_out"], plan)


def _layers(fn, h, stacked: dict, n: int, *extra):
    """``h`` through ``fn(layer_params, h, *extra)`` for each of ``n``
    stacked layers, each under ``torch.utils.checkpoint`` where autograd
    records (the reference's per-layer ``jax.checkpoint``)."""
    remat = torch.is_grad_enabled()
    for pl in _unbind_layers(stacked, n):
        h = checkpoint(fn, pl, h, *extra, use_reentrant=False) if remat else fn(pl, h, *extra)
    return h


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def _enc_block(pl, h, cfg: ArchConfig, plan=None):
    eps = cfg.norm_eps
    a_in = layernorm(h, pl["ln1_s"], pl["ln1_b"], eps)
    h = h + attn.gqa_train(pl["attn"], a_in, cfg, causal=False, use_rope=False, plan=plan)
    return h + _mlp(pl, layernorm(h, pl["ln2_s"], pl["ln2_b"], eps), plan)


def encode(params, frames: torch.Tensor, cfg: ArchConfig, plan=None) -> torch.Tensor:
    """frames: (B, T_enc, E) stub embeddings -> encoder states (whole on
    every model rank under a plan)."""
    x = frames + params["pos_enc"][None, :frames.shape[1]]
    x = _layers(lambda pl, h: _enc_block(pl, h, cfg, plan), x, params["enc"], cfg.enc_layers)
    return layernorm(x, params["enc_final_s"], params["enc_final_b"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


def _embed_dec(params, tokens: torch.Tensor, plan=None) -> torch.Tensor:
    return embed(tokens, params["embed"], plan) + params["pos_dec"][None, :tokens.shape[1]]


def _cross_cache(pl, enc_out: torch.Tensor, cfg: ArchConfig, plan=None) -> dict:
    """The cross-attention's k/v of the encoder's output: (B, T_enc, KV,
    Dh); under a plan this rank's block of the frames (``plan.cross_seq``)
    with every kv head, from the kv heads the rank projects."""
    p = attn._tp_weights(pl["cross_attn"], cfg, plan) if plan is not None else pl["cross_attn"]
    k, v = attn._proj(enc_out, p["wk"]), attn._proj(enc_out, p["wv"])
    if cfg.attn_bias:
        k, v = k + p["bk"], v + p["bv"]
    if plan is not None:
        k, v = (attn.cache_block(c, cfg, plan, plan.cross_seq) for c in (k, v))
    return {"xk": k, "xv": v}


def _dec_block(pl, h, enc_out, cfg: ArchConfig, s_max: int = 0, plan=None):
    """One decoder layer of the training forward (``s_max`` 0) or of the
    prefill, which also returns the layer's decode cache {k, v, xk, xv}
    (self k/v padded to ``s_max``) from the same projections."""
    eps = cfg.norm_eps
    a_in = layernorm(h, pl["ln1_s"], pl["ln1_b"], eps)
    cache = None
    if s_max:
        y, cache = attn.gqa_prefill(pl["self_attn"], a_in, cfg, s_max, use_rope=False, plan=plan)
    else:
        y = attn.gqa_train(pl["self_attn"], a_in, cfg, causal=True, use_rope=False, plan=plan)
    h = h + y
    x_in = layernorm(h, pl["lnx_s"], pl["lnx_b"], eps)
    h = h + attn.gqa_train(pl["cross_attn"], x_in, cfg, causal=False, use_rope=False,
                           kv_source=enc_out, plan=plan)
    h = h + _mlp(pl, layernorm(h, pl["ln2_s"], pl["ln2_b"], eps), plan)
    if s_max:
        cache = {**cache, **_cross_cache(pl, enc_out, cfg, plan)}
    return h, cache


def decode_train(params, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ArchConfig, plan=None) -> torch.Tensor:
    x = _embed_dec(params, tokens, plan)
    x = _layers(lambda pl, h, e: _dec_block(pl, h, e, cfg, plan=plan)[0], x, params["dec"],
                cfg.n_layers, enc_out)
    return layernorm(x, params["final_s"], params["final_b"], cfg.norm_eps)


def prefill(params, tokens, enc_out, cfg: ArchConfig, s_max: int, plan=None):
    """Returns (hidden, caches): self k/v (padded to s_max) + cross k/v,
    stacked on L."""
    x = _embed_dec(params, tokens, plan)
    layer_caches = []
    for pl in _unbind_layers(params["dec"], cfg.n_layers):
        x, cache = _dec_block(pl, x, enc_out, cfg, s_max, plan)
        layer_caches.append(cache)
    caches = {key: torch.stack([c[key] for c in layer_caches]) for key in ("k", "v", "xk", "xv")}
    return layernorm(x, params["final_s"], params["final_b"], cfg.norm_eps), caches


def _cross_decode(pl, x, cache, cfg: ArchConfig, plan=None):
    """One token's cross-attention over the cached encoder k/v, plain
    PyTorch: float32 scores, the probabilities rounded to v's dtype. Under
    a plan, as the self-attention's decode (``attention._tp_decode``): the
    rank's q heads all-gathered, every head scored over the rank's block
    of the frames (``plan.cross_seq``), which it only reads, combined over
    the model axis; then the rank's heads through ``wo``, ``bo`` once."""
    p = pl["cross_attn"]
    q = attn._proj(x, p["wq"])
    if cfg.attn_bias:
        q = q + p["bq"]
    if plan is not None and plan.heads:
        q = plan.all_gather(q, 2)
    xk, xv = cache["xk"], cache["xv"]
    a, e, n = (plan.cross_seq if plan is not None and plan.cross_seq
               else (0, xk.shape[1], xk.shape[1]))
    out = attn.decode_heads(attn.attend_block(attn.decode_scores(q, xk, cfg), xv, plan,
                                              e - a == n), cfg)
    if plan is None:
        return attn._out(p, out, cfg)
    h0, h1, _, _ = plan.head_ranges(cfg.n_heads, cfg.n_kv_heads)
    return attn._tp_out(p, out[:, :, h0:h1], cfg, plan)


def decode_step(params, x, caches, pos: int, cfg: ArchConfig, plan=None):
    """x: (B, 1, E) embedded token (+ its position). Returns (hidden, the
    caches with self k/v written at ``pos`` in place)."""
    eps = cfg.norm_eps
    for i, pl in enumerate(_unbind_layers(params["dec"], cfg.n_layers)):
        cache = _layer(caches, i)
        a_in = layernorm(x, pl["ln1_s"], pl["ln1_b"], eps)
        y, _ = attn.gqa_decode(pl["self_attn"], a_in, {"k": cache["k"], "v": cache["v"]}, pos,
                               cfg, use_rope=False, plan=plan)
        x = x + y
        x = x + _cross_decode(pl, layernorm(x, pl["lnx_s"], pl["lnx_b"], eps), cache, cfg, plan)
        x = x + _mlp(pl, layernorm(x, pl["ln2_s"], pl["ln2_b"], eps), plan)
    return layernorm(x, params["final_s"], params["final_b"], cfg.norm_eps), caches
