"""The benchmark's yardstick: peaks, work counts and model FLOPs.

Copies of the program's own arithmetic, kept here so that the yardstick
does not move when the program does (``test_navbench_yardstick.py`` holds
each copy equal to the function it was copied from):

* ``visible_pairs``: ``repro_torch.kernels.flash_attention.ops``;
* ``k3_work``: ``chip_smoke.k3_work`` (K3's forward: 2 (D + Dv) a visible
  pair and head, q, k, v read and the output written once);
* ``causal_pairs``, ``token_params``, ``attention_pair_flops``,
  ``recurrence_flops``, ``step_flops``: ``repro_torch.launch.train``.

``k3_bwd_work`` and ``prefill_flops`` are the benchmark's own. Every
function takes the configuration file's numbers (a dict), not the
program's config object.
"""

from __future__ import annotations

import numpy as np

BF16_PEAK_FLOPS = 989e12  # NVIDIA H100 SXM, dense bf16
HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM


def head_dim(cfg: dict) -> int:
    return cfg["head_dim"] or cfg["d_model"] // cfg["n_heads"]


def visible_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """The (q, k) pairs the mask keeps (query i and key j both counted from
    0): the work K3 must do for one batch row and head."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, sk - 1) if causal else np.full(sq, sk - 1, np.int64)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations or bytes at peak."""
    return max(flops / BF16_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)


def k3_work(b: int, h: int, hkv: int, sq: int, sk: int, d: int, dv: int, causal: bool,
            window: int, element_size: int = 2) -> dict:
    """K3's forward at a shape: visible pairs, the operations the function
    needs (2 (D + Dv) a pair and head), the bytes it must move (q, k, v read
    once, the output written once) and the card's bound in seconds."""
    pairs = visible_pairs(sq, sk, causal, window)
    flops = 2 * b * h * (d + dv) * pairs
    nbytes = (b * h * sq * (d + dv) + b * hkv * sk * (d + dv)) * element_size
    return {"visible_pairs": pairs, "flops": flops, "bytes": nbytes,
            "bound_s": bound_s(flops, nbytes)}


def k3_bwd_work(b: int, h: int, hkv: int, sq: int, sk: int, d: int, dv: int, causal: bool,
                window: int, element_size: int = 2) -> dict:
    """K3's backward at a shape: 2 (3 D + 2 Dv) operations a visible pair and
    head (the recomputed scores QK^T, dV += P^T dO, dP = dO V^T, dQ += dS K,
    dK += dS^T Q), the bytes it must move (q, k, v, o, dO and the float32
    row statistics read once, dQ, dK, dV written once) and the bound."""
    pairs = visible_pairs(sq, sk, causal, window)
    flops = 2 * b * h * (3 * d + 2 * dv) * pairs
    q_side = b * h * sq * (2 * d + 2 * dv)  # q, dQ; o, dO
    kv_side = b * hkv * sk * (2 * d + 2 * dv)  # k, dK; v, dV
    nbytes = (q_side + kv_side) * element_size + b * h * sq * 4
    return {"visible_pairs": pairs, "flops": flops, "bytes": nbytes,
            "bound_s": bound_s(flops, nbytes)}


def causal_pairs(seq_len: int, window: int = 0) -> int:
    """(q, k) pairs a causal mask keeps over ``seq_len`` positions, within
    a sliding ``window`` when one is set."""
    if not window or window >= seq_len:
        return seq_len * (seq_len + 1) // 2
    return window * (window + 1) // 2 + (seq_len - window) * window


def param_count(cfg: dict) -> int:
    """The analytic parameter count (embeddings and blocks) of a decoder-only
    configuration with GQA attention, an optional parallel SSD branch and a
    dense or MoE SwiGLU FFN (``ArchConfig.param_count``'s cases for them)."""
    e, v, h = cfg["d_model"], cfg["vocab"], head_dim(cfg)
    n_emb = v * e * (1 if cfg["tie_embeddings"] else 2)
    per_layer = e * cfg["n_heads"] * h + 2 * e * cfg["n_kv_heads"] * h + cfg["n_heads"] * h * e
    if cfg.get("ssm"):
        per_layer += e * cfg["n_heads"] * h
        per_layer += 2 * e * cfg["n_heads"] * cfg["ssm_state"] + e * cfg["n_heads"]
        per_layer += cfg["n_heads"] * h * e
    if cfg.get("moe"):
        f = cfg["moe_d_ff"] or cfg["d_ff"]
        ffn = 3 * e * f * cfg["n_experts"] + e * cfg["n_experts"]
    else:
        ffn = 3 * e * cfg["d_ff"]
    return int(n_emb + cfg["n_layers"] * (per_layer + ffn))


def token_params(cfg: dict) -> int:
    """Parameters one token multiplies: a MoE layer's top-k experts, not all
    of them (``ArchConfig.active_param_count``)."""
    n = param_count(cfg)
    if cfg.get("moe"):
        f = cfg["moe_d_ff"] or cfg["d_ff"]
        n -= cfg["n_layers"] * 3 * cfg["d_model"] * f * (cfg["n_experts"] - cfg["top_k"])
    return int(n)


def attention_pair_flops(cfg: dict) -> int:
    """Forward FLOPs of softmax attention a visible (q, k) pair, all heads."""
    return 4 * cfg["n_heads"] * head_dim(cfg)


def recurrence_flops(cfg: dict, batch: int, seq_len: int) -> int:
    """Forward FLOPs of one layer's chunked linear recurrence (the SSD), 0
    without one: per token and head, over chunks of Q (the sequence padded
    to whole chunks), the QxQ tile's scores (2 Q N) and outputs (2 Q P) and
    the NxP state terms (2 N P, twice)."""
    if not cfg.get("ssm"):
        return 0
    n, p = cfg["ssm_state"], head_dim(cfg)
    q = min(cfg["chunk"], seq_len)
    tokens = batch * -(-seq_len // q) * q
    return 2 * tokens * cfg["n_heads"] * (q * (n + p) + 2 * n * p)


def step_flops(cfg: dict, batch: int, seq_len: int) -> int:
    """Model FLOPs of one training step: 6 N T plus, in every layer, three
    times each mixer's own products (attention's within its window, the
    recurrence's). Recomputed operations are not counted."""
    per_layer = 3 * recurrence_flops(cfg, batch, seq_len)
    per_layer += 3 * batch * attention_pair_flops(cfg) * causal_pairs(seq_len, cfg["window"])
    return 6 * token_params(cfg) * batch * seq_len + per_layer * cfg["n_layers"]


def prefill_flops(cfg: dict, prompt_len: int) -> int:
    """Model FLOPs of one B = 1 prefill: 2 N P over the parameters a token
    multiplies less the embedding tables (a lookup, no product), the
    last position's logits (2 V E), and every layer's attention within its
    window and recurrence, forward only."""
    n_emb = cfg["vocab"] * cfg["d_model"] * (1 if cfg["tie_embeddings"] else 2)
    dense = 2 * (token_params(cfg) - n_emb) * prompt_len + 2 * cfg["vocab"] * cfg["d_model"]
    per_layer = (attention_pair_flops(cfg) * causal_pairs(prompt_len, cfg["window"])
                 + recurrence_flops(cfg, 1, prompt_len))
    return int(dense + per_layer * cfg["n_layers"])
