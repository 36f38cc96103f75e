"""K3 on a tensor-parallel rank's q heads, on the card.

A rank of the model axis calls K3 on its own q heads ``[h0, h1)`` and
the kv heads they read (``distributed/tp.py``'s ``Plan.head_ranges``):
its block of them where the kv heads are split, else the view ``[h0 // G,
(h1 - 1) // G + 1)`` of the whole (B, S, KV, D) projection, read through
its strides (a view the tensor-core kernel's TMA takes without a copy
where its strides are whole 16-byte units). :func:`check_head_slices`
holds each rank's call bitwise against the same heads of one call over
every head. ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` run it.
"""

from __future__ import annotations

import torch

# (batch, q heads, kv heads, q positions, k positions, qk head dim, v head
# dim, causal, window, model ranks): qwen3-1.7b's serve prefill on a 16-way
# model axis (1 q head a rank, G 2: one kv head of the whole projection),
# command-r-plus-104b's (6 q heads a rank, G 12), deepseek-v3's MLA (8 of
# 128 heads a rank, qk 192 / v 128, the kv heads split with the q heads),
# hymba-1.5b's windowed attention on 5 ranks (5 q heads and its 1 kv head
# a rank, window 2048) and whisper-tiny's cross attention on 2 (3 heads a
# rank, 4,096 decoder positions against 1,500 encoder frames, non-causal)
HEAD_SLICE_CASES = {
    "qwen3_serve_16": (1, 16, 8, 2048, 2048, 128, 128, True, 0, 16),
    "command_r_16": (2, 96, 8, 2048, 2048, 128, 128, True, 0, 16),
    "deepseek_mla_16": (1, 128, 128, 2048, 2048, 192, 128, True, 0, 16),
    "hymba_window_5": (1, 25, 5, 4096, 4096, 64, 64, True, 2048, 5),
    "whisper_cross_2": (1, 6, 6, 4096, 1500, 64, 64, False, 0, 2),
}


def check_head_slices(dev, b: int, h: int, hkv: int, sq: int, sk: int, d: int, dv: int,
                      causal: bool, window: int, ranks: int, seed: int = 0) -> dict:
    """bf16 K3 (causal or not, windowed where ``window``) over every head
    of (B, Sq, H, D) q, (B, Sk, KV, D) k and (B, Sk, KV, Dv) v (the model's
    layouts), then each of ``ranks`` ranks' call on its q heads (a
    contiguous tensor, as its own projection is) and its block (where the
    kv heads split) or view of k/v: ``bitwise`` when every rank's output
    equals its heads of the whole call bit for bit; ``views_taken_as_is``
    when the TMA read every view without a copy; the tensor-core launches
    of the rank calls."""
    from repro_torch.distributed.tp import Plan
    from repro_torch.kernels.flash_attention.ops import _tma_ready, flash_attention

    gen = torch.Generator(dev).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
               for shape in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, dv)))
    whole = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            causal=causal, window=window)
    bitwise, as_is, ranges = True, True, []
    before = flash_attention.wgmma_launches
    for r in range(ranks):
        plan = Plan(group=None, size=ranks, rank=r, vocab=False, heads=True,
                    kv_heads=hkv % ranks == 0, mlp=False)
        h0, h1, k0, k1 = plan.head_ranges(h, hkv)
        kv0, kv1 = (0, k1 - k0) if plan.kv_heads else (k0, k1)  # a split block is local
        qs = q[:, :, h0:h1].contiguous().transpose(1, 2)
        ks = (k[:, :, k0:k1].contiguous() if plan.kv_heads else k[:, :, kv0:kv1]).transpose(1, 2)
        vs = (v[:, :, k0:k1].contiguous() if plan.kv_heads else v[:, :, kv0:kv1]).transpose(1, 2)
        as_is &= all(_tma_ready(t) is t for t in (qs, ks, vs))
        got = flash_attention(qs, ks, vs, causal=causal, window=window)
        bitwise &= torch.equal(got, whole[:, h0:h1])
        ranges.append((h0, h1, k0, k1))
    torch.cuda.synchronize(dev)
    return {"shape": f"q bf16[{b},{h},{sq},{d}] k bf16[{b},{hkv},{sk},{d}] v bf16[{b},{hkv},"
                     f"{sk},{dv}] " + ("causal" if causal else "non-causal")
                     + (f", window {window}" if window else "")
                     + f", {ranks} ranks of [{b},{h // ranks},{sq},{d}]",
            "first_rank_heads": ranges[0], "bitwise": bool(bitwise),
            "views_taken_as_is": bool(as_is),
            "rank_wgmma_launches": flash_attention.wgmma_launches - before}
