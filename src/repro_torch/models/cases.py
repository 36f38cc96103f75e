"""One dense deepseek-v3 layer on a device against the port's float32 CPU
path, at full width.

The layer is the MLA mixer and the SwiGLU FFN, random weights from a seed,
rounded to bf16 so that both devices start from the same values. It runs a
prefill over ``tokens`` tokens and one absorbed decode step after it; the
outputs and the latent cache (``ckv``, ``kr``) are compared. The CPU path is
what ``tests/test_torch_mla.py`` holds against the JAX package;
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the card to it with
:func:`check_mla_layer_on_device`.
"""

from __future__ import annotations

import time

import torch

# of each output's largest magnitude: bf16 products and sums on the device
# (K3's tensor-core kernel at qk 192 / v 128); float32 (its CUDA-core
# kernel, TF32 off), sums in another order
MLA_LAYER_TOLS = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def check_mla_layer_on_device(dev, cfg, tokens: int, seed: int = 20) -> dict:
    """The layer of ``cfg`` (an MLA config) in bf16 and in float32 on
    ``dev`` against float32 on the CPU; raises ``AssertionError`` where a
    result is not finite, has another shape, exceeds its tolerance
    (:data:`MLA_LAYER_TOLS`), or where the bf16 prefill did not run K3's
    tensor-core kernel once (and float32's did). Returns each result's
    error and largest magnitude, and the CPU path's seconds."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tf
    from repro_torch.utils import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(seed)
    layer = {"ln1": torch.ones(cfg.d_model),
             "attn": tf._layer(attn.init_mla(gen, cfg, 1, "cpu"), 0),
             "ln2": torch.ones(cfg.d_model),
             "ffn": tf._layer(tf._init_ffn(gen, cfg, 1, "dense", "cpu"), 0)}
    layer = tree_map(lambda t: t.to(torch.bfloat16), layer)
    x = torch.randn((1, tokens, cfg.d_model), generator=gen).to(torch.bfloat16)
    step = torch.randn((1, 1, cfg.d_model), generator=gen).to(torch.bfloat16)

    def run(dtype, device):
        c = cfg.with_(dtype=str(dtype).removeprefix("torch."))
        pl = tree_map(lambda t: t.to(device, dtype), layer)
        y, cache = tf.block_prefill(pl, x.to(device, dtype), c, "mla", "dense", 0, tokens + 1)
        ys, cache = tf.block_decode(pl, step.to(device, dtype), cache, tokens, c, "mla",
                                    "dense", 0)
        return {"out": y, "decode_out": ys, **cache}

    t0 = time.perf_counter()
    want = run(torch.float32, "cpu")
    out = {"tokens": tokens, "cpu_s": time.perf_counter() - t0}
    for dtype, tol in MLA_LAYER_TOLS.items():
        label = str(dtype).removeprefix("torch.")
        before = flash_attention.wgmma_launches
        got = run(dtype, dev)
        wgmma = flash_attention.wgmma_launches - before
        if wgmma != (dtype == torch.bfloat16):
            raise AssertionError(f"{label}: {wgmma} tensor-core K3 launches")
        res = {"tol": f"{tol} of the max"}
        for key, w in want.items():
            g = got[key].float().cpu()
            if g.shape != w.shape or not torch.isfinite(g).all():
                raise AssertionError(f"{label} {key}: shape {tuple(g.shape)} or not finite")
            err, scale = float((g - w).abs().max()), float(w.abs().max())
            if err > tol * scale:
                raise AssertionError(f"{label} {key}: {err} > {tol} of {scale}")
            res[key] = {"max_abs_err": err, "max_abs": scale}
        out[label] = res
    return out
