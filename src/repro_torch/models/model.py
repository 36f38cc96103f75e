"""Model facade: GQA and MLA (dense or MoE FFN), the hybrid (attention ‖
SSD, hymba), the mLSTM (xLSTM) and the encoder-decoder (whisper).

Port of the JAX package's ``repro/models/model.py``::

    model = Model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0))
    loss = model.loss(params, batch)                        # 0-d float32
    logits, caches = model.prefill(params, batch, s_max)    # (B, V) float32
    logits, caches = model.decode(params, caches, tok, pos) # (B, 1, V) float32
    caches = model.init_cache(batch, s_ctx, device)         # zeros

Parameters are a plain nested dict with the reference's paths and shapes
(``embed``, ``final_norm``, ``blocks/g0/{ln1, ln2, attn/{wq, wk, wv, wo,
q_norm, k_norm}, ffn/{wg, wu, wd}}``, stacked on L; a MoE group's ``ffn``
is ``{w_router (float32), [router_bias], wg, wu, wd, [ws_g, ws_u, ws_d]}``;
a hybrid block adds ``ssd/{wx, wB, wC, w_dt, dt_bias, A_log, D, wo}``; an
mLSTM block is ``{ln1, mlstm/{wq, wk, wv, w_i, w_f, f_bias, w_og, ln_out,
wo}}`` with no FFN; an MLA block's ``attn`` is ``{wq_a, q_ln, wq_b, wkv_a,
kv_ln, wkv_b, wo}``; the encoder-decoder's tree is ``models/encdec.py``'s),
and the caches are the reference's per layer group: ``{"k", "v"}: (L, B,
S, KV, Dh)`` for GQA, ``{"ckv": (L, B, S, KVr), "kr": (L, B, S, Rr)}`` for
MLA (never windowed), ``{"attn": {"k", "v"}, "ssd":
(L, B, H, N, Dh) float32}`` for the hybrid, ``{"mlstm": (L, B, H, Dh, Dh +
1) float32}`` for the mLSTM, and for the encoder-decoder one flat ``{"k",
"v", "xk", "xv"}`` (the cross k/v over the encoder's frames), so the serve
CMI of a request published by one package resumes in the other.
:func:`params_from_numpy` carries the JAX package's parameters across. :func:`input_specs` gives the
inputs of a shape as :class:`TensorSpec` stand-ins (the reference's
``ShapeDtypeStruct``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (embed, pdtype, recording_axes, softmax_xent_chunked,
                                        unembed_logits)
from repro_torch.utils import flatten_with_paths, numpy_to_tensor


@dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a tensor that is not made (the reference's
    ``jax.ShapeDtypeStruct``)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


class Model:
    def __init__(self, cfg: ArchConfig):
        tf.check_supported(cfg)
        self.cfg = cfg

    # -- init ---------------------------------------------------------------
    def init(self, gen: torch.Generator) -> dict[str, Any]:
        """Parameters on ``gen``'s device, drawn from ``gen``."""
        return self._init(gen, gen.device)

    def _init(self, gen, device):
        if self.cfg.encdec:
            return encdec_mod.init_encdec(gen, self.cfg, device)
        return tf.init_lm(gen, self.cfg, device)

    def param_specs(self) -> dict[str, Any]:
        """The parameter tree's shapes and dtypes, nothing allocated."""
        meta = self._init(None, "meta")
        flat, treedef = flatten_with_paths(meta)
        return treedef.unflatten({k: TensorSpec(tuple(v.shape), v.dtype) for k, v in flat.items()})

    def param_axes(self) -> dict[str, Any]:
        """The parameters' logical-axes tree (a tuple of axis names a leaf;
        the reference's ``Model.init`` second output), nothing allocated:
        each init records the axes it is given."""
        with recording_axes() as rec:
            meta = self._init(None, "meta")
        flat, treedef = flatten_with_paths(meta)
        missing = [k for k, v in flat.items() if id(v) not in rec]
        if missing:
            raise KeyError(f"parameters made without logical axes: {missing}")
        return treedef.unflatten({k: rec[id(v)] for k, v in flat.items()})

    def selection_only_paths(self) -> set[str]:
        """Flat paths of the parameters the loss reaches only through a
        selection, so their gradient is zero (``jax.grad`` gives zeros): a
        sigmoid router's bias, which picks each token's top-k experts and
        weights none of them."""
        if self.cfg.encdec or self.cfg.router_type != "sigmoid":
            return set()
        return {f"blocks/{g}/ffn/router_bias" for g, _, _, ffn in tf.block_groups(self.cfg)
                if ffn == "moe"}

    def _unembed(self, params):
        return params["embed"] if self.cfg.tie_embeddings else params["unembed"]

    def _embed_inputs(self, params, batch, plan=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (x (B, S_tot, E), labels (B, S_tot)): the vision prefix's
        patch embeddings go before the tokens, labelled -1 so the loss
        skips them. Under a plan every model rank holds the whole sequence
        (the embedding's vocab-parallel lookups added)."""
        cfg = self.cfg
        x = embed(batch["tokens"], params["embed"], plan).to(pdtype(cfg))
        labels = batch["labels"]
        if cfg.vision_prefix:
            vis = batch["vis_embeds"].to(x.dtype)  # (B, P, E) stub frontend
            x = torch.cat([vis, x], dim=1)
            labels = torch.cat([labels.new_full(vis.shape[:2], -1), labels], dim=1)
        return x, labels

    # -- train --------------------------------------------------------------
    def loss(self, params, batch, *, n_groups: int = 0, plan=None) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch`` ({"tokens", "labels"},
        (B, S) int; label -1 ignored; the encoder-decoder's also
        "enc_frames" (B, enc_seq, E), the vision prefix's "vis_embeds" (B,
        P, E)), a 0-d float32 tensor. ``n_groups``:
        MoE routing groups (0: one per sequence). ``plan``: the
        tensor-parallel plan of a sharded step (``distributed/tp.py``), or
        ``None``, the model's plain code; the serve methods take it too."""
        cfg = self.cfg
        if cfg.encdec:
            enc_out = encdec_mod.encode(params, batch["enc_frames"].to(pdtype(cfg)), cfg, plan)
            h = encdec_mod.decode_train(params, batch["tokens"], enc_out, cfg, plan)
            return softmax_xent_chunked(h, self._unembed(params), batch["labels"], cfg.loss_chunk,
                                        plan)
        x, labels = self._embed_inputs(params, batch, plan)
        h = tf.forward_train(params, x, cfg, n_groups=n_groups, plan=plan)
        return softmax_xent_chunked(h, self._unembed(params), labels, cfg.loss_chunk, plan)

    # -- serve --------------------------------------------------------------
    def prefill(self, params, batch, s_max: int, *, n_groups: int = 0, plan=None):
        """Returns (last-position logits (B, V) float32, caches)."""
        cfg = self.cfg
        if cfg.encdec:
            enc_out = encdec_mod.encode(params, batch["enc_frames"].to(pdtype(cfg)), cfg, plan)
            h, caches = encdec_mod.prefill(params, batch["tokens"], enc_out, cfg, s_max, plan)
        else:
            x = embed(batch["tokens"], params["embed"], plan).to(pdtype(cfg))
            if cfg.vision_prefix:  # the cache holds P + S positions
                x = torch.cat([batch["vis_embeds"].to(x.dtype), x], dim=1)
            h, caches = tf.forward_prefill(params, x, cfg, s_max, n_groups=n_groups, plan=plan)
        return unembed_logits(h[:, -1], self._unembed(params), plan), caches

    def decode(self, params, caches, tokens, pos: int, *, n_groups: int = 0, plan=None):
        """One decode step. tokens (B, 1) int; pos the absolute position.
        The caches are written in place and returned."""
        x = embed(tokens, params["embed"], plan).to(pdtype(self.cfg))
        if self.cfg.encdec:
            x = x + params["pos_dec"][int(pos)][None]
            h, caches = encdec_mod.decode_step(params, x, caches, int(pos), self.cfg, plan)
        else:
            h, caches = tf.forward_decode(params, x, caches, int(pos), self.cfg,
                                          n_groups=n_groups, plan=plan)
        return unembed_logits(h, self._unembed(params), plan), caches

    # -- caches ---------------------------------------------------------------
    def cache_struct(self, batch: int, s_ctx: int) -> dict[str, Any]:
        """TensorSpec tree of the decode caches (also used to zero-init)."""
        cfg = self.cfg
        dt = pdtype(cfg)
        kv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
        s_kv = min(s_ctx, cfg.window) if cfg.window else s_ctx
        f32 = torch.float32
        if cfg.encdec:
            n, cross = cfg.n_layers, (cfg.n_layers, batch, cfg.enc_seq, kv, dh)
            return {"k": TensorSpec((n, batch, s_kv, kv, dh), dt),
                    "v": TensorSpec((n, batch, s_kv, kv, dh), dt),
                    "xk": TensorSpec(cross, dt), "xv": TensorSpec(cross, dt)}
        out = {}
        for gname, n, mixer, _ in tf.block_groups(cfg):
            kv_cache = {"k": TensorSpec((n, batch, s_kv, kv, dh), dt),
                        "v": TensorSpec((n, batch, s_kv, kv, dh), dt)}
            if mixer == "gqa":
                out[gname] = kv_cache
            elif mixer == "mla":
                out[gname] = {"ckv": TensorSpec((n, batch, s_ctx, cfg.kv_lora_rank), dt),
                              "kr": TensorSpec((n, batch, s_ctx, cfg.qk_rope_dim), dt)}
            elif mixer == "hybrid":
                out[gname] = {"attn": kv_cache,
                              "ssd": TensorSpec((n, batch, cfg.n_heads, cfg.ssm_state, dh), f32)}
            else:
                out[gname] = {"mlstm": TensorSpec((n, batch, cfg.n_heads, dh, dh + 1), f32)}
        return out

    def init_cache(self, batch: int, s_ctx: int, device) -> dict[str, Any]:
        flat, treedef = flatten_with_paths(self.cache_struct(batch, s_ctx))
        return treedef.unflatten(
            {k: torch.zeros(s.shape, dtype=s.dtype, device=device) for k, s in flat.items()})


def input_specs(cfg: ArchConfig, shape: InputShape) -> dict[str, Any]:
    """Model inputs for (cfg, shape) as TensorSpecs, nothing allocated.

    train:   tokens/labels (B, S) [+ the patch embeddings or the encoder's frames]
    prefill: tokens (B, S) [+ the patch embeddings or the encoder's frames]
    decode:  tokens (B, 1), pos scalar, caches for a seq_len context
    """
    tf.check_supported(cfg)
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    frames = {}
    if cfg.vision_prefix:
        frames["vis_embeds"] = TensorSpec((b, cfg.vision_prefix, cfg.d_model), pdtype(cfg))
    if cfg.encdec:
        frames["enc_frames"] = TensorSpec((b, cfg.enc_seq, cfg.d_model), pdtype(cfg))
    if shape.kind == "train":
        return {"tokens": TensorSpec((b, s), i32), "labels": TensorSpec((b, s), i32), **frames}
    if shape.kind == "prefill":
        return {"tokens": TensorSpec((b, s), i32), **frames}
    if shape.kind == "decode":
        return {"tokens": TensorSpec((b, 1), i32), "pos": TensorSpec((), i32),
                "caches": Model(cfg).cache_struct(b, s)}
    raise ValueError(shape.kind)


def tree_from_numpy(tree: Any, specs: Any, device) -> Any:
    """A tree of the JAX package's (numpy leaves; bf16 as ml_dtypes arrays)
    as tensors on ``device``, with every path, shape and dtype checked
    against ``specs`` (a TensorSpec tree)."""
    flat, _ = flatten_with_paths(tree)
    want, treedef = flatten_with_paths(specs)
    if sorted(flat) != sorted(want):
        raise ValueError(f"tree paths differ: only given {sorted(set(flat) - set(want))}, "
                         f"only expected {sorted(set(want) - set(flat))}")
    out = {}
    for path, spec in want.items():
        t = numpy_to_tensor(np.array(flat[path]), device)  # a copy: jax's buffers are read-only
        if tuple(t.shape) != spec.shape or t.dtype != spec.dtype:
            raise ValueError(f"{path}: got {tuple(t.shape)} {t.dtype}, "
                             f"expected {spec.shape} {spec.dtype}")
        out[path] = t
    return treedef.unflatten(out)


def params_from_numpy(tree: Any, cfg: ArchConfig, device) -> dict[str, Any]:
    """The JAX package's parameter tree as the port's parameters on
    ``device``, checked against the port's own ``init``."""
    return tree_from_numpy(tree, Model(cfg).param_specs(), device)
