"""Model facade for the decoder-only GQA configurations (dense or MoE FFN).

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
is ``{w_router (float32), [router_bias], wg, wu, wd, [ws_g, ws_u, ws_d]}``),
and the caches are ``{"g0": {"k", "v"}: (L, B, S, KV, Dh)}`` per layer
group, so the serve CMI of a request
published by one package resumes in the other. :func:`params_from_numpy`
carries the JAX package's parameters across. :func:`input_specs` gives the
inputs of a shape as :class:`TensorSpec` stand-ins (the reference's
``ShapeDtypeStruct``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import transformer as tf
from repro_torch.models.layers import embed, pdtype, softmax_xent_chunked, unembed_logits
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
        return tf.init_lm(gen, self.cfg, gen.device)

    def param_specs(self) -> dict[str, Any]:
        """The parameter tree's shapes and dtypes, nothing allocated."""
        meta = tf.init_lm(None, self.cfg, "meta")
        flat, treedef = flatten_with_paths(meta)
        return treedef.unflatten({k: TensorSpec(tuple(v.shape), v.dtype) for k, v in flat.items()})

    def _unembed(self, params):
        return params["embed"] if self.cfg.tie_embeddings else params["unembed"]

    # -- train --------------------------------------------------------------
    def loss(self, params, batch, *, n_groups: int = 0) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch`` ({"tokens", "labels"},
        (B, S) int; label -1 ignored), a 0-d float32 tensor. ``n_groups``:
        MoE routing groups (0: one per sequence)."""
        cfg = self.cfg
        x = embed(batch["tokens"], params["embed"]).to(pdtype(cfg))
        h = tf.forward_train(params, x, cfg, n_groups=n_groups)
        return softmax_xent_chunked(h, self._unembed(params), batch["labels"], cfg.loss_chunk)

    # -- serve --------------------------------------------------------------
    def prefill(self, params, batch, s_max: int, *, n_groups: int = 0):
        """Returns (last-position logits (B, V) float32, caches)."""
        x = embed(batch["tokens"], params["embed"]).to(pdtype(self.cfg))
        h, caches = tf.forward_prefill(params, x, self.cfg, s_max, n_groups=n_groups)
        return unembed_logits(h[:, -1], self._unembed(params)), caches

    def decode(self, params, caches, tokens, pos: int, *, n_groups: int = 0):
        """One decode step. tokens (B, 1) int; pos the absolute position.
        The caches are written in place and returned."""
        x = embed(tokens, params["embed"]).to(pdtype(self.cfg))
        h, caches = tf.forward_decode(params, x, caches, int(pos), self.cfg, n_groups=n_groups)
        return unembed_logits(h, self._unembed(params)), caches

    # -- caches ---------------------------------------------------------------
    def cache_struct(self, batch: int, s_ctx: int) -> dict[str, Any]:
        """TensorSpec tree of the decode caches (also used to zero-init)."""
        cfg = self.cfg
        dt = pdtype(cfg)
        kv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
        s_kv = min(s_ctx, cfg.window) if cfg.window else s_ctx
        spec = lambda n: TensorSpec((n, batch, s_kv, kv, dh), dt)  # noqa: E731
        return {g: {"k": spec(n), "v": spec(n)} for g, n, _, _ in tf.block_groups(cfg)}

    def init_cache(self, batch: int, s_ctx: int, device) -> dict[str, Any]:
        flat, treedef = flatten_with_paths(self.cache_struct(batch, s_ctx))
        return treedef.unflatten(
            {k: torch.zeros(s.shape, dtype=s.dtype, device=device) for k, s in flat.items()})


def input_specs(cfg: ArchConfig, shape: InputShape) -> dict[str, Any]:
    """Model inputs for (cfg, shape) as TensorSpecs, nothing allocated.

    train:   tokens/labels (B, S)
    prefill: tokens (B, S)
    decode:  tokens (B, 1), pos scalar, caches for a seq_len context
    """
    tf.check_supported(cfg)
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "train":
        return {"tokens": TensorSpec((b, s), i32), "labels": TensorSpec((b, s), i32)}
    if shape.kind == "prefill":
        return {"tokens": TensorSpec((b, s), i32)}
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
