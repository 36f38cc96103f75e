"""Decoder-only transformer assembly: layer groups, stacked layers, caches.

Port of the JAX package's ``repro/models/transformer.py`` for the GQA mixer
with the dense (SwiGLU) or the MoE FFN. Layers with identical structure are
stacked on a leading ``L`` axis, as in the reference; each ``lax.scan`` over
that axis is a Python loop over its slices here. ``block_groups`` is the
reference's grouping (a MoE config's ``first_dense_layers`` form a dense
group ``g0`` before the MoE group ``g1``), so parameter paths and cache
paths are the same in both packages. ``n_groups`` is the MoE routing
groups of every call (0: one per sequence). The other mixers (mla, hybrid,
mlstm) raise ``NotImplementedError`` (ROADMAP queue 1, item 11).

The training forward's layer-scan remat maps onto ``torch.utils.checkpoint``
per layer, after the reference's ``_REMAT_POLICIES``: ``nothing`` keeps no
activation of a layer and recomputes it in the backward pass, ``dots``
keeps the matrix products' outputs and recomputes the rest, ``full`` keeps
everything (no checkpoint).
"""

from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import init_dense, init_embedding, pdtype, rmsnorm, swiglu
from repro_torch.utils import flatten_with_paths

_LATER = "is not ported yet (ROADMAP queue 1, item 11: models and training)"


def block_groups(cfg: ArchConfig) -> list[tuple[str, int, str, str]]:
    """[(group_name, n_layers, mixer_kind, ffn_kind)]"""
    if cfg.mla:
        mixer = "mla"
    elif cfg.ssm:
        mixer = "hybrid"
    elif cfg.mlstm:
        mixer = "mlstm"
    else:
        mixer = "gqa"
    ffn = "moe" if cfg.moe else ("dense" if cfg.d_ff > 0 else "none")
    if cfg.moe and cfg.first_dense_layers > 0:
        return [
            ("g0", cfg.first_dense_layers, mixer, "dense"),
            ("g1", cfg.n_layers - cfg.first_dense_layers, mixer, "moe"),
        ]
    return [("g0", cfg.n_layers, mixer, ffn)]


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not run."""
    if cfg.encdec or cfg.vision_prefix:
        raise NotImplementedError(f"{cfg.name}: the encoder/vision front ends {_LATER}")
    for _, _, mixer, ffn in block_groups(cfg):
        if mixer != "gqa":
            raise NotImplementedError(f"{cfg.name}: mixer {mixer!r} {_LATER}")
        if ffn not in ("dense", "moe"):
            raise NotImplementedError(f"{cfg.name}: ffn {ffn!r} {_LATER}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_ffn(gen, cfg: ArchConfig, n_layers: int, kind: str, device) -> dict:
    if kind == "moe":
        return moe_mod.init_moe(gen, cfg, n_layers, device)
    dt, e = pdtype(cfg), cfg.d_model
    return {
        "wg": init_dense(gen, (n_layers, e, cfg.d_ff), ("layers", "embed", "mlp"), dt, device),
        "wu": init_dense(gen, (n_layers, e, cfg.d_ff), ("layers", "embed", "mlp"), dt, device),
        "wd": init_dense(gen, (n_layers, cfg.d_ff, e), ("layers", "mlp", "embed"), dt, device),
    }


def init_lm(gen: torch.Generator | None, cfg: ArchConfig, device) -> dict[str, Any]:
    """The parameter tree, with the reference's paths and shapes. Weights
    come from ``gen`` in a fixed order; on the ``meta`` device only shapes
    and dtypes are made."""
    check_supported(cfg)
    dt = pdtype(cfg)
    params: dict[str, Any] = {"embed": init_embedding(gen, cfg, device)}
    if not cfg.tie_embeddings:
        params["unembed"] = init_embedding(gen, cfg, device)
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
    params["blocks"] = {}
    for gname, n, _, ffn in block_groups(cfg):
        params["blocks"][gname] = {
            "ln1": torch.ones((n, cfg.d_model), dtype=dt, device=device),
            "attn": attn.init_gqa(gen, cfg, n, device),
            "ln2": torch.ones((n, cfg.d_model), dtype=dt, device=device),
            "ffn": _init_ffn(gen, cfg, n, ffn, device),
        }
    return params


# ---------------------------------------------------------------------------
# block apply (single layer; params without the L axis)
# ---------------------------------------------------------------------------


def _layer(gp: dict, i: int) -> dict:
    """Layer ``i``'s parameters: each stacked leaf indexed on its L axis."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in gp.items()}


def _ffn(pl, h, cfg: ArchConfig, ffn: str, n_groups: int):
    f, x = pl["ffn"], rmsnorm(h, pl["ln2"], cfg.norm_eps)
    if ffn == "moe":
        return moe_mod.moe_ffn(f, x, cfg, n_groups=n_groups)
    return swiglu(x, f["wg"], f["wu"], f["wd"])


def block_train(pl, x, cfg: ArchConfig, ffn: str, n_groups: int):
    """One layer of the training forward."""
    h = x + attn.gqa_train(pl["attn"], rmsnorm(x, pl["ln1"], cfg.norm_eps), cfg)
    return h + _ffn(pl, h, cfg, ffn, n_groups)


def block_prefill(pl, x, cfg: ArchConfig, ffn: str, n_groups: int, s_max: int):
    """One layer of the prefill; also returns its decode cache."""
    y, cache = attn.gqa_prefill(pl["attn"], rmsnorm(x, pl["ln1"], cfg.norm_eps), cfg, s_max)
    h = x + y
    return h + _ffn(pl, h, cfg, ffn, n_groups), cache


def block_decode(pl, x, cache, pos: int, cfg: ArchConfig, ffn: str, n_groups: int):
    y, cache = attn.gqa_decode(pl["attn"], rmsnorm(x, pl["ln1"], cfg.norm_eps), cache, pos, cfg)
    h = x + y
    return h + _ffn(pl, h, cfg, ffn, n_groups), cache


# ---------------------------------------------------------------------------
# stacks: a loop over each group's layers
# ---------------------------------------------------------------------------


# the outputs the "dots" policy keeps: matrix products (torch.matmul lowers
# to these), as jax.checkpoint_policies.checkpoint_dots keeps dot_generals
_DOT_OPS = ("mm", "bmm", "addmm", "baddbmm")


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    if any(op is getattr(torch.ops.aten, name).default for name in _DOT_OPS):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ArchConfig):
    """``fn`` under ``cfg.remat``'s policy (see the module docstring)."""
    if cfg.remat == "full":
        return fn
    if cfg.remat == "nothing":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"unknown remat policy {cfg.remat!r}")


def _unbind_layers(gp: dict, n: int) -> list[dict]:
    """Each layer's parameters as views of the stacked leaves, from one
    ``unbind`` per leaf: the backward stacks the layers' gradients once,
    where indexing each layer would add L full-size gradients."""
    flat, treedef = flatten_with_paths(gp)
    cols = {path: torch.unbind(leaf, 0) for path, leaf in flat.items()}
    return [treedef.unflatten({path: col[i] for path, col in cols.items()}) for i in range(n)]


def forward_train(params, x, cfg: ArchConfig, *, n_groups: int = 0):
    """x: (B, S, E) embedded inputs -> final hidden (B, S, E)."""
    for gname, n, _, ffn in block_groups(cfg):
        body = _remat(functools.partial(block_train, cfg=cfg, ffn=ffn, n_groups=n_groups), cfg)
        for pl in _unbind_layers(params["blocks"][gname], n):
            x = body(pl, x)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps)


def forward_prefill(params, x, cfg: ArchConfig, s_max: int, *, n_groups: int = 0):
    """Returns (final hidden, caches) — caches stacked on L per group."""
    caches = {}
    for gname, n, _, ffn in block_groups(cfg):
        gp = params["blocks"][gname]
        layer_caches = []
        for i in range(n):
            x, cache = block_prefill(_layer(gp, i), x, cfg, ffn, n_groups, s_max)
            layer_caches.append(cache)
        caches[gname] = {k: torch.stack([c[k] for c in layer_caches]) for k in ("k", "v")}
    return rmsnorm(x, params["final_norm"], cfg.norm_eps), caches


def forward_decode(params, x, caches, pos: int, cfg: ArchConfig, *, n_groups: int = 0):
    """x: (B,1,E). Returns (final hidden (B,1,E), caches written in place)."""
    for gname, n, _, ffn in block_groups(cfg):
        gp, gc = params["blocks"][gname], caches[gname]
        for i in range(n):
            x, _ = block_decode(_layer(gp, i), x, _layer(gc, i), pos, cfg, ffn, n_groups)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps), caches
