"""Decoder-only transformer assembly: layer groups, stacked layers, caches.

Port of the JAX package's ``repro/models/transformer.py`` for the mixers
gqa, mla (deepseek), hybrid (attention ‖ SSD, hymba) and mlstm (xLSTM), with the dense
(SwiGLU), the MoE or no FFN (an mLSTM block owns its projections). Layers
with identical structure are stacked on a leading ``L`` axis, as in the
reference; each ``lax.scan`` over that axis is a Python loop over its
slices here. ``block_groups`` is the reference's grouping (a MoE config's
``first_dense_layers`` form a dense group ``g0`` before the MoE group
``g1``), so parameter paths and cache paths are the same in both packages.
``n_groups`` is the MoE routing groups of every call (0: one per
sequence). The vision prefix is a stack of patch embeddings before the
tokens (``models/model.py``); the encoder-decoder is ``models/encdec.py``.

Decode writes every cache in place, as ``gqa_decode`` writes k/v: a hybrid
layer's SSD state and an mLSTM layer's matrix memory are copied into their
slot of the stacked cache, since the request's caches are its state.

Under a tensor-parallel plan (``distributed/tp.py``) every mixer runs on
the rank's heads: a hybrid layer's attention and SSD read one input and
their partial sums are averaged and added over the model axis once
(:func:`_tp_hybrid`); the recurrent states stay whole on the heads, each
rank computing its heads' part.

The training forward's layer-scan remat maps onto ``torch.utils.checkpoint``
per layer, after the reference's ``_REMAT_POLICIES``: ``nothing`` keeps no
activation of a layer and recomputes it in the backward pass, ``dots``
keeps the matrix products' outputs and recomputes the rest, ``full`` keeps
everything (no checkpoint).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import spans
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import init_const, init_dense, init_embedding, pdtype, rmsnorm, swiglu
from repro_torch.utils import flatten_with_paths

_LATER = "is not ported yet (ROADMAP queue 1, item 11: models and training)"
# the FFN kinds each ported mixer runs with (the configurations that exist)
_FFNS = {"gqa": ("dense", "moe"), "mla": ("dense", "moe"), "hybrid": ("dense",),
         "mlstm": ("none",)}


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
    if cfg.encdec:
        return  # models/encdec.py: its own blocks
    for _, _, mixer, ffn in block_groups(cfg):
        if mixer not in _FFNS:
            raise NotImplementedError(f"{cfg.name}: mixer {mixer!r} {_LATER}")
        if ffn not in _FFNS[mixer]:
            raise NotImplementedError(f"{cfg.name}: mixer {mixer!r} with ffn {ffn!r} {_LATER}")


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
    params["final_norm"] = init_const((cfg.d_model,), 1.0, ("embed",), dt, device)
    params["blocks"] = {}
    for gname, n, mixer, ffn in block_groups(cfg):
        bp = {"ln1": init_const((n, cfg.d_model), 1.0, ("layers", "embed"), dt, device)}
        if mixer in ("gqa", "hybrid"):
            bp["attn"] = attn.init_gqa(gen, cfg, n, device)
        if mixer == "mla":
            bp["attn"] = attn.init_mla(gen, cfg, n, device)
        if mixer == "hybrid":
            bp["ssd"] = ssm_mod.init_ssd(gen, cfg, n, device)
        if mixer == "mlstm":
            bp["mlstm"] = ssm_mod.init_mlstm(gen, cfg, n, device)
        if ffn != "none":
            bp["ln2"] = init_const((n, cfg.d_model), 1.0, ("layers", "embed"), dt, device)
            bp["ffn"] = _init_ffn(gen, cfg, n, ffn, device)
        params["blocks"][gname] = bp
    return params


# ---------------------------------------------------------------------------
# block apply (single layer; params without the L axis)
# ---------------------------------------------------------------------------


def _layer(gp: dict, i: int) -> dict:
    """Layer ``i``'s parameters: each stacked leaf indexed on its L axis."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in gp.items()}


def _scale(t: torch.Tensor, plan) -> torch.Tensor:
    """A norm's scale; under ``seq_shard`` it acts on this rank's positions,
    so its gradient is summed over the model axis."""
    return plan.copy_to(t) if plan is not None and plan.seq_shard else t


def _ffn(pl, h, cfg: ArchConfig, ffn: str, n_groups: int, plan=None):
    """``h`` plus the FFN sublayer's output (``h`` itself with no FFN)."""
    if ffn == "none":
        return h
    f, x = pl["ffn"], rmsnorm(h, _scale(pl["ln2"], plan), cfg.norm_eps)
    if ffn == "moe":
        return h + moe_mod.moe_ffn(f, x, cfg, n_groups=n_groups, plan=plan)
    return h + swiglu(x, f["wg"], f["wu"], f["wd"], plan)


def _mixer_train(pl, x, cfg: ArchConfig, mixer: str, plan=None):
    if mixer == "gqa":
        return attn.gqa_train(pl["attn"], x, cfg, plan=plan)
    if mixer == "mla":
        return attn.mla_train(pl["attn"], x, cfg, plan=plan)
    if mixer == "hybrid":
        if plan is not None:
            return _tp_hybrid(pl, x, cfg, plan)[0]
        return (attn.gqa_train(pl["attn"], x, cfg) + ssm_mod.ssd_train(pl["ssd"], x, cfg)) * 0.5
    return ssm_mod.mlstm_train(pl["mlstm"], x, cfg, plan)


def _tp_hybrid(pl, x, cfg: ArchConfig, plan, s_max: int = 0):
    """The hybrid mixer on this rank's heads: ``(y, cache)``. Attention and
    SSD read one input (``plan.enter``: the whole sequence under
    ``seq_shard``), each gives the partial sums of the rank's heads, and
    their average is added over the model axis once (reduce-scattered
    along S under ``seq_shard``), ``bo`` (halved, as the average halves it)
    after. With ``s_max`` (the prefill) also the layer's decode cache: the
    rank's block of the attention cache's slots with every kv head, and
    the SSD state whole on the heads."""
    xin = plan.enter(x)
    wa = attn._tp_weights(pl["attn"], cfg, plan)
    ya, k, v = attn._tp_attend(wa, xin, cfg, plan, causal=True, use_rope=True)
    ys, state = ssm_mod.ssd_apply(ssm_mod.tp_weights(pl["ssd"], cfg, plan), xin, cfg)
    y = attn._tp_finish((ya + ys) * 0.5, _half_bias(wa, cfg), cfg, plan)
    if not s_max:
        return y, None
    return y, {"attn": attn.tp_cache(k, v, s_max, cfg, plan),
               "ssd": ssm_mod.whole_state(state, plan)}


def _half_bias(w: dict, cfg: ArchConfig) -> dict:
    """The attention's ``bo`` as the hybrid's average adds it: halved."""
    return {"bo": w["bo"] * 0.5} if cfg.attn_bias else {}


def block_train(pl, x, cfg: ArchConfig, mixer: str, ffn: str, n_groups: int, plan=None):
    """One layer of the training forward; under a tensor-parallel ``plan``
    (``distributed/tp.py``) on this rank's shards, and on its positions
    under ``seq_shard``."""
    h = x + _mixer_train(pl, rmsnorm(x, _scale(pl["ln1"], plan), cfg.norm_eps), cfg, mixer,
                         plan)
    return _ffn(pl, h, cfg, ffn, n_groups, plan)


def block_prefill(pl, x, cfg: ArchConfig, mixer: str, ffn: str, n_groups: int, s_max: int,
                  plan=None):
    """One layer of the prefill; also returns its decode cache: k/v, for
    mla ``{ckv, kr}``, for hybrid ``{"attn": {k, v}, "ssd": state}``, for
    mlstm ``{"mlstm": state}``."""
    xin = rmsnorm(x, pl["ln1"], cfg.norm_eps)
    if mixer == "gqa":
        y, cache = attn.gqa_prefill(pl["attn"], xin, cfg, s_max, plan=plan)
    elif mixer == "mla":
        y, cache = attn.mla_prefill(pl["attn"], xin, cfg, s_max, plan)
    elif mixer == "hybrid" and plan is not None:
        y, cache = _tp_hybrid(pl, xin, cfg, plan, s_max)
    elif mixer == "hybrid":
        ya, ac = attn.gqa_prefill(pl["attn"], xin, cfg, s_max)
        ys, sstate = ssm_mod.ssd_apply(pl["ssd"], xin, cfg)
        y, cache = (ya + ys) * 0.5, {"attn": ac, "ssd": sstate}
    else:
        y, mstate = ssm_mod.mlstm_apply(pl["mlstm"], xin, cfg, plan=plan)
        cache = {"mlstm": ssm_mod.whole_state(mstate, plan)}
    h = x + y
    return _ffn(pl, h, cfg, ffn, n_groups, plan), cache


def block_decode(pl, x, cache, pos: int, cfg: ArchConfig, mixer: str, ffn: str, n_groups: int,
                 plan=None):
    """One decode step of one layer; ``cache`` (this layer's views of the
    stacked caches) is written in place and returned."""
    xin = rmsnorm(x, pl["ln1"], cfg.norm_eps)
    if mixer == "gqa":
        y, cache = attn.gqa_decode(pl["attn"], xin, cache, pos, cfg, plan=plan)
    elif mixer == "mla":
        y, cache = attn.mla_decode(pl["attn"], xin, cache, pos, cfg, plan)
    elif mixer == "hybrid" and plan is not None:  # both on the rank's heads, added once
        ya = attn._tp_decode(pl["attn"], xin, cache["attn"], pos, cfg, plan, use_rope=True)
        ys, sstate = ssm_mod.ssd_decode(pl["ssd"], xin, cache["ssd"], cfg, plan)
        cache["ssd"].copy_(sstate)
        y = attn._tp_finish((ya + ys) * 0.5, _half_bias(pl["attn"], cfg), cfg, plan)
    elif mixer == "hybrid":
        ya, _ = attn.gqa_decode(pl["attn"], xin, cache["attn"], pos, cfg)
        ys, sstate = ssm_mod.ssd_decode(pl["ssd"], xin, cache["ssd"], cfg)
        cache["ssd"].copy_(sstate)
        y = (ya + ys) * 0.5
    else:
        y, mstate = ssm_mod.mlstm_decode(pl["mlstm"], xin, cache["mlstm"], cfg, plan)
        cache["mlstm"].copy_(mstate)
    h = x + y
    return _ffn(pl, h, cfg, ffn, n_groups, plan), cache


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


def _recompute_contexts(inner=None):
    """A checkpoint's ``context_fn``: ``inner``'s pair (none by default),
    the recomputation also under :func:`spans.recompute`."""
    fwd, rec = inner() if inner is not None else (contextlib.nullcontext(), None)
    return fwd, spans.recompute(rec)


def _remat(fn, cfg: ArchConfig):
    """``fn`` under ``cfg.remat``'s policy (see the module docstring); a
    layer's recomputation is the span ``recompute``."""
    if cfg.remat == "full":
        return fn
    if cfg.remat == "nothing":
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=_recompute_contexts)
    if cfg.remat == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(_recompute_contexts, functools.partial(
                create_selective_checkpoint_contexts, _dots_policy)))
    raise ValueError(f"unknown remat policy {cfg.remat!r}")


def _unbind_layers(gp: dict, n: int) -> list[dict]:
    """Each layer's parameters as views of the stacked leaves, from one
    ``unbind`` per leaf: the backward stacks the layers' gradients once,
    where indexing each layer would add L full-size gradients."""
    flat, treedef = flatten_with_paths(gp)
    cols = {path: torch.unbind(leaf, 0) for path, leaf in flat.items()}
    return [treedef.unflatten({path: col[i] for path, col in cols.items()}) for i in range(n)]


def _stack_layers(trees: list) -> Any:
    """Per-layer cache trees stacked leaf by leaf on a new leading L axis."""
    flats = [flatten_with_paths(t)[0] for t in trees]
    _, treedef = flatten_with_paths(trees[0])
    return treedef.unflatten({path: torch.stack([f[path] for f in flats]) for path in flats[0]})


def forward_train(params, x, cfg: ArchConfig, *, n_groups: int = 0, plan=None):
    """x: (B, S, E) embedded inputs -> final hidden (B, S, E). ``resid`` is
    the sequence-parallel point under ``seq_shard`` (``distributed/ctx.py``):
    the stream between layers, and the final hidden, are this rank's
    positions. The plan is bound into each layer's body, so a layer
    recomputed in the backward pass (on the autograd engine's thread)
    computes as it did."""
    from repro_torch.distributed.ctx import constrain

    x = constrain(x, "resid")
    for gname, n, mixer, ffn in block_groups(cfg):
        body = _remat(functools.partial(block_train, cfg=cfg, mixer=mixer, ffn=ffn,
                                        n_groups=n_groups, plan=plan), cfg)
        for pl in _unbind_layers(params["blocks"][gname], n):
            x = constrain(body(pl, x), "resid")
    return rmsnorm(x, _scale(params["final_norm"], plan), cfg.norm_eps)


def forward_prefill(params, x, cfg: ArchConfig, s_max: int, *, n_groups: int = 0, plan=None):
    """Returns (final hidden, caches) — caches stacked on L per group."""
    caches = {}
    for gname, n, mixer, ffn in block_groups(cfg):
        gp = params["blocks"][gname]
        layer_caches = []
        for i in range(n):
            x, cache = block_prefill(_layer(gp, i), x, cfg, mixer, ffn, n_groups, s_max, plan)
            layer_caches.append(cache)
        caches[gname] = _stack_layers(layer_caches)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps), caches


def forward_decode(params, x, caches, pos: int, cfg: ArchConfig, *, n_groups: int = 0,
                   plan=None):
    """x: (B,1,E). Returns (final hidden (B,1,E), caches written in place)."""
    for gname, n, mixer, ffn in block_groups(cfg):
        gp, gc = params["blocks"][gname], caches[gname]
        for i in range(n):
            x, _ = block_decode(_layer(gp, i), x, _layer(gc, i), pos, cfg, mixer, ffn, n_groups,
                                plan)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps), caches
