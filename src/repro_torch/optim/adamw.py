"""AdamW with float32 master weights and a global-norm clip.

Port of the JAX package's ``repro/optim/adamw.py``. Params live in the
model dtype (bf16); the optimizer holds a float32 master copy plus first
and second moments in ``moment_dtype``. The state tree has the reference's
paths and dtypes (``{"mu", "nu", "master", "count"}``), so one CMI serves
both packages.

Two differences from the reference, neither in the arithmetic:

* :func:`adamw_update` updates params, moments and master **in place** (the
  reference returns new trees): at qwen3-1.7b the state is ~24 GB, and a
  second copy would not fit beside the step's activations. Every publish
  reads the state before the next step writes it (a synchronous publish
  serializes before it returns; an async one snapshots to the host first).
* Leaves are visited in the tree's path order (``utils.flatten_with_paths``,
  the reference's ``tree_leaves`` order), so the global norm is summed in
  one fixed order: a resumed run repeats an uninterrupted one bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch import spans
from repro_torch.utils import flatten_with_paths, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"  # "bfloat16" halves optimizer memory


def init_opt_state(params: Any, cfg: AdamWConfig) -> dict:
    mdt = getattr(torch, cfg.moment_dtype)
    leaf = next(iter(flatten_with_paths(params)[0].values()))
    return {
        "mu": tree_map(lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device), params),
        "nu": tree_map(lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device), params),
        "master": tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        "count": torch.zeros((), dtype=torch.int32, device=leaf.device),
    }


def opt_axes(param_axes: Any) -> dict:
    """Logical axes for the optimizer state (mirrors the param axes)."""
    return {
        "mu": param_axes,
        "nu": param_axes,
        "master": param_axes,
        "count": (),
    }


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, leaves summed
    in path order."""
    total = None
    for x in flatten_with_paths(tree)[0].values():
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def adamw_scalars(gnorm: torch.Tensor, count: torch.Tensor, cfg: AdamWConfig):
    """(clip scale, 1 - b1^t, 1 - b2^t) of a step; ``count`` already
    advanced to t."""
    clip = gnorm.new_tensor(cfg.clip_norm) / torch.clamp(gnorm, min=1e-9)
    scale = torch.clamp(clip, max=1.0)
    cf = count.float()
    return scale, 1.0 - torch.pow(cfg.b1, cf), 1.0 - torch.pow(cfg.b2, cf)


@torch.no_grad()
def adamw_leaf(g, mu, nu, master, scale, c1, c2, lr, cfg: AdamWConfig) -> None:
    """One leaf's update, in place on ``mu``, ``nu`` and ``master`` (any
    block of the leaf, all four the same block)."""
    g = g.float() * scale
    mu32 = mu.float() * cfg.b1
    mu32 += g * (1 - cfg.b1)
    nu32 = nu.float() * cfg.b2
    g2 = g * (1 - cfg.b2)
    g2 *= g
    nu32 += g2
    del g2
    step = mu32 / c1
    den = nu32 / c2
    den.sqrt_()
    den += cfg.eps
    step /= den
    del den
    step += master * cfg.weight_decay
    step *= lr
    master -= step
    mu.copy_(mu32)
    nu.copy_(nu32)


@torch.no_grad()
def adamw_update(grads: Any, opt_state: dict, params: Any, lr, cfg: AdamWConfig) -> dict:
    """One AdamW step, in place on ``params`` and ``opt_state``.

    ``grads`` has ``params``' paths; ``lr`` is a float or a 0-d tensor.
    Returns the metrics ``{"grad_norm"}``. Each float32 operation rounds
    where the reference's does (no fused multiply-adds), so the two agree
    to float32 rounding.
    """
    # a span, so a profile can attribute the update's kernels
    with spans.span("adamw_update"):
        g_flat, _ = flatten_with_paths(grads)
        p_flat, _ = flatten_with_paths(params)
        if sorted(g_flat) != sorted(p_flat):
            raise ValueError("grads and params have different paths")
        mu_flat, _ = flatten_with_paths(opt_state["mu"])
        nu_flat, _ = flatten_with_paths(opt_state["nu"])
        m_flat, _ = flatten_with_paths(opt_state["master"])
        count = opt_state["count"]
        count += 1
        gnorm = global_norm(grads)
        scale, c1, c2 = adamw_scalars(gnorm, count, cfg)
        for path, g in g_flat.items():
            master = m_flat[path]
            adamw_leaf(g, mu_flat[path], nu_flat[path], master, scale, c1, c2, lr, cfg)
            p_flat[path].copy_(master)
    return {"grad_norm": gnorm}
