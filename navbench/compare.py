"""The numbers that decide ``correct``, each against its limit.

Training (the program's first steps against the reference's, from the
same weights on the same rows): ``loss_gap``, the largest relative gap of
the loss of a step taken at the starting weights (up to the first step
whose learning rate is above 0: a later step's loss follows an Adam
update, which makes a whole step of the learning rate of the sign of every
near-zero gradient element, so bf16 rounding moves it by percents);
``grad_norm_gap``, the largest gap between the program's and the
reference's norm of a leaf's first (clipped) gradient; and
``change_norm_gap``, the same of each leaf's change over the steps. A
leaf's gap is measured against the reference's norm of that leaf or of the
median leaf, whichever is larger. The change leaves out leaves whose
reference gradient is under a thousandth of the median leaf's (they move
by round-off alone).

Serving: ``logit_gap``, the widest gap by which a served token's logit lies
below the reference's best at its position.

The limits are the cell's file ``limits/<cell>.json``.
"""

from __future__ import annotations

import math
import statistics

QUIET_LEAF = 1e-3  # of the median leaf's reference gradient


def _leaf_gap(prog: dict, ref: dict, leaves) -> tuple[float, str]:
    med = statistics.median(ref[p] for p in leaves)
    gaps = {p: abs(prog[p] - ref[p]) / max(ref[p], med, 1e-30) for p in leaves}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog``/``ref``: ``{"losses": [...], "grad_norms": {leaf: norm},
    "change_norms": {leaf: norm}}``, the reference's also each step's
    learning rate (``lrs``)."""
    at_start = next((i + 1 for i, lr in enumerate(ref["lrs"]) if lr > 0), len(ref["lrs"]))
    losses = list(zip(prog["losses"], ref["losses"]))[:at_start]
    loss_gap = max(abs(a - b) / abs(b) for a, b in losses)
    g_ref = ref["grad_norms"]
    grad_gap, grad_leaf = _leaf_gap(prog["grad_norms"], g_ref, list(g_ref))
    med = statistics.median(g_ref.values())
    moved = [p for p in g_ref if g_ref[p] >= QUIET_LEAF * med]
    change_gap, change_leaf = _leaf_gap(prog["change_norms"], ref["change_norms"], moved)
    return {"loss_gap": loss_gap, "grad_norm_gap": grad_gap, "change_norm_gap": change_gap,
            "_worst": {"grad": grad_leaf, "change": change_leaf,
                       "left_out": sorted(set(g_ref) - set(moved)), "steps": len(losses)}}


def logit_gaps(ref_logits, tokens) -> list[float]:
    """Each position's gap: the reference's best logit less its logit of
    the token served there. ``ref_logits`` (T, V) float32, ``tokens`` (T,)."""
    import torch

    tok = torch.as_tensor(tokens, device=ref_logits.device).long()
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, tok[:, None])[:, 0]
    return (best - got).tolist()


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, ``{name: {"value", "limit"}}``): every number named in the
    limits present, finite and at most its limit."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
