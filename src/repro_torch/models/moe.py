"""Mixture-of-Experts FFN: sort-based grouped dispatch.

Port of the JAX package's ``repro/models/moe.py``. Tokens are routed per
*group* (a group is one sequence by default), each token's top-k
assignments are sorted by expert id (a stable sort), positioned against
each expert's first assignment by binary search, and placed in a
capacity-bounded buffer that feeds one batched product per expert
(``xce,xef->xcf``). Over-capacity assignments are dropped: their position
is clamped to the last slot and their value and combine weight are
multiplied by zero, not skipped, as in the reference.

The groups of a call share one buffer of shape (X, G·C, E): group ``g``'s
slot ``c`` of expert ``x`` is row ``g·C + c``, so all groups' expert
products are one ``torch.bmm`` over X, where the reference vmaps
``_moe_group`` over G. The buffer is built by gathering each slot's token
(the reference scatters with ``.at[...].add``; a slot holds one kept
value in both, so they are equal), so dropped assignments cost nothing.
The combine gathers each token's k outputs and adds them in the
reference's order (see ``_moe_groups``). The two are each other's
transposes, so each one's gradient is the other's gather (:class:`_Gather`)
and no scatter runs forward or backward (autograd's backward of a gather
is a sort-based ``index_put`` whose rows repeat on the empty and dropped
slots). Every form is deterministic on the card and under
``torch.use_deterministic_algorithms``;
the packages' expert products still round differently, so they agree within
a tolerance, not bit for bit.

Routing flavours:
  softmax  — top-k of the logits, gates the softmax of the k chosen logits
  sigmoid  — DeepSeek-V3 aux-free: selection by sigmoid score + a static
             bias (a parameter), gates the normalised chosen sigmoid scores

Top-k breaks ties by the lower expert index, as ``jax.lax.top_k`` does: it
is the first k of a stable descending sort, since ``torch.topk`` promises
no order among equal values, and the order of ``idx`` decides which
assignments pass capacity.

On a mesh (a tensor-parallel ``plan``, ``distributed/tp.py``) the same
function computes on the experts' shards. A data row's ranks hold its
routing groups; the experts lie over ``("data", "model")`` (rank ``(d,
m)`` holds block ``d·M + m``), over ``model``, or whole. Each rank routes
its groups exactly as above — the router and its bias whole, the sort,
positions, capacity and kept set all before anything moves — and builds
only the slots of its model column's experts (blocks ``d'·M + m`` of
every row ``d'``: for deepseek-v3 on 16×16, 16 of 256). With nothing
split, the column is every expert and nothing moves. Where the experts
lie over data too:

* with ``moe_buf_shard`` the buffer is placed as the experts are (the
  reference's ``P(experts, None, None)`` under its vmap over the groups):
  an all-to-all over the data axis within the column sends each expert's
  slots to the rank that holds it, which then holds its experts' slots of
  every group and computes them; the reverse all-to-all brings the
  outputs back. Tokens move, not weights;
* without it the column's expert weights are all-gathered over the data
  axis (a column is 1/M of a layer's experts; the gradient is
  reduce-scattered back) and each rank computes its own groups' slots.

Either way each rank computes X·C/M slot rows a group (its share of the
layer's work), and no weight is gathered whole. The combine adds each
token's k outputs in the reference's order over the column's experts (the
others' terms are zeros); the model ranks' partial sums are then added
(``reduce_from``, or ``scatter_seq`` under ``seq_shard``, where the
groups are routed over the sequence all-gathered first). Only the last
add differs in order from one device's, so float32 agrees within a
tolerance.

The reference's compiled program (GSPMD on ``Auto`` mesh axes, read from
``lowered.compile().as_text()`` for the smoke models on 2×2) computes
its forward the same way in every cell: each data row's tokens
all-gathered, each device the products of its (data, model) block of
experts over every group, the combine all-reduced. Its train backward
differs on 2×2: without ``moe_buf_shard`` it all-gathers every expert
weight whole and recomputes and differentiates each device's group
through all X experts (batched products of (X, C, E): twice a device's
share, the model ranks repeating each other), 35 % more work on granite's
smoke step; with the flag one of the nine backward products still takes
that form. The port keeps the forward's program in the backward (the
autograd of the collectives above), so its count on 2×2 is the
reference's less that repeated work (``tests/test_torch_dryrun.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import init_const, init_dense, pdtype, swiglu


def init_moe(gen, cfg: ArchConfig, n_layers: int, device) -> dict:
    e, x_, f = cfg.d_model, cfg.n_experts, cfg.resolved_moe_d_ff
    dt = pdtype(cfg)
    p = {"w_router": init_dense(gen, (n_layers, e, x_), ("layers", "embed", None),
                                torch.float32, device)}
    if cfg.router_type == "sigmoid":
        p["router_bias"] = init_const((n_layers, x_), 0.0, ("layers", None), torch.float32,
                                      device)
    p["wg"] = init_dense(gen, (n_layers, x_, e, f), ("layers", "experts", "embed", "moe_mlp"), dt, device)
    p["wu"] = init_dense(gen, (n_layers, x_, e, f), ("layers", "experts", "embed", "moe_mlp"), dt, device)
    p["wd"] = init_dense(gen, (n_layers, x_, f, e), ("layers", "experts", "moe_mlp", "embed"), dt, device)
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["ws_g"] = init_dense(gen, (n_layers, e, fs), ("layers", "embed", "mlp"), dt, device)
        p["ws_u"] = init_dense(gen, (n_layers, e, fs), ("layers", "embed", "mlp"), dt, device)
        p["ws_d"] = init_dense(gen, (n_layers, fs, e), ("layers", "mlp", "embed"), dt, device)
    return p


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest along the last axis, in
    descending order, ties to the lower index (``jax.lax.top_k``'s rule)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(logits: torch.Tensor, p: dict, cfg: ArchConfig):
    """logits (..., X) float32 -> (gates (..., k) float32, idx (..., k) int64)."""
    k = cfg.top_k
    if cfg.router_type == "sigmoid":
        scores = torch.sigmoid(logits)
        _, idx = top_k(scores + p["router_bias"], k)
        g = torch.gather(scores, -1, idx)
        gates = g / torch.clamp(torch.sum(g, dim=-1, keepdim=True), min=1e-9)
    else:
        _, idx = top_k(logits, k)
        gates = torch.softmax(torch.gather(logits, -1, idx), dim=-1)
    return gates.float(), idx


class _Assignments(NamedTuple):
    """A call's top-k assignments, each group's sorted by expert id (a
    stable sort) and placed against the capacity: (G, T_g·k) each."""

    order: torch.Tensor  # the sort's permutation
    eid: torch.Tensor  # expert ids
    tid: torch.Tensor  # token indices
    gate: torch.Tensor  # float32 gates
    starts: torch.Tensor  # (G, X): each expert's first sorted assignment
    keep: torch.Tensor  # within the capacity
    row: torch.Tensor  # buffer row: group g's slot c of an expert is g*C + c


def _assign(xg: torch.Tensor, p: dict, cfg: ArchConfig, capacity: int) -> _Assignments:
    """Route each group of xg (G, T_g, E) and place its assignments."""
    g_, t_g, _ = xg.shape
    x_, k = cfg.n_experts, cfg.top_k
    dev = xg.device
    n = t_g * k
    logits = torch.matmul(xg.float(), p["w_router"])  # (G, T_g, X)
    gates, idx = _route(logits, p, cfg)
    eid = idx.reshape(g_, n)
    tid = torch.arange(t_g, device=dev).repeat_interleave(k)
    order = torch.sort(eid, dim=-1, stable=True).indices
    eid_s, tid_s = torch.gather(eid, 1, order), tid[order]
    gat_s = torch.gather(gates.reshape(g_, n), 1, order)
    experts = torch.arange(x_, device=dev).expand(g_, x_).contiguous()
    starts = torch.searchsorted(eid_s, experts, side="left")
    pos = torch.arange(n, device=dev) - torch.gather(starts, 1, eid_s)
    row = torch.arange(g_, device=dev)[:, None] * capacity + torch.clamp(pos, max=capacity - 1)
    return _Assignments(order, eid_s, tid_s, gat_s, starts, pos < capacity, row)


def _by_token(a: _Assignments, dtype: torch.dtype, k: int) -> tuple[torch.Tensor, ...]:
    """``(expert, row, weight, keep)``, each (G, T_g, k): every token's k
    assignments in the reference's combine order (its scatter-add applies
    the sorted assignments in turn: a token's in ascending expert id), the
    dropped ones weighted 0 and not kept."""
    g_, n = a.eid.shape
    w = (a.gate * a.keep.float()).to(dtype)
    inv = torch.argsort(a.order, dim=1)  # each assignment's place in the sorted order
    ps = torch.sort(inv.reshape(g_, n // k, k), dim=-1).values.reshape(g_, n)
    return tuple(torch.gather(t, 1, ps).reshape(g_, n // k, k)
                 for t in (a.eid, a.row, w, a.keep))


def _gather_sum(src: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[p] = Σ_j src[idx[p, j]] · w[p, j], added in j order, one
    rounding an add."""
    out = src[idx[:, 0]] * w[:, 0, None]
    for j in range(1, idx.shape[1]):
        out = out + src[idx[:, j]] * w[:, j, None]
    return out


class _Gather(torch.autograd.Function):
    """:func:`_gather_sum` whose gradient is the same gather over the
    transposed map (``idx_t``, ``w_t``: the terms each row of ``src`` went
    into), so neither way scatters, and both are deterministic. The
    dispatch (tokens to slots, one term a slot) and the combine (slots to
    tokens, k terms a token) are each other's transposes. The dispatch's
    weights (a slot filled or not) take no gradient; the combine's (the
    gates) take ``Σ_E g · src[idx]`` as autograd's product would."""

    @staticmethod
    def forward(ctx, src, idx, w, idx_t, w_t):
        ctx.save_for_backward(src, idx, idx_t, w_t)
        return _gather_sum(src, idx, w)

    @staticmethod
    def backward(ctx, g):
        src, idx, idx_t, w_t = ctx.saved_tensors
        d_src = _gather_sum(g, idx_t, w_t) if ctx.needs_input_grad[0] else None
        d_w = None
        if ctx.needs_input_grad[2]:
            d_w = torch.stack([(g * src[idx[:, j]]).sum(-1) for j in range(idx.shape[1])], 1)
        return d_src, None, d_w, None, None


def capacity(t_g: int, cfg: ArchConfig) -> int:
    """Slots per expert and group: ``T_g·k·cf / X``, at least 1."""
    return max(1, int(t_g * cfg.top_k * cfg.capacity_factor / cfg.n_experts))


def _moe_groups(xg: torch.Tensor, p: dict, cfg: ArchConfig, capacity: int,
                plan=None) -> torch.Tensor:
    """Route G token groups at once. xg: (G, T_g, E) -> (G, T_g, E), each
    token's weighted outputs summed over the experts this rank computes:
    all of them with no ``plan``; under one, its model column's (see the
    module's docstring), the others' terms zeros. The three phases run
    under spans (``moe_dispatch``, ``moe_experts``, ``moe_combine``) that a
    trace groups its kernels by; while spans record, the counters
    ``moe.slots`` and ``moe.filled`` add the slots the experts compute and
    those that hold a token."""
    g_, t_g, e = xg.shape
    x_, k = cfg.n_experts, cfg.top_k
    dev = xg.device
    n = t_g * k
    col = plan.experts.column(x_, plan) if plan is not None else range(x_)
    rows = plan.experts.rows if plan is not None else 1
    move = rows > 1 and plan.moe_buf_shard
    nc = len(col)
    # the column's experts (all of them with nothing split: no index)
    sel = slice(None) if nc == x_ else torch.tensor(col, device=dev)
    gc = g_ * capacity
    with spans.span("moe_dispatch"):
        a = _assign(xg, p, cfg, capacity)
        experts = torch.arange(x_, device=dev).expand(g_, x_).contiguous()
        counts = torch.searchsorted(a.eid, experts, side="right") - a.starts
        # the slots, (nc, G, C): slot c of an expert holds its sorted
        # assignment starts + c where that is one of its first C
        c = torch.arange(capacity, device=dev)
        src = torch.clamp(a.starts[:, sel].T[:, :, None] + c, max=n - 1)
        filled = (c < counts[:, sel].T[:, :, None]).reshape(-1, 1)
        spans.count("moe.slots", filled.numel())
        spans.count("moe.filled", filled.sum)
        gi = torch.arange(g_, device=dev)[None, :, None]
        slot_tok = (gi * t_g + a.tid[gi, src]).reshape(-1, 1)  # each slot's row of xg
        slot_gate = (a.gate[gi, src].reshape(-1, 1) * filled.float()).to(xg.dtype)
        # each token's k assignments (ascending expert id): their rows of
        # the buffer, kept where they passed capacity in this column
        e_c, r_c, w_c, keep = _by_token(a, xg.dtype, k)
        if nc < x_:  # the buffer's rows are the column's experts
            local = torch.full((x_,), -1, dtype=torch.long, device=dev)
            local[sel] = torch.arange(nc, device=dev)
            l_c = local[e_c]
            keep = keep & (l_c >= 0)
            w_c = torch.where(l_c >= 0, w_c, torch.zeros_like(w_c))
            e_c = torch.clamp(l_c, min=0)
        tok_slot = (e_c * gc + r_c).reshape(-1, k)
        buf = _Gather.apply(xg.reshape(-1, e), slot_tok, filled.to(xg.dtype), tok_slot,
                            keep.reshape(-1, k).to(xg.dtype)).reshape(nc, gc, e)

    with spans.span("moe_experts"):
        w = {name: p[name] for name in ("wg", "wu", "wd")}  # (X_local, ...)
        if move:  # the slots go to their experts
            xl = nc // rows
            got = plan.experts.all_to_all(buf.reshape(rows, xl, gc, e))
            buf = got.transpose(0, 1).reshape(xl, rows * gc, e)
        elif rows > 1:  # the column's weights come to the slots
            w = {name: plan.experts.gather(t) for name, t in w.items()}
        hg = torch.bmm(buf, w["wg"])
        hu = torch.bmm(buf, w["wu"])
        out_buf = torch.bmm(F.silu(hg) * hu, w["wd"])
        if move:  # and the outputs come back
            out_buf = out_buf.reshape(xl, rows, gc, e).transpose(0, 1)
            out_buf = plan.experts.all_to_all(out_buf.contiguous()).reshape(nc, gc, e)

    # each token's k weighted expert outputs, summed in the parameter dtype
    # in the reference's order (ascending expert id), one rounding an add;
    # no scatter, forward or backward, so no order is left to the device
    with spans.span("moe_combine"):
        out = _Gather.apply(out_buf.reshape(-1, e), tok_slot, w_c.reshape(-1, k), slot_tok,
                            slot_gate)
    return out.reshape(g_, t_g, e)


def moe_ffn(p: dict, x: torch.Tensor, cfg: ArchConfig, *, n_groups: int = 0,
            plan=None) -> torch.Tensor:
    """x: (B, S, E). Groups default to B (one sequence each); capacity =
    T_g·k·cf / X per group. Under a tensor-parallel ``plan`` the routed
    part's input is the data row's whole sequence (all-gathered along S
    under ``seq_shard``); where the experts are split on the model axis its
    output is each model rank's partial sum (added over the axis), and the
    router, used on a part of the work, has its gradient summed over it.
    Where they are whole every model rank computes them all (keeping its
    own positions under ``seq_shard``)."""
    partial = plan is not None and "model" in plan.experts.axes and plan.size > 1
    seq_shard = plan is not None and plan.seq_shard
    # the whole weights a rank uses on a part of the work: the router where
    # the experts split over model, every weight under seq_shard otherwise
    whole = ("w_router",) if partial else ("w_router", "wg", "wu", "wd")
    pw = {name: plan.copy_to(t) if (partial or seq_shard) and name in whole else t
          for name, t in p.items()}
    xs = plan.gather_seq(x) if seq_shard else (plan.copy_to(x) if partial else x)
    b, s, e = xs.shape
    g = n_groups or b
    t = b * s
    assert t % g == 0, (t, g)
    t_g = t // g
    # its backward pass is the span moe.bwd
    out = spans.backward_span(
        "moe", (xs.reshape(g, t_g, e),),
        lambda xg: _moe_groups(xg, pw, cfg, capacity(t_g, cfg), plan)).reshape(b, s, e)
    if partial:
        out = plan.scatter_seq(out) if seq_shard else plan.reduce_from(out)
    elif seq_shard:  # every model rank computed every position: keep its own
        a, z = plan.block(s)
        out = out[:, a:z]
    from repro_torch.distributed.ctx import constrain

    out = constrain(out, "resid")
    if cfg.n_shared_experts:
        out = out + swiglu(x, p["ws_g"], p["ws_u"], p["ws_d"], plan)
    return out
