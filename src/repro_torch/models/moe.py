"""Mixture-of-Experts FFN: sort-based grouped dispatch.

Port of the JAX package's ``repro/models/moe.py``. Tokens are routed per
*group* (a group is one sequence by default), each token's top-k
assignments are sorted by expert id (a stable sort), positioned against
each expert's first assignment by binary search, and scattered into a
capacity-bounded buffer that feeds one batched product per expert
(``xce,xef->xcf``). Over-capacity assignments are dropped: their position
is clamped to the last slot and their value and combine weight are
multiplied by zero, not skipped, as in the reference.

The groups of a call share one buffer of shape (X, G·C, E): group ``g``'s
slot ``c`` of expert ``x`` is row ``g·C + c``, so all groups' expert
products are one ``torch.bmm`` over X, where the reference vmaps
``_moe_group`` over G. The dispatch is ``index_put`` with
``accumulate=True`` (the reference's ``.at[...].add``): a slot receives one
kept value and the zeros of dropped assignments, so its sum is exact in any
order. The combine gathers each token's k outputs and adds them in the
reference's order (see ``_moe_groups``) with no scatter. Every form is
deterministic on the card and under ``torch.use_deterministic_algorithms``;
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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.profiler import record_function

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


def _moe_groups(xg: torch.Tensor, p: dict, cfg: ArchConfig, capacity: int) -> torch.Tensor:
    """Route G token groups at once. xg: (G, T_g, E) -> (G, T_g, E). The
    three phases run under profiler ranges (``moe_dispatch``,
    ``moe_experts``, ``moe_combine``) that a trace groups its kernels by."""
    g_, t_g, e = xg.shape
    x_, k = cfg.n_experts, cfg.top_k
    dev = xg.device
    n = t_g * k
    with record_function("moe_dispatch"):
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
        keep = pos < capacity
        # rows of the shared buffer: group g's slot c of an expert is g*C + c
        row = torch.arange(g_, device=dev)[:, None] * capacity + torch.clamp(pos, max=capacity - 1)
        gsel = torch.arange(g_, device=dev)[:, None].expand(g_, n)
        vals_in = xg[gsel, tid_s] * keep[..., None].to(xg.dtype)  # (G, n, E)
        buf = torch.zeros((x_, g_ * capacity, e), dtype=xg.dtype, device=dev)
        buf = buf.index_put((eid_s.reshape(-1), row.reshape(-1)), vals_in.reshape(-1, e),
                            accumulate=True)
        from repro_torch.distributed.ctx import constrain

        buf = constrain(buf, "moe_buf")

    with record_function("moe_experts"):
        hg = torch.bmm(buf, p["wg"])
        hu = torch.bmm(buf, p["wu"])
        out_buf = torch.bmm(F.silu(hg) * hu, p["wd"])  # (X, G*C, E)

    # each token's k weighted expert outputs, summed in the parameter dtype
    # in the reference's order (its scatter-add applies the sorted
    # assignments in turn: a token's in ascending expert id), one rounding
    # an add; no scatter, so no order is left to the device
    with record_function("moe_combine"):
        w = (gat_s * keep.float()).to(xg.dtype)
        inv = torch.argsort(order, dim=1)  # each assignment's place in the sorted order
        ps = torch.sort(inv.reshape(g_, t_g, k), dim=-1).values.reshape(g_, n)
        e_c, r_c, w_c = (torch.gather(t, 1, ps) for t in (eid_s, row, w))
        vals_out = (out_buf[e_c, r_c] * w_c[..., None]).reshape(g_, t_g, k, e)
        out = vals_out[:, :, 0]
        for j in range(1, k):
            out = out + vals_out[:, :, j]
    return out


def capacity(t_g: int, cfg: ArchConfig) -> int:
    """Slots per expert and group: ``T_g·k·cf / X``, at least 1."""
    return max(1, int(t_g * cfg.top_k * cfg.capacity_factor / cfg.n_experts))


def moe_ffn(p: dict, x: torch.Tensor, cfg: ArchConfig, *, n_groups: int = 0) -> torch.Tensor:
    """x: (B, S, E). Groups default to B (one sequence each); capacity =
    T_g·k·cf / X per group."""
    b, s, e = x.shape
    g = n_groups or b
    t = b * s
    assert t % g == 0, (t, g)
    t_g = t // g
    out = _moe_groups(x.reshape(g, t_g, e), p, cfg, capacity(t_g, cfg)).reshape(b, s, e)
    from repro_torch.distributed.ctx import constrain

    out = constrain(out, "resid")
    if cfg.n_shared_experts:
        out = out + swiglu(x, p["ws_g"], p["ws_u"], p["ws_d"])
    return out
