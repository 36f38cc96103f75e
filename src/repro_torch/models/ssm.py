"""Recurrent mixers: chunkwise linear recurrence, the SSD (Mamba-2 style)
branch, the mLSTM (xLSTM) and a reference sLSTM.

Port of the JAX package's ``repro/models/ssm.py``. The core primitive keeps
a state S_t in R^{N x P} per (batch, head)::

    S_t = a_t · S_{t-1} + k_t ⊗ v_t          a_t ∈ (0, 1]
    y_t = S_tᵀ q_t                            q_t, k_t ∈ R^N, v_t ∈ R^P

evaluated over chunks of Q tokens, with La the inclusive cumsum of log a
within a chunk::

    intra:  y_i += Σ_{j≤i} (q_i·k_j) · exp(La_i − La_j) · v_j   (Q×Q product)
    inter:  y_i += exp(La_i) · S_prevᵀ q_i
    carry:  S_new = exp(La_Q) S_prev + Σ_j exp(La_Q − La_j) k_j ⊗ v_j

The reference scans the chunks one by one. On CUDA tensors the kernels of
``kernels/linear_recurrence`` compute it, forward and backward, in a few
launches a call with no Q×Q tile in device memory. On CPU tensors the
plain version, :func:`_recurrence`, computes every chunk's intra-chunk
tile and carry contribution at once, as (B, nc, H, Q, Q) and (B, nc, H, N,
P) tensors; only the carry itself runs chunk by chunk, in the reference's
order, and the inter-chunk term is again one product over all chunks. Both
compute in float32, the plain version by ``einsum``s as in the reference.

The one difference of substance: the reference exponentiates La_i − La_j
over the whole Q×Q tile and masks the upper triangle afterwards. Above the
diagonal that exponent is minus the decay between j and i, which overflows
to inf once a chunk's log-decays sum below about −88; the forward stays
finite (the mask selects 0), but the backward multiplies 0 by inf and the
gradients of q, k and log a become NaN (hymba at full width reaches −99.6
on average with the reference's init). Here the upper triangle's exponent
is set to −inf before ``exp`` (the kernels never exponentiate it), so its
weight is exactly 0 and so is its gradient; every entry the reference
keeps is computed the same way.

Under a tensor-parallel plan (``distributed/tp.py``) both mixers run on
the rank's heads, as the reference's GSPMD program does: every leaf on the
``heads`` axis (``wx``, ``wB``, ``wC``, ``w_dt``, ``dt_bias``, ``A_log``,
``D``; the mLSTM's ``wq``, ``wk``, ``wv``, ``w_og``, ``w_i``, ``w_f``,
``f_bias``) column-parallel, ``wo`` row-parallel, the chunked recurrence
over the rank's heads and the whole sequence. The mLSTM's ``ln_out`` is
one RMSNorm over every head's features, so a rank's sum of squares is
added over the model axis with a gradient that is added too
(``Plan.psum``), and its whole scale is used on the rank's block of
features (``copy_to``). The decode state stays whole on the heads
(``CACHE_RULES``): each rank computes its heads' part and the parts are
all-gathered into it.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.linear_recurrence import linear_recurrence
from repro_torch.models.layers import init_const, init_dense, pdtype, rmsnorm


def chunked_linear_recurrence(
    q: torch.Tensor,  # (B, S, H, N)
    k: torch.Tensor,  # (B, S, H, N)
    v: torch.Tensor,  # (B, S, H, P)
    log_a: torch.Tensor,  # (B, S, H) log-decay, <= 0
    *,
    chunk: int,
    initial_state: torch.Tensor | None = None,  # (B, H, N, P)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, H, P) float32, final_state (B, H, N, P) float32):
    the plain :func:`_recurrence` on CPU tensors, the CUDA kernels
    otherwise. The forward runs under the span ``linear_recurrence``; its
    backward pass is the span ``linear_recurrence.bwd``."""
    with spans.span("linear_recurrence"):
        ins = (q, k, v, log_a) + (() if initial_state is None else (initial_state,))
        fn = _recurrence if all(t.device.type == "cpu" for t in ins) else linear_recurrence
        return spans.backward_span("linear_recurrence", ins, functools.partial(fn, chunk=chunk))


def _recurrence(q, k, v, log_a, initial_state=None, *, chunk: int):
    """The plain version, in float32 ``einsum``s (see the module docstring)."""
    b, s, h, n = q.shape
    p = v.shape[-1]
    qf, kf, vf, la = (t.float() for t in (q, k, v, log_a))
    cq = min(chunk, s)
    nc = -(-s // cq)
    pad = nc * cq - s
    if pad:  # log a = 0 -> a = 1 on the padding
        qf, kf, vf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (qf, kf, vf))
        la = F.pad(la, (0, 0, 0, pad))
    qc, kc, vc = (t.reshape(b, nc, cq, h, t.shape[-1]) for t in (qf, kf, vf))
    cum = torch.cumsum(la.reshape(b, nc, cq, h), dim=2)  # (B, nc, Q, H) inclusive
    tot = cum[:, :, -1]  # (B, nc, H)

    # intra-chunk, every chunk at once: La_i − La_j masked to −inf above
    # the diagonal before exp (see the module docstring)
    cum_h = cum.transpose(2, 3)  # (B, nc, H, Q)
    dec = cum_h[..., :, None] - cum_h[..., None, :]  # (B, nc, H, i, j)
    upper = torch.ones((cq, cq), dtype=torch.bool, device=q.device).triu(1)
    dec = dec.masked_fill(upper, float("-inf"))
    sc = torch.einsum("bcihn,bcjhn->bchij", qc, kc) * torch.exp(dec)
    y = torch.einsum("bchij,bcjhp->bcihp", sc, vc)

    # each chunk's own contribution to the carry, every chunk at once
    kw = kc * torch.exp(tot[:, :, None] - cum)[..., None]  # (B, nc, Q, H, N)
    contrib = torch.einsum("bcjhn,bcjhp->bchnp", kw, vc)  # (B, nc, H, N, P)

    # the carry, chunk by chunk in the reference's order; prev[c] is the
    # state entering chunk c. Each chunk's decay and contribution are
    # views of one unbind: the backward stacks their gradients once,
    # where indexing each chunk would make and add nc gradients of the
    # whole (B, nc, H, N, P)
    state = (initial_state.float() if initial_state is not None
             else torch.zeros((b, h, n, p), dtype=torch.float32, device=q.device))
    prev = []
    for decay, part in zip(torch.exp(tot)[..., None, None].unbind(1), contrib.unbind(1)):
        prev.append(state)
        state = state * decay + part

    # inter-chunk, every chunk at once
    y = y + torch.einsum("bcihn,bchnp->bcihp", qc * torch.exp(cum)[..., None],
                         torch.stack(prev, dim=1))
    return y.reshape(b, nc * cq, h, p)[:, :s], state


def linear_recurrence_step(
    q: torch.Tensor,  # (B, H, N)
    k: torch.Tensor,
    v: torch.Tensor,  # (B, H, P)
    a: torch.Tensor,  # (B, H) decay in (0, 1]
    state: torch.Tensor,  # (B, H, N, P)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single decode step. Returns (y (B, H, P), new_state)."""
    qf, kf, vf = (t.float() for t in (q, k, v))
    state = state * a[..., None, None].float() + kf[..., :, None] * vf[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", qf, state)
    return y, state


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bse,eh...->bsh...") as one matrix product."""
    return torch.matmul(x, w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _out(y: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("...hd,hde->...e")."""
    return torch.matmul(y.flatten(-2), wo.flatten(0, 1))


def tp_weights(p: dict, cfg: ArchConfig, plan, whole: tuple[str, ...] = ()) -> dict:
    """A recurrent mixer's leaves as this rank computes with them, every
    leaf but those in ``whole`` on the heads axis (the rank's block where
    the heads are split). Where the heads are split, the whole leaves are
    used on the rank's heads: through ``copy_to``, and ``ln_out`` (one
    scale a feature, ``h * dh``) cut to the rank's heads' features. Where
    they are whole under ``seq_shard``, every rank computes every position
    and keeps its own, so each leaf goes through ``copy_to``."""
    if plan is None or not (plan.heads or plan.seq_shard):
        return p
    if not plan.heads:
        return {name: plan.copy_to(t) for name, t in p.items()}
    w = {name: plan.copy_to(t) if name in whole else t for name, t in p.items()}
    if "ln_out" in w:
        h0, h1, _, _ = plan.head_ranges(cfg.n_heads, cfg.n_kv_heads)
        dh = cfg.resolved_head_dim
        w["ln_out"] = w["ln_out"][h0 * dh:h1 * dh]
    return w


def heads_of(state: torch.Tensor, cfg: ArchConfig, plan) -> torch.Tensor:
    """This rank's heads of a decode state (B, H, ...) that is whole on
    the heads (``CACHE_RULES``)."""
    if plan is None or not plan.heads:
        return state
    h0, h1, _, _ = plan.head_ranges(cfg.n_heads, cfg.n_kv_heads)
    return state[:, h0:h1]


def whole_state(state: torch.Tensor, plan) -> torch.Tensor:
    """A decode state (B, H_local, ...) of this rank's heads made whole on
    the heads: the model ranks' parts all-gathered."""
    return plan.all_gather(state, 1) if plan is not None and plan.heads else state


# ---------------------------------------------------------------------------
# SSD branch (hymba's mamba-style heads)
# ---------------------------------------------------------------------------


def init_ssd(gen, cfg: ArchConfig, n_layers: int, device) -> dict:
    e, h = cfg.d_model, cfg.n_heads
    dh, n = cfg.resolved_head_dim, cfg.ssm_state
    dt = pdtype(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wx": init_dense(gen, (n_layers, e, h, dh), ("layers", "embed", "heads", "head_dim"), dt, device),
        "wB": init_dense(gen, (n_layers, e, h, n), ("layers", "embed", "heads", None), dt, device),
        "wC": init_dense(gen, (n_layers, e, h, n), ("layers", "embed", "heads", None), dt, device),
        "w_dt": init_dense(gen, (n_layers, e, h), ("layers", "embed", "heads"), dt, device),
        "dt_bias": init_const((n_layers, h), 0.0, ("layers", "heads"), **f32),
        "A_log": init_const((n_layers, h), 0.0, ("layers", "heads"), **f32),
        "D": init_const((n_layers, h), 1.0, ("layers", "heads"), **f32),
        "wo": init_dense(gen, (n_layers, h, dh, e), ("layers", "heads", "head_dim", "embed"), dt, device),
    }


def _ssd_gates(p, x):
    """(dt (B, S, H) > 0, log_a (B, S, H) <= 0), float32."""
    dt = F.softplus(torch.matmul(x.float(), p["w_dt"].float()) + p["dt_bias"])
    return dt, -dt * torch.exp(p["A_log"])


def _ssd_inputs(p, x):
    xs = _proj(x, p["wx"])  # v
    bb = _proj(x, p["wB"])  # k
    cc = _proj(x, p["wC"])  # q
    dt, log_a = _ssd_gates(p, x)
    return xs, bb, cc, dt, log_a


def _ssd_output(p, y, xs, x_dtype):
    y = y + xs.float() * p["D"][:, None]
    return _out(y.to(x_dtype), p["wo"])


def ssd_apply(p, x, cfg: ArchConfig, initial_state=None):
    """SSD branch forward. x: (B, S, E) -> ((B, S, E), final state
    (B, H, N, P) float32): the reference's ``ssd_train`` and the SSD half
    of its hybrid ``block_prefill``."""
    xs, bb, cc, dt, log_a = _ssd_inputs(p, x)
    v = xs * dt[..., None].to(xs.dtype)  # fold Δ into v
    y, state = chunked_linear_recurrence(cc, bb, v, log_a, chunk=cfg.chunk,
                                         initial_state=initial_state)
    return _ssd_output(p, y, xs, x.dtype), state


def ssd_train(p, x, cfg: ArchConfig):
    """SSD branch forward. x: (B, S, E) -> (B, S, E)."""
    return ssd_apply(p, x, cfg)[0]


def ssd_init_state(cfg: ArchConfig, batch: int, device=None):
    return torch.zeros((batch, cfg.n_heads, cfg.ssm_state, cfg.resolved_head_dim),
                       dtype=torch.float32, device=device)


def ssd_decode(p, x, state, cfg: ArchConfig, plan=None):
    """x: (B, 1, E); state (B, H, N, P) -> (y (B, 1, E), new_state). Under a
    plan on this rank's heads: y the ranks' partial sums (the hybrid adds
    them with its attention's), the new state whole on the heads."""
    xs, bb, cc, dt, log_a = _ssd_inputs(p, x)
    v = xs * dt[..., None].to(xs.dtype)
    y, state = linear_recurrence_step(cc[:, 0], bb[:, 0], v[:, 0], torch.exp(log_a[:, 0]),
                                      heads_of(state, cfg, plan))
    return _ssd_output(p, y[:, None], xs, x.dtype), whole_state(state, plan)


# ---------------------------------------------------------------------------
# mLSTM (xLSTM) block — includes its own projections; no separate FFN
# ---------------------------------------------------------------------------


def init_mlstm(gen, cfg: ArchConfig, n_layers: int, device) -> dict:
    e, h, dh = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    dt = pdtype(cfg)
    heads = ("layers", "embed", "heads", "head_dim")
    p = {nm: init_dense(gen, (n_layers, e, h, dh), heads, dt, device) for nm in ("wq", "wk", "wv")}
    p["w_i"] = init_dense(gen, (n_layers, e, h), ("layers", "embed", "heads"), dt, device)
    p["w_f"] = init_dense(gen, (n_layers, e, h), ("layers", "embed", "heads"), dt, device)
    p["f_bias"] = init_const((n_layers, h), 4.0, ("layers", "heads"), torch.float32, device)
    p["w_og"] = init_dense(gen, (n_layers, e, h, dh), heads, dt, device)
    p["ln_out"] = init_const((n_layers, h * dh), 1.0, ("layers", None), dt, device)
    p["wo"] = init_dense(gen, (n_layers, h, dh, e), ("layers", "heads", "head_dim", "embed"), dt, device)
    return p


def _mlstm_qkvg(p, x, cfg: ArchConfig):
    dh = cfg.resolved_head_dim
    q = _proj(x, p["wq"]) / math.sqrt(dh)
    k = _proj(x, p["wk"]) / math.sqrt(dh)
    v = _proj(x, p["wv"])
    xf = x.float()
    i_g = torch.sigmoid(torch.matmul(xf, p["w_i"].float()))
    log_f = F.logsigmoid(torch.matmul(xf, p["w_f"].float()) + p["f_bias"])
    og = torch.sigmoid(_proj(x, p["w_og"]).float())
    return q, k, v, i_g, log_f, og


def _mlstm_out(p, y, og, x_dtype, cfg: ArchConfig, eps: float, plan=None):
    """The output gate, ``ln_out`` over every head's features and ``wo``:
    under a plan whose heads are split, the rank's heads' features, their
    squares summed over the model axis, and the partial sums of ``wo``."""
    y = y * og  # output gate
    flat = y.flatten(-2).to(x_dtype)
    if plan is not None and plan.heads:
        flat = _rmsnorm_split(flat, p["ln_out"], eps, plan,
                              cfg.n_heads * cfg.resolved_head_dim)
    else:
        flat = rmsnorm(flat, p["ln_out"], eps)
    return _out(flat.unflatten(-1, y.shape[-2:]).to(x_dtype), p["wo"])


def _rmsnorm_split(x: torch.Tensor, scale: torch.Tensor, eps: float, plan,
                   n: int) -> torch.Tensor:
    """``rmsnorm`` over ``n`` features of which ``x`` (..., n / ranks) and
    ``scale`` are this rank's block: the sums of squares added over the
    model axis (``psum``: every rank's normalised block reads every rank's
    squares, so their gradients are added too)."""
    xf = x.float()
    var = plan.psum(torch.sum(xf * xf, dim=-1, keepdim=True)) / n
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def _mlstm_kv(k, v, i_g):
    """(k scaled by the input gate, v with the normaliser's ones column),
    float32."""
    k_eff = k.float() * i_g[..., None]
    v_aug = torch.cat([v.float(), torch.ones(v.shape[:-1] + (1,), device=v.device)], dim=-1)
    return k_eff, v_aug


def _mlstm_normalise(y_aug):
    return y_aug[..., :-1] / torch.clamp(torch.abs(y_aug[..., -1:]), min=1.0)


def mlstm_apply(p, x, cfg: ArchConfig, initial_state=None, plan=None):
    """x: (B, S, E) -> ((B, S, E), final state (B, H, Dh, Dh + 1) float32):
    the reference's ``mlstm_train`` and its mlstm ``block_prefill``. Under
    a plan on this rank's heads (``x`` this rank's positions under
    ``seq_shard``, as the output): the state is the rank's heads'
    (:func:`whole_state` makes it whole)."""
    if plan is not None:
        p, x = tp_weights(p, cfg, plan, whole=("ln_out",)), plan.enter(x)
    q, k, v, i_g, log_f, og = _mlstm_qkvg(p, x, cfg)
    k_eff, v_aug = _mlstm_kv(k, v, i_g)
    y_aug, state = chunked_linear_recurrence(q, k_eff, v_aug, log_f, chunk=cfg.chunk,
                                             initial_state=initial_state)
    y = _mlstm_out(p, _mlstm_normalise(y_aug), og, x.dtype, cfg, cfg.norm_eps, plan)
    return (y if plan is None else plan.leave(y)), state


def mlstm_train(p, x, cfg: ArchConfig, plan=None):
    """x: (B, S, E) -> (B, S, E). Matrix memory C ∈ R^{N×P} with N = P =
    head_dim, normaliser tracked as an extra v-column (h = Cq / max(|n·q|, 1))."""
    return mlstm_apply(p, x, cfg, plan=plan)[0]


def mlstm_init_state(cfg: ArchConfig, batch: int, device=None):
    dh = cfg.resolved_head_dim
    return torch.zeros((batch, cfg.n_heads, dh, dh + 1), dtype=torch.float32, device=device)


def mlstm_decode(p, x, state, cfg: ArchConfig, plan=None):
    """x: (B, 1, E); state (B, H, Dh, Dh + 1) -> (y (B, 1, E), new_state).
    Under a plan on this rank's heads, the new state whole on the heads."""
    if plan is not None:
        p = tp_weights(p, cfg, plan, whole=("ln_out",))
    q, k, v, i_g, log_f, og = _mlstm_qkvg(p, x, cfg)
    k_eff, v_aug = _mlstm_kv(k[:, 0], v[:, 0], i_g[:, 0])
    y_aug, state = linear_recurrence_step(q[:, 0], k_eff, v_aug, torch.exp(log_f[:, 0]),
                                          heads_of(state, cfg, plan))
    out = _mlstm_out(p, _mlstm_normalise(y_aug), og[:, 0], x.dtype, cfg, cfg.norm_eps,
                     plan)[:, None]
    return (out if plan is None else plan.leave(out)), whole_state(state, plan)


# ---------------------------------------------------------------------------
# sLSTM — reference implementation (unit-tested; not used by the 1.3b config)
# ---------------------------------------------------------------------------


def init_slstm(gen, d_model: int, d_hidden: int, dtype=torch.float32, device=None) -> dict:
    def normal(shape, fan):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        return w.normal_(0.0, 1.0, generator=gen).mul_(fan ** -0.5).to(dtype)

    return {"w_in": normal((d_model, 4 * d_hidden), d_model),
            "r": normal((d_hidden, 4 * d_hidden), d_hidden),
            "b": torch.zeros((4 * d_hidden,), dtype=dtype, device=device)}


def slstm_apply(p, x):
    """Scalar-memory sLSTM with exponential gating + stabiliser (paper eq.
    set). x: (B, S, E) -> (B, S, Dh). Strictly sequential (a loop over time)."""
    b, s, _ = x.shape
    dh = p["r"].shape[0]
    zx = torch.matmul(x.float(), p["w_in"].float())
    r, bias = p["r"].float(), p["b"].float()
    c = n = h = m = torch.zeros((b, dh), dtype=torch.float32, device=x.device)
    hs = []
    for t in range(s):
        z = zx[:, t] + torch.matmul(h, r) + bias
        zi, zf, zz, zo = torch.chunk(z, 4, dim=-1)
        m_new = torch.maximum(zf + m, zi)  # stabiliser state
        i = torch.exp(zi - m_new)
        f = torch.exp(zf + m - m_new)
        c = f * c + i * torch.tanh(zz)
        n = f * n + i
        h = torch.sigmoid(zo) * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1)
