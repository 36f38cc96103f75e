"""The plain reference: the configurations' models in float32 PyTorch.

Written from the models' equations, with no kernel, cache or batching of
the program's; it imports nothing of the program (``guard.py`` checks). A
model is a flat ``{path: float32 tensor}`` of the weights the benchmark
made (``weights.py``), the layer axis first, and a configuration file's
numbers:

* a decoder of ``n_layers`` blocks ``h = x + mixer(rmsnorm(x))``, ``x' = h +
  ffn(rmsnorm(h))``, a final RMSNorm, logits against the (tied or own)
  unembedding;
* the mixer: GQA attention with RoPE (half rotation), causal, within a
  sliding window where ``window`` is set (key j seen by query i where
  ``i - window < j <= i``); for ``ssm``, the mean of that attention and an
  SSD branch (Mamba-2's scalar-decay recurrence ``S_t = a_t S_{t-1} + k_t
  v_t^T``, ``y_t = S_t^T q_t``, with ``a_t = exp(-dt_t exp(A_log))``,
  ``dt = softplus(x w_dt + dt_bias)``, ``v = dt x w_x``, ``k = x w_B``,
  ``q = x w_C``, plus ``D`` times ``x w_x``), computed exactly over chunks;
* the FFN: SwiGLU, or for ``moe`` a softmax router over all experts
  (top-k, ties to the lower index, gates the softmax of the k chosen
  logits), every token one routing group, each expert taking its first
  ``capacity`` assignments in token order (the configuration's
  ``capacity_factor``) and dropping the rest;
* the loss: the mean cross-entropy of float32 logits; training takes
  AdamW (a global-norm clip, bias-corrected moments, decoupled weight
  decay on every leaf) at the traffic's warmup-cosine learning rate.

Matrix products run in float32 with TF32 off (:func:`float32_products`).
With ``precision="fp8"`` (the comparison's control) every product of what
the configuration keeps in bf16 (projections, experts, attention's two
products, the unembedding) takes its operands rounded to float8 e4m3, one
scale a tensor, and its backward takes the output's gradient rounded to
e5m2: the router and the recurrence stay float32, as the configuration
states them.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _fake_quant(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Fp8(torch.autograd.Function):
    """Operands rounded to e4m3 going forward; the gradient passes through."""

    @staticmethod
    def forward(ctx, t):
        return _fake_quant(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Grad(torch.autograd.Function):
    """Identity going forward; the gradient rounded to e5m2 going back."""

    @staticmethod
    def forward(ctx, t):
        return t

    @staticmethod
    def backward(ctx, g):
        return _fake_quant(g, torch.float8_e5m2, E5M2_MAX)


def _mm(a, b, prec):
    if prec == "fp8":
        return _Fp8Grad.apply(_Fp8.apply(a) @ _Fp8.apply(b))
    return a @ b


def _ein(eq, a, b, prec):
    if prec == "fp8":
        return _Fp8Grad.apply(torch.einsum(eq, _Fp8.apply(a), _Fp8.apply(b)))
    return torch.einsum(eq, a, b)


@contextlib.contextmanager
def float32_products():
    """float32 matrix products in full precision (no TF32) in the body."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def _hd(cfg):
    return cfg["head_dim"] or cfg["d_model"] // cfg["n_heads"]


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """x (B, S, H, D), positions 0..S-1: the half rotation."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(x.shape[1], dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window: int, prec, block: int = 1024):
    """Causal GQA softmax attention, q (B, S, H, D), k/v (B, S, KV, D);
    query head h reads kv head h // (H / KV). Query blocks of ``block``
    rows, each against the keys it can see."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, d) * d ** -0.5
    outs = []
    for q0 in range(0, s, block):
        q1 = min(s, q0 + block)
        k0 = max(0, q0 - window + 1) if window else 0
        sc = _ein("bqngd,bknd->bngqk", qg[:, q0:q1], k[:, k0:q1], prec)
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        kpos = torch.arange(k0, q1, device=q.device)[None, :]
        seen = kpos <= qpos
        if window:
            seen = seen & (kpos > qpos - window)
        pr = torch.softmax(sc.masked_fill(~seen, float("-inf")), dim=-1)
        o = _ein("bngqk,bknd->bqngd", pr, v[:, k0:q1], prec)
        outs.append(o.reshape(b, q1 - q0, h, d))
    return torch.cat(outs, dim=1)


def gqa(w, i, x, cfg, prec):
    b, s, e = x.shape
    h, kv, d = cfg["n_heads"], cfg["n_kv_heads"], _hd(cfg)
    g = "blocks/g0/attn/"
    q = _mm(x, w[g + "wq"][i].reshape(e, h * d), prec).view(b, s, h, d)
    k = _mm(x, w[g + "wk"][i].reshape(e, kv * d), prec).view(b, s, kv, d)
    v = _mm(x, w[g + "wv"][i].reshape(e, kv * d), prec).view(b, s, kv, d)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    o = attention(q, k, v, cfg["window"], prec)
    return _mm(o.reshape(b, s, h * d), w[g + "wo"][i].reshape(h * d, e), prec)


def recurrence(q, k, v, log_a, chunk: int):
    """y_t = sum_{j<=t} (q_t . k_j) exp(sum_{j<u<=t} log a_u) v_j, exactly,
    over chunks of ``chunk`` positions: the products inside a chunk at
    once (the weights above the diagonal exactly 0), the state carried
    from chunk to chunk. q, k (B, S, H, N), v (B, S, H, P), log_a (B, S, H)."""
    b, s, h, n = q.shape
    p = v.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        log_a = F.pad(log_a, (0, 0, 0, pad))
    qc, kc, vc = (t.reshape(b, nc, chunk, h, t.shape[-1]) for t in (q, k, v))
    cum = torch.cumsum(log_a.reshape(b, nc, chunk, h), dim=2)  # inclusive, in-chunk
    ch = cum.transpose(2, 3)  # (B, nc, H, Q)
    lower = torch.ones(chunk, chunk, dtype=torch.bool, device=q.device).tril()
    decay = torch.exp((ch[..., :, None] - ch[..., None, :]).masked_fill(~lower, float("-inf")))
    y = torch.einsum("bchij,bcjhp->bcihp", torch.einsum("bcihn,bcjhn->bchij", qc, kc) * decay,
                     vc)
    last = cum[:, :, -1]  # (B, nc, H)
    part = torch.einsum("bcjhn,bcjhp->bchnp", kc * torch.exp(last[:, :, None] - cum)[..., None],
                        vc)
    state = q.new_zeros(b, h, n, p)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * torch.exp(last[:, c])[..., None, None] + part[:, c]
    y = y + torch.einsum("bcihn,bchnp->bcihp", qc * torch.exp(cum)[..., None],
                         torch.stack(entering, dim=1))
    return y.reshape(b, nc * chunk, h, p)[:, :s]


def ssd(w, i, x, cfg, prec):
    b, s, e = x.shape
    h, d, n = cfg["n_heads"], _hd(cfg), cfg["ssm_state"]
    g = "blocks/g0/ssd/"
    xs = _mm(x, w[g + "wx"][i].reshape(e, h * d), prec).view(b, s, h, d)
    kk = _mm(x, w[g + "wB"][i].reshape(e, h * n), prec).view(b, s, h, n)
    qq = _mm(x, w[g + "wC"][i].reshape(e, h * n), prec).view(b, s, h, n)
    dt = F.softplus(_mm(x, w[g + "w_dt"][i], prec) + w[g + "dt_bias"][i])
    log_a = -dt * torch.exp(w[g + "A_log"][i])
    y = recurrence(qq, kk, xs * dt[..., None], log_a, cfg["chunk"])
    y = y + xs * w[g + "D"][i][:, None]
    return _mm(y.reshape(b, s, h * d), w[g + "wo"][i].reshape(h * d, e), prec)


def swiglu(x, wg, wu, wd, prec):
    return _mm(F.silu(_mm(x, wg, prec)) * _mm(x, wu, prec), wd, prec)


def moe(w, i, x, cfg, prec):
    """Every token of the call one routing group (the batch rows in order)."""
    b, s, e = x.shape
    t = b * s
    xf = x.reshape(t, e)
    g = "blocks/g0/ffn/"
    n_exp, k = cfg["n_experts"], cfg["top_k"]
    logits = xf @ w[g + "w_router"][i]  # float32, as the configuration states it
    idx = torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :k]
    gates = torch.softmax(torch.gather(logits, -1, idx), dim=-1)
    cap = max(1, int(t * k * cfg["capacity_factor"] / n_exp))
    out = torch.zeros_like(xf)
    for ex in range(n_exp):
        hit = idx == ex  # (T, k), one True at most a row
        rows = hit.any(-1).nonzero().squeeze(-1)[:cap]  # in token order
        if rows.numel() == 0:
            continue
        gate = (gates * hit).sum(-1)[rows]
        y = swiglu(xf[rows], w[g + "wg"][i][ex], w[g + "wu"][i][ex], w[g + "wd"][i][ex], prec)
        out = out.index_add(0, rows, y * gate[:, None])
    return out.view(b, s, e)


def block(x, i, w, cfg, prec):
    eps = cfg["norm_eps"]
    xin = rmsnorm(x, w["blocks/g0/ln1"][i], eps)
    if cfg.get("ssm"):
        y = 0.5 * (gqa(w, i, xin, cfg, prec) + ssd(w, i, xin, cfg, prec))
    else:
        y = gqa(w, i, xin, cfg, prec)
    h = x + y
    hin = rmsnorm(h, w["blocks/g0/ln2"][i], eps)
    if cfg.get("moe"):
        return h + moe(w, i, hin, cfg, prec)
    g = "blocks/g0/ffn/"
    return h + swiglu(hin, w[g + "wg"][i], w[g + "wu"][i], w[g + "wd"][i], prec)


def hidden(w, tokens, cfg, prec, remat: bool):
    """Final hidden states (B, S, E); with ``remat`` each layer recomputed
    in the backward pass (its input alone kept)."""
    x = F.embedding(tokens.long(), w["embed"])
    for i in range(cfg["n_layers"]):
        fn = functools.partial(block, i=i, w=w, cfg=cfg, prec=prec)
        x = checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False) if remat else fn(x)
    return rmsnorm(x, w["final_norm"], cfg["norm_eps"])


def _unembed(w, cfg):
    return w["embed"] if cfg["tie_embeddings"] else w["unembed"]


def _xent_sum(h, emb, labels, prec):
    logits = _mm(h, emb.T, prec)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0).long()[:, None])[:, 0]
    return ((lse - gold) * (labels >= 0)).sum()


def loss(w, batch, cfg, prec="fp32", rows: int = 4096):
    """Mean next-token cross-entropy over the labels >= 0."""
    h = hidden(w, batch["tokens"], cfg, prec, remat=True)
    e = h.shape[-1]
    hf, lab = h.reshape(-1, e), batch["labels"].reshape(-1)
    emb = _unembed(w, cfg)
    tot = sum(checkpoint(_xent_sum, hf[r:r + rows], emb, lab[r:r + rows], prec,
                         use_reentrant=False, preserve_rng_state=False)
              for r in range(0, hf.shape[0], rows))
    return tot / (lab >= 0).sum().clamp(min=1)


@torch.no_grad()
def logits_at(w, tokens, positions, cfg, prec="fp32"):
    """float32 logits (len(positions), V) of one sequence ``tokens`` (S,)."""
    h = hidden(w, tokens[None], cfg, prec, remat=False)[0, positions]
    return _mm(h, _unembed(w, cfg).T, prec)


def warmup_cosine(step: int, peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    s = float(step)
    if s < warmup:
        return peak_lr * min(s / max(warmup, 1), 1.0)
    frac = min(max((s - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak_lr * (floor + (1 - floor) * 0.5 * (1 + math.cos(frac * math.pi)))


def leaf_norms(tensors: dict) -> dict[str, float]:
    """``{path: float32 2-norm}``, read back in one transfer."""
    paths = list(tensors)
    norms = torch.stack([tensors[p].detach().float().norm() for p in paths]).tolist()
    return dict(zip(paths, norms))


def train(w0: dict, batches: list, cfg: dict, opt: dict, prec: str = "fp32") -> dict:
    """AdamW steps from ``w0`` (float32 leaves), one a batch: each step's
    loss and learning rate, the first step's clipped gradient's leaf norms,
    and each leaf's change from ``w0`` after the last step."""
    params = {p: t.detach().clone().requires_grad_(True) for p, t in w0.items()}
    mu = {p: torch.zeros_like(t) for p, t in w0.items()}
    nu = {p: torch.zeros_like(t) for p, t in w0.items()}
    b1, b2 = opt["b1"], opt["b2"]
    losses, lrs, first = [], [], None
    for step, batch in enumerate(batches):
        lv = loss(params, batch, cfg, prec)
        grads = torch.autograd.grad(lv, list(params.values()), allow_unused=True)
        grads = {p: (g if g is not None else torch.zeros_like(params[p]))
                 for p, g in zip(params, grads)}
        gnorm = torch.sqrt(sum(g.pow(2).sum() for g in grads.values()))
        scale = torch.clamp(opt["clip_norm"] / torch.clamp(gnorm, min=1e-9), max=1.0)
        grads = {p: g * scale for p, g in grads.items()}  # as the optimizer gets them
        lr = warmup_cosine(step, opt["peak_lr"], opt["warmup"], opt["total_steps"])
        lrs.append(lr)
        c1, c2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
        with torch.no_grad():
            for p, g in grads.items():
                mu[p].mul_(b1).add_(g, alpha=1 - b1)
                nu[p].mul_(b2).add_(g * g, alpha=1 - b2)
                upd = (mu[p] / c1) / (torch.sqrt(nu[p] / c2) + opt["eps"])
                params[p] -= lr * (upd + opt["weight_decay"] * params[p])
        if step == 0:
            first = leaf_norms(grads)
        losses.append(float(lv.detach()))
        del grads, lv
    change = leaf_norms({p: params[p] - w0[p] for p in params})
    return {"losses": losses, "grad_norms": first, "change_norms": change, "lrs": lrs}
