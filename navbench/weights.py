"""Weights from the seed, made on the device in one draw.

The benchmark makes the weights, hands the same values to the program and
to the plain reference, and makes them again (the same draw) where a
comparison needs the starting point. The leaves, their shapes and their
initial scales follow from the configuration file alone; the program's
parameter tree must have exactly these paths, shapes and dtypes
(:func:`check_against`).

One ``torch.randn`` in bf16 on the card (drawn in bf16 whatever the
model's dtype, so a float32 configuration in the tests serves the same
values), from a ``torch.Generator`` seeded
with the run's seed, fills every drawn leaf; each leaf is a slice of it,
scaled by 1/sqrt of the dimension its product contracts (the embeddings by
0.02), rounded to the dtype it is served in. Norm scales are 1; the SSD's
``dt_bias`` and ``A_log`` 0 and ``D`` 1, as the program initialises them.
"""

from __future__ import annotations

import math

import torch

from yardstick import head_dim

F32 = torch.float32


def leaf_specs(cfg: dict) -> dict[str, tuple[tuple[int, ...], torch.dtype, object]]:
    """``{path: (shape, dtype, init)}``; ``init`` is a float scale for a
    drawn leaf, or ``("const", value)``."""
    dt = getattr(torch, cfg["dtype"])  # the model's dtype, bfloat16 as configured
    e, v, L = cfg["d_model"], cfg["vocab"], cfg["n_layers"]
    h, kv, dh = cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    spec: dict = {"embed": ((v, e), dt, 0.02)}
    if not cfg["tie_embeddings"]:
        spec["unembed"] = ((v, e), dt, 0.02)
    spec["final_norm"] = ((e,), dt, ("const", 1.0))
    g = "blocks/g0/"
    spec[g + "ln1"] = ((L, e), dt, ("const", 1.0))
    spec[g + "ln2"] = ((L, e), dt, ("const", 1.0))
    spec[g + "attn/wq"] = ((L, e, h, dh), dt, e ** -0.5)
    spec[g + "attn/wk"] = ((L, e, kv, dh), dt, e ** -0.5)
    spec[g + "attn/wv"] = ((L, e, kv, dh), dt, e ** -0.5)
    spec[g + "attn/wo"] = ((L, h, dh, e), dt, (h * dh) ** -0.5)
    if cfg.get("ssm"):
        n = cfg["ssm_state"]
        spec[g + "ssd/wx"] = ((L, e, h, dh), dt, e ** -0.5)
        spec[g + "ssd/wB"] = ((L, e, h, n), dt, e ** -0.5)
        spec[g + "ssd/wC"] = ((L, e, h, n), dt, e ** -0.5)
        spec[g + "ssd/w_dt"] = ((L, e, h), dt, e ** -0.5)
        spec[g + "ssd/dt_bias"] = ((L, h), F32, ("const", 0.0))
        spec[g + "ssd/A_log"] = ((L, h), F32, ("const", 0.0))
        spec[g + "ssd/D"] = ((L, h), F32, ("const", 1.0))
        spec[g + "ssd/wo"] = ((L, h, dh, e), dt, (h * dh) ** -0.5)
    if cfg.get("moe"):
        x, f = cfg["n_experts"], cfg["moe_d_ff"] or cfg["d_ff"]
        spec[g + "ffn/w_router"] = ((L, e, x), F32, e ** -0.5)
        spec[g + "ffn/wg"] = ((L, x, e, f), dt, e ** -0.5)
        spec[g + "ffn/wu"] = ((L, x, e, f), dt, e ** -0.5)
        spec[g + "ffn/wd"] = ((L, x, f, e), dt, f ** -0.5)
    else:
        f = cfg["d_ff"]
        spec[g + "ffn/wg"] = ((L, e, f), dt, e ** -0.5)
        spec[g + "ffn/wu"] = ((L, e, f), dt, e ** -0.5)
        spec[g + "ffn/wd"] = ((L, f, e), dt, f ** -0.5)
    return dict(sorted(spec.items()))


def make(cfg: dict, seed: int, device, dtype_of=None) -> dict[str, torch.Tensor]:
    """The flat ``{path: tensor}`` weights of ``seed`` on ``device``, each
    leaf in its served dtype (``dtype_of(path, dtype)`` may override it:
    the reference takes every leaf as float32, exactly the same values)."""
    specs = leaf_specs(cfg)
    drawn = {p: s for p, s in specs.items() if not isinstance(s[2], tuple)}
    total = sum(math.prod(s[0]) for s in drawn.values())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    buf = torch.randn(total, generator=gen, dtype=torch.bfloat16, device=device)
    out, off = {}, 0
    for path, (shape, dtype, init) in specs.items():
        want = dtype_of(path, dtype) if dtype_of else dtype
        if isinstance(init, tuple):
            out[path] = torch.full(shape, init[1], dtype=want, device=device)
            continue
        n = math.prod(shape)
        leaf = (buf[off:off + n].view(shape) * init).to(dtype)  # rounded as served
        out[path] = leaf.to(want)
        off += n
    del buf
    return out


def nest(flat: dict[str, torch.Tensor]) -> dict:
    """``{"a/b": t}`` as ``{"a": {"b": t}}``."""
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


def flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def check_against(cfg: dict, program_flat: dict) -> None:
    """Raise unless the program's parameter leaves (``{path: tensor or
    spec}``) have exactly the benchmark's paths, shapes and dtypes."""
    want = leaf_specs(cfg)
    got = {p: (tuple(t.shape), t.dtype) for p, t in program_flat.items()}
    exp = {p: (s[0], s[1]) for p, s in want.items()}
    if got != exp:
        diff = sorted(set(got.items()) ^ set(exp.items()), key=str)
        raise ValueError(f"the program's parameters differ from the benchmark's: {diff}")
