"""Tensor-parallel compute on the mesh's ``model`` axis.

The reference jits its steps with the params placed by ``DEFAULT_RULES``
(``heads``, ``kv_heads``, ``mlp`` and ``vocab`` on ``model``: Megatron's
layout), and GSPMD then computes every projection on its shard and
inserts the collectives between them. No JAX module spells that program
out; this module is its counterpart for the port's plain local tensors:

* :class:`Plan` — the model-axis process group, this rank's index along it,
  and which logical dims of the weights are split, **read from the
  weights' placements** (:func:`plan_for`), never assumed: yi-34b's 56
  heads do not divide a 16-way axis, so its attention stays whole and runs
  on every model rank (the reference's ``spec_for`` fallback) while its
  MLP and vocab are split; 8 kv heads on 16 stay whole, and each rank
  reads the view of them its q heads need.
* The collectives, each an autograd function (Megatron's f/g pair and the
  sequence-parallel pair), built on ``torch.distributed``'s functional
  collectives so a trace (``launch/hlo_stats.py``'s ``StepCounter``) sees
  them as ``_c10d_functional`` ops:

    =====================  =========================  ========================
    ``Plan`` method        forward                    backward
    =====================  =========================  ========================
    ``copy_to``            identity                   all-reduce
    ``reduce_from``        all-reduce                 identity
    ``gather_seq``         all-gather along S         reduce-scatter along S
    ``scatter_seq``        reduce-scatter along S     all-gather along S
    ``split_seq``          this rank's S block        all-gather along S
    =====================  =========================  ========================

  and ``all_reduce``, ``all_gather``, ``reduce_scatter`` without a
  gradient. ``copy_to`` also marks a whole weight that a rank uses on its own
  part of the work (a norm scale on its rows under ``seq_shard``, ``q_norm``
  on its heads): the rank's gradient of it is a partial sum, and the
  all-reduce makes it whole on every rank.
* :class:`SeqParallel` — the ``resid`` constraint of ``seq_shard``
  (``distributed/ctx.py``): the residual stream between layers is each
  rank's block of the sequence.

With no plan (no mesh, a model axis of size 1, or a family that still
computes on gathered weights) the model runs its plain code, so a 1×1
mesh is the unsharded model bit for bit.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

# the families whose layers are plain GQA and a dense FFN: computed here;
# every other family gathers its weights (ROADMAP queue 1, the mesh)
TP_FAMILIES = ("dense", "vlm")


def later_items(cfg) -> str:
    """The ROADMAP items (queue 1, item 4) that bring ``cfg``'s family to
    tensor-parallel compute; until then its steps gather the weights."""
    items = []
    if cfg.moe:
        items.append("4d (MoE expert-parallel compute and moe_buf_shard)")
    if cfg.mla:
        items.append("4e (MLA heads)")
    if cfg.ssm or cfg.mlstm:
        items.append("4f (the hybrid and mLSTM mixers)")
    if cfg.encdec:
        items.append("4g (the encoder-decoder)")
    return "ROADMAP queue 1, item " + " and ".join(items)


def compute_path(cfg) -> str:
    """``"tp"`` for a family whose sharded steps compute on their shards
    (:data:`TP_FAMILIES`: plain GQA and a dense FFN), ``"gathered"`` for
    one whose steps still gather every weight (:func:`later_items`)."""
    plain = not (cfg.moe or cfg.mla or cfg.ssm or cfg.mlstm or cfg.encdec)
    return "tp" if cfg.family in TP_FAMILIES and plain else "gathered"


@dataclass(frozen=True)
class Plan:
    """What is split on the model axis, and the axis itself.

    ``vocab``: the embedding tables' rows; ``heads``: q heads (``wq``,
    ``bq``, ``wo``); ``kv_heads``: k/v heads; ``mlp``: the FFN's hidden
    units. ``seq_shard``: the residual stream is split along S between
    layers. ``cache_seq``: ``(start, stop, length)`` of this rank's block of
    the decode cache's positions (the serve steps set it)."""

    group: Any
    size: int
    rank: int
    vocab: bool
    heads: bool
    kv_heads: bool
    mlp: bool
    seq_shard: bool = False
    cache_seq: tuple[int, int, int] | None = None

    def with_(self, **kw) -> "Plan":
        return dataclasses.replace(self, **kw)

    def block(self, n: int) -> tuple[int, int]:
        """``(start, stop)`` of this rank's block of ``n`` split evenly."""
        if n % self.size:
            raise ValueError(f"{n} does not split {self.size} ways")
        k = n // self.size
        return self.rank * k, (self.rank + 1) * k

    def head_ranges(self, n_heads: int, n_kv_heads: int) -> tuple[int, int, int, int]:
        """``(h0, h1, k0, k1)``: this rank's q heads and the kv heads they
        read, all as global head indices. Where only q heads are split, a
        rank's heads must read one kv head each ``G_local`` of them: its
        heads a whole number of kv groups, or a part of one group."""
        if not self.heads:
            return 0, n_heads, 0, n_kv_heads
        h0, h1 = self.block(n_heads)
        if self.kv_heads:
            return (h0, h1) + self.block(n_kv_heads)
        g = n_heads // n_kv_heads
        k0, k1 = h0 // g, (h1 - 1) // g + 1
        if (h1 - h0) % (k1 - k0) or (h1 - h0 >= g and h0 % g) or (h1 - h0 < g and g % (h1 - h0)):
            raise ValueError(f"q heads [{h0}, {h1}) read kv heads [{k0}, {k1}) unevenly "
                             f"(G = {g}): K3 needs G_local q heads a kv head")
        return h0, h1, k0, k1

    # the collectives on this plan's axis (the model code reaches them
    # through the plan it is given, and imports nothing of the mesh)
    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` reduced (``"sum"`` or ``"max"``) over the model axis; no
        gradient."""
        return _all_reduce(x, self, op)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The model ranks' ``x`` concatenated along ``dim`` in rank
        order; no gradient."""
        return _all_gather(x, self, dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block along ``dim`` of the model ranks' sum; no
        gradient."""
        return _reduce_scatter(x, self, dim)

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        """Identity; the gradient all-reduced over the model axis
        (Megatron's f: the input of a split region, or a whole weight used
        on a rank's part of the work)."""
        return _CopyTo.apply(x, self)

    def reduce_from(self, x: torch.Tensor) -> torch.Tensor:
        """The model ranks' partial sums added (Megatron's g: the output
        of a row-parallel product); the gradient passes as it is."""
        return _ReduceFrom.apply(x, self)

    def gather_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole sequence from each rank's block (entering a split
        region under ``seq_shard``); the gradient reduce-scattered back."""
        return _GatherSeq.apply(x, self, dim)

    def scatter_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's sequence block of the partial sums' total (leaving
        a split region under ``seq_shard``); the gradient all-gathered."""
        return _ScatterSeq.apply(x, self, dim)

    def split_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's block along ``dim`` of a tensor every model rank
        holds whole; the gradient all-gathered (so each rank's
        whole-tensor gradient is the same)."""
        return _SplitSeq.apply(x, self, dim)


def _splits_on_model(sharding, dim: int) -> bool:
    from repro_torch.distributed.sharding import entry_axes

    spec = sharding.spec
    axes = entry_axes(spec[dim]) if dim < len(spec) else ()
    if "model" in axes and axes != ("model",):
        raise ValueError(f"spec {tuple(spec)} splits dim {dim} over {axes}: tensor-parallel "
                         "compute takes the model axis alone")
    return "model" in axes


def plan_for(cfg, params_shardings: Any, mesh, *, seq_shard: bool = False) -> Plan | None:
    """The :class:`Plan` of ``cfg``'s params placed by ``params_shardings``
    (a :class:`~repro_torch.distributed.sharding.NamedSharding` tree) on
    ``mesh``; ``None`` where the mesh has no model axis or it has size 1
    (nothing to split: the model's plain code runs). Raises for a family
    outside :data:`TP_FAMILIES` and for layer groups split differently."""
    from repro_torch.distributed.sharding import axis_sizes
    from repro_torch.utils import flatten_with_paths

    if compute_path(cfg) != "tp":
        raise ValueError(f"{cfg.name} ({cfg.family}) has no tensor-parallel compute")
    if axis_sizes(mesh).get("model", 1) == 1:
        return None
    flat, _ = flatten_with_paths(params_shardings)
    vocab = {_splits_on_model(flat[p], 0) for p in ("embed", "unembed") if p in flat}
    groups = sorted({p.split("/")[1] for p in flat if p.startswith("blocks/")})
    dims = {(_splits_on_model(flat[f"blocks/{g}/attn/wq"], 2),
             _splits_on_model(flat[f"blocks/{g}/attn/wk"], 2),
             _splits_on_model(flat[f"blocks/{g}/ffn/wg"], 2)) for g in groups}
    if len(vocab) != 1 or len(dims) != 1:
        raise ValueError(f"embedding tables or layer groups split differently: {vocab} {dims}")
    (heads, kv_heads, mlp), = dims
    plan = Plan(group=mesh.get_group("model"), size=axis_sizes(mesh)["model"],
                rank=mesh.get_local_rank("model"), vocab=vocab.pop(), heads=heads,
                kv_heads=kv_heads, mlp=mlp, seq_shard=seq_shard)
    plan.head_ranges(cfg.n_heads, cfg.n_kv_heads)  # raises for a layout K3 cannot take
    return plan


# ---------------------------------------------------------------------------
# collectives on the model axis
# ---------------------------------------------------------------------------


def _ops():
    return torch.ops._c10d_functional


def _all_reduce(x: torch.Tensor, plan: Plan, op: str = "sum") -> torch.Tensor:
    f = _ops()
    return f.wait_tensor(f.all_reduce(x.contiguous(), op, plan.group.group_name))


def _all_gather(x: torch.Tensor, plan: Plan, dim: int) -> torch.Tensor:
    f = _ops()
    dim %= x.dim()
    out = f.wait_tensor(f.all_gather_into_tensor(x.contiguous(), plan.size,
                                                 plan.group.group_name))
    if dim == 0:
        return out
    out = out.view((plan.size,) + tuple(x.shape))  # (ranks, ...) -> next to dim
    return out.movedim(0, dim).flatten(dim, dim + 1)


def _reduce_scatter(x: torch.Tensor, plan: Plan, dim: int) -> torch.Tensor:
    f = _ops()
    dim %= x.dim()
    if x.shape[dim] % plan.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {plan.size} ways")
    if dim:  # the blocks along dim, each rank's first
        x = x.unflatten(dim, (plan.size, -1)).movedim(dim, 0)
    out = f.wait_tensor(f.reduce_scatter_tensor(x.contiguous(), "sum", plan.size,
                                                plan.group.group_name))
    return out[0] if dim else out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.plan), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan):
        return _all_reduce(x, plan)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan, dim):
        ctx.plan, ctx.dim = plan, dim
        return _all_gather(x, plan, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.plan, ctx.dim), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan, dim):
        ctx.plan, ctx.dim = plan, dim
        return _reduce_scatter(x, plan, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.plan, ctx.dim), None, None


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan, dim):
        ctx.plan, ctx.dim = plan, dim
        a, b = plan.block(x.shape[dim])
        return x.narrow(dim, a, b - a).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.plan, ctx.dim), None, None


@dataclass(frozen=True)
class SeqParallel:
    """The ``resid`` constraint of ``seq_shard`` on plain local tensors:
    a (B, S, E) stream of the whole sequence of ``length`` positions becomes
    this rank's S block (:func:`split_seq`); a stream that is already that
    block passes as it is. Inside a layer the stream is gathered along S
    before the attention and the FFN and reduce-scattered after them."""

    plan: Plan
    length: int

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.plan.block(self.length)
        if x.shape[1] == self.length:
            return self.plan.split_seq(x)
        if x.shape[1] == b - a:
            return x
        raise ValueError(f"a residual stream of {x.shape[1]} positions is neither the "
                         f"sequence ({self.length}) nor this rank's block of it ({b - a})")
