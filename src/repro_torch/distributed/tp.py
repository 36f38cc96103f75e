"""Tensor-parallel and expert-parallel compute on the mesh's shards.

The reference jits its steps with the params placed by ``DEFAULT_RULES``
(``heads``, ``kv_heads``, ``mlp`` and ``vocab`` on ``model``: Megatron's
layout; ``experts`` over ``("data", "model")`` where they divide it, else
over ``model``), and GSPMD then computes every product on its shard and
inserts the collectives between them. No JAX module spells that program
out; this module is its counterpart for the port's plain local tensors,
for every family (:func:`compute_path` is ``"tp"`` for each):

* :class:`Plan` — the model-axis process group, this rank's index along it,
  and which logical dims of the weights are split, **read from the
  weights' placements** (:func:`plan_for`), never assumed: yi-34b's 56
  heads do not divide a 16-way axis, so its attention stays whole and runs
  on every model rank (the reference's ``spec_for`` fallback) while its
  MLP and vocab are split; 8 kv heads on 16 stay whole, and each rank
  reads the view of them its q heads need. MLA's heads are read from
  ``wq_b``, ``wkv_b`` and ``wo``; the hybrid's SSD heads from ``ssd/wx``,
  which must split as its attention's q heads do; the mLSTM's from
  ``mlstm/wq``; the encoder–decoder's from its encoder's, decoder's and
  cross attention's ``wq``/``wk`` and its MLPs' ``w_in``. The MoE experts'
  axes are a field of their own (:class:`Experts`): not a model-axis split
  but a block of experts a rank over the flattened ``("data", "model")``
  (or ``model``) axes, with the data axis's group for moving tokens or
  weights within a model column (``models/moe.py``).
* The collectives, each an autograd function (Megatron's f/g pair and the
  sequence-parallel pair), built on ``torch.distributed``'s functional
  collectives so a trace (``launch/hlo_stats.py``'s ``StepCounter``) sees
  them as ``_c10d_functional`` ops:

    =====================  =========================  ========================
    method                 forward                    backward
    =====================  =========================  ========================
    ``Plan.copy_to``       identity                   all-reduce
    ``Plan.reduce_from``   all-reduce                 identity
    ``Plan.psum``          all-reduce                 all-reduce
    ``Plan.gather_seq``    all-gather along S         reduce-scatter along S
    ``Plan.scatter_seq``   reduce-scatter along S     all-gather along S
    ``Plan.split_seq``     this rank's S block        all-gather along S
    ``Experts.all_to_all`` all-to-all over data       the reverse all-to-all
    ``Experts.gather``     all-gather over data       reduce-scatter over data
    =====================  =========================  ========================

  and ``all_reduce``, ``all_gather``, ``reduce_scatter``, ``all_to_all``
  without a gradient. ``copy_to`` also marks a whole weight that a rank uses on its own
  part of the work (a norm scale on its rows under ``seq_shard``, ``q_norm``
  on its heads, the router on its column's experts): the rank's gradient of
  it is a partial sum, and the all-reduce makes it whole on every rank.
  ``psum`` is a sum that every rank's work reads (the mLSTM's ``ln_out``
  over its heads' squares), so each rank's gradient of it is summed too.
  ``Plan.enter`` and ``Plan.leave`` bracket a mixer whose heads may be
  split. On an axis of size 1 each is the identity.
* :class:`SeqParallel` — the ``resid`` constraint of ``seq_shard``
  (``distributed/ctx.py``): the residual stream between layers is each
  rank's block of the sequence.

With no plan (no mesh, or one that splits nothing) the model runs its
plain code, so a 1×1 mesh is the unsharded model bit for bit.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

def compute_path(cfg) -> str:
    """How ``cfg``'s sharded steps compute: ``"tp"``, on their own shards,
    for every family (the steps and the dry run record it)."""
    return "tp"


@dataclass(frozen=True)
class Experts:
    """How a MoE layer's experts lie on the mesh: ``axes`` the mesh axes
    their dim is split over (``("data", "model")``, ``("model",)`` or
    ``()``, whole), ``rows`` the data axis's size where it is among them
    (else 1) and ``group`` its process group. Rank ``(d, m)`` holds block ``d * M + m`` of the experts (``m``
    where only ``model`` splits them): its *column* is the blocks ``d' * M
    + m`` of every data row ``d'``, the experts whose slots it builds from
    its own tokens (``models/moe.py``)."""

    axes: tuple[str, ...] = ()
    rows: int = 1
    group: Any = None

    def column(self, n_experts: int, plan: "Plan") -> list[int]:
        """The global expert ids of this rank's column, block by block in
        data-row order (all of them where nothing splits the experts)."""
        if "model" not in self.axes and self.rows == 1:
            return list(range(n_experts))
        m, size = (plan.rank, plan.size) if "model" in self.axes else (0, 1)
        per = n_experts // (self.rows * size)
        return [(d * size + m) * per + j for d in range(self.rows) for j in range(per)]

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x``'s ``rows`` blocks along dim 0 exchanged over the data axis
        (block ``d'`` to row ``d'``; the result's block ``d'`` from row
        ``d'``); the gradient the reverse exchange."""
        return _AllToAll.apply(x, self.group, self.rows) if self.rows > 1 else x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The data rows' ``x`` concatenated along dim 0 in row order; the
        gradient reduce-scattered back (each row's block summed over the
        rows)."""
        return _GatherRows.apply(x, self.group, self.rows) if self.rows > 1 else x


@dataclass(frozen=True)
class Plan:
    """What is split on the model axis, and the axis itself.

    ``vocab``: the embedding tables' rows; ``heads``: q heads (``wq``,
    ``bq``, ``wo``; MLA's ``wq_b``, ``wkv_b``, ``wo``); ``kv_heads``: k/v
    heads (MLA's are its heads); ``mlp``: the FFN's (and the shared
    expert's) hidden units. ``experts``: the MoE experts' placement
    (:class:`Experts`); ``moe_buf_shard``: the dispatch buffer is placed as
    the experts are, so tokens move to the experts (else their weights are
    gathered within a model column). ``seq_shard``: the residual stream is
    split along S between layers. ``cache_seq``: ``(start, stop, length)``
    of this rank's block of the decode cache's positions (the serve steps
    set it; a rolling window's ``length`` is its slots); ``cross_seq`` the
    same of the cross-attention cache's (the encoder's frames)."""

    group: Any
    size: int
    rank: int
    vocab: bool
    heads: bool
    kv_heads: bool
    mlp: bool
    seq_shard: bool = False
    cache_seq: tuple[int, int, int] | None = None
    experts: Experts = Experts()
    moe_buf_shard: bool = False
    cross_seq: tuple[int, int, int] | None = None

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
        return _all_reduce(x, self, op) if self.size > 1 else x

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The model ranks' ``x`` concatenated along ``dim`` in rank
        order; no gradient."""
        return _all_gather(x, self, dim) if self.size > 1 else x

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block along ``dim`` of the model ranks' sum; no
        gradient."""
        return _reduce_scatter(x, self, dim) if self.size > 1 else x

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x``'s ``size`` blocks along dim 0 exchanged over the model axis
        (block ``r`` to rank ``r``; the result's block ``r`` from rank
        ``r``); no gradient."""
        return _all_to_all(x, self.group, self.size) if self.size > 1 else x

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        """Identity; the gradient all-reduced over the model axis
        (Megatron's f: the input of a split region, or a whole weight used
        on a rank's part of the work)."""
        return _CopyTo.apply(x, self) if self.size > 1 else x

    def reduce_from(self, x: torch.Tensor) -> torch.Tensor:
        """The model ranks' partial sums added (Megatron's g: the output
        of a row-parallel product); the gradient passes as it is."""
        return _ReduceFrom.apply(x, self) if self.size > 1 else x

    def gather_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole sequence from each rank's block (entering a split
        region under ``seq_shard``); the gradient reduce-scattered back."""
        return _GatherSeq.apply(x, self, dim) if self.size > 1 else x

    def scatter_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's sequence block of the partial sums' total (leaving
        a split region under ``seq_shard``); the gradient all-gathered."""
        return _ScatterSeq.apply(x, self, dim) if self.size > 1 else x

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the model axis, and its gradient too: a sum
        that every rank's work reads (each rank's gradient of it is a part
        of the whole)."""
        return _PSum.apply(x, self) if self.size > 1 else x

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """A layer's (B, S, E) input entering a mixer on this rank's heads:
        the whole sequence under ``seq_shard`` (every rank then computes on
        all positions), else marked with ``copy_to`` where the heads are
        split (each rank's gradient of it a partial sum)."""
        if self.seq_shard:
            return self.gather_seq(x)
        return self.copy_to(x) if self.heads else x

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        """A mixer's (B, S, E) output from :meth:`enter`'s input: the
        ranks' partial sums over their heads added (reduce-scattered along
        S under ``seq_shard``); where the heads are whole, every rank
        computed it all, and keeps its own positions under ``seq_shard``."""
        if self.heads:
            return self.scatter_seq(y) if self.seq_shard else self.reduce_from(y)
        if self.seq_shard:
            a, b = self.block(y.shape[1])
            return y[:, a:b]
        return y

    def split_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's block along ``dim`` of a tensor every model rank
        holds whole; the gradient all-gathered (so each rank's
        whole-tensor gradient is the same)."""
        return _SplitSeq.apply(x, self, dim) if self.size > 1 else x


def _splits_on_model(sharding, dim: int) -> bool:
    from repro_torch.distributed.sharding import entry_axes

    spec = sharding.spec
    axes = entry_axes(spec[dim]) if dim < len(spec) else ()
    if "model" in axes and axes != ("model",):
        raise ValueError(f"spec {tuple(spec)} splits dim {dim} over {axes}: tensor-parallel "
                         "compute takes the model axis alone")
    return "model" in axes


def _leaf_splits(flat: dict) -> tuple[set, set, set]:
    """``({(heads, kv_heads)}, {mlp}, {experts' axes})`` over every layer
    stack's leaves: the mixers' heads (GQA's ``wq``/``wk``, wherever they
    lie: ``blocks/<group>/attn``, the encoder's ``attn``, the decoder's
    ``self_attn`` and ``cross_attn``; MLA's ``wq_b``, ``wkv_b`` and ``wo``;
    the mLSTM's ``wq``, its q, k and v alike), the FFNs' and MLPs' hidden
    units (``wg``, the shared expert's ``ws_g``, the GELU MLP's ``w_in``)
    and the MoE experts' axes. The hybrid's SSD heads (``ssd/wx``) must
    split as its attention's q heads do: one plan runs both on the rank's
    heads."""
    from repro_torch.distributed.sharding import entry_axes

    attn, mlp, experts = set(), set(), set()
    for path in flat:
        pre, _, name = path.rpartition("/")
        pre += "/"
        if name == "wq_b":  # MLA: q and kv expanded per head; wo row-parallel
            heads = {_splits_on_model(flat[pre + "wq_b"], 2),
                     _splits_on_model(flat[pre + "wkv_b"], 2), _splits_on_model(flat[pre + "wo"], 1)}
            if len(heads) != 1:
                raise ValueError(f"MLA's wq_b, wkv_b and wo split their heads differently ({pre})")
            (h,) = heads
            attn.add((h, h))
        elif name == "wq" and pre.endswith("/mlstm/"):
            h = _splits_on_model(flat[path], 2)
            attn.add((h, h))
        elif name == "wq":
            attn.add((_splits_on_model(flat[path], 2), _splits_on_model(flat[pre + "wk"], 2)))
        elif name == "wx":  # the hybrid's SSD beside its attention
            wq = pre.removesuffix("ssd/") + "attn/wq"
            if _splits_on_model(flat[path], 2) != _splits_on_model(flat[wq], 2):
                raise ValueError(f"the SSD's heads ({path}) and the attention's ({wq}) split "
                                 "differently: the hybrid runs both on one plan's heads")
        elif name == "w_router":  # a MoE group: the experts dim, the shared expert's units
            spec = flat[pre + "wg"].spec
            experts.add(entry_axes(spec[1]) if len(spec) > 1 else ())
            if pre + "ws_g" in flat:
                mlp.add(_splits_on_model(flat[pre + "ws_g"], 2))
        elif (name == "wg" and pre + "w_router" not in flat) or name == "w_in":
            mlp.add(_splits_on_model(flat[path], 2))
    return attn, mlp, experts


def plan_for(cfg, params_shardings: Any, mesh, *, seq_shard: bool = False,
             moe_buf_shard: bool = False) -> Plan | None:
    """The :class:`Plan` of ``cfg``'s params placed by ``params_shardings``
    (a :class:`~repro_torch.distributed.sharding.NamedSharding` tree) on
    ``mesh``; ``None`` where nothing is split (no model axis or one of
    size 1, and no experts split over data): the model's plain code runs.
    Raises for layer stacks or mixers split differently."""
    from repro_torch.distributed.sharding import axis_sizes
    from repro_torch.utils import flatten_with_paths

    sizes = axis_sizes(mesh)
    flat, _ = flatten_with_paths(params_shardings)
    vocab = {_splits_on_model(flat[p], 0) for p in ("embed", "unembed") if p in flat}
    attn, mlp, experts = _leaf_splits(flat)
    if len(vocab) != 1 or len(attn) != 1 or len(mlp) > 1 or len(experts) > 1:
        raise ValueError(f"embedding tables or layer groups split differently: {vocab} "
                         f"{attn} {mlp} {experts}")
    ((heads, kv_heads),) = attn
    axes = experts.pop() if experts else ()
    if axes not in ((), ("model",), ("data", "model")):
        raise ValueError(f"experts split over {axes}: expert-parallel compute takes "
                         "(data, model) or model")
    if sizes.get("model", 1) == 1 and "data" not in axes:
        return None
    rows = sizes["data"] if "data" in axes else 1
    placed = Experts(axes=axes, rows=rows, group=mesh.get_group("data") if rows > 1 else None)
    plan = Plan(group=mesh.get_group("model"), size=sizes.get("model", 1),
                rank=mesh.get_local_rank("model"), vocab=vocab.pop(), heads=heads,
                kv_heads=kv_heads, mlp=bool(mlp and mlp.pop()),
                # the reference's encoder-decoder constrains no residual stream:
                # seq_shard changes nothing there
                seq_shard=seq_shard and not cfg.encdec, experts=placed,
                moe_buf_shard=moe_buf_shard)
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


def _all_to_all(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """``x``'s ``n`` equal blocks along dim 0 exchanged over ``group``."""
    f = _ops()
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split {n} ways")
    split = [x.shape[0] // n] * n
    return f.wait_tensor(f.all_to_all_single(x.contiguous(), split, split, group.group_name))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _all_to_all(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group, ctx.n), None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        f = _ops()
        return f.wait_tensor(f.all_gather_into_tensor(x.contiguous(), n, group.group_name))

    @staticmethod
    def backward(ctx, g):
        f = _ops()
        return f.wait_tensor(f.reduce_scatter_tensor(g.contiguous(), "sum", ctx.n,
                                                     ctx.group.group_name)), None, None


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


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return _all_reduce(x, plan)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.plan), None


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
