"""Step builders: init and train, on one device or on a ``DeviceMesh``;
prefill and decode on a ``DeviceMesh``.

Port of the JAX package's ``repro/distributed/steps.py``. Training state
layout (a plain dict, CMI-serializable, the reference's paths and dtypes,
so a train-state CMI crosses between the packages):

    {"params": ..., "opt": {mu, nu, master, count}, "step": int32[],
     "rng": uint32[2], "data": {"data_step": int32[], "seed": int32[]}}

The train step updates the state in place (see ``optim/adamw.py``) and
returns it.

On a mesh every leaf is a DTensor with the reference's placements
(:func:`state_shardings`): params by ``DEFAULT_RULES``, the optimizer
state by ``OPT_RULES`` (ZeRO), ``step``/``rng``/``data`` replicated. Each
rank computes on its batch shard (its ``data_pspec`` block), weights its
mean loss by its share of the global valid labels, sums the gradients
over the batch axes and updates its block of the moments and master
weights, the new params gathered back to their own placements. The loss
is the global mean, as the reference's. How a rank computes depends on
its own shards, as the reference's GSPMD program does, and the step
records it (``path`` in the train step's metrics, ``.path`` on every
step: ``"tp"``, every family's; ``distributed/tp.py``): vocab-parallel
embedding and loss, column- then row-parallel FFN, MLP and attention, K3
on the rank's q heads, MLA on its heads, the hybrid's SSD and the mLSTM on
its heads (their chunked recurrence over the whole sequence), the
encoder–decoder's attentions and MLPs on its heads and hidden units, the
MoE experts on their (data, model) or model blocks (``models/moe.py``).
The gradients are the local shards, summed over the batch axes a weight
is not split over (an expert split over data has its whole gradient after
the backward of the dispatch's collectives); a whole weight a rank used on
its part of the work has its gradient summed over the model axis; the
global norm counts every element once; AdamW takes the ``OPT_RULES``
block of each local shard. ``seq_shard`` splits the residual stream along
S between layers (Megatron's sequence parallelism; the reference's
encoder–decoder constrains no stream, so there it changes nothing);
``moe_buf_shard`` places the MoE dispatch buffer as the experts are, so
tokens move to the experts (all-to-all) where without it each model
column's expert weights are gathered over the data axis (a model without
MoE layers has no buffer: it changes nothing there, as in the reference).

On a mesh that splits nothing (a model axis of size 1, and no experts
over the data axis) the model runs its plain code, and on one whose batch
axes have size 1 nothing is summed: a 1×1 mesh is the unsharded step bit
for bit.

The serve steps (:func:`make_prefill_step`, :func:`make_decode_step`)
compute the same way (their MoE layers move tokens to the experts).
Their caches are DTensors placed by ``CACHE_RULES`` (batch over
pod×data, seq over model, every kv head, the recurrent states whole on
the heads). Prefill keeps each rank's block of positions of every
layer's cache (GQA's k/v, the kv heads gathered along the model axis; a
rolling window's block of its slots; MLA's latent rows; the
encoder–decoder's cross k/v over the frames) and the recurrent states
whole; decode attends over each rank's block where it lies
(flash-decoding's combine across the model axis; MLA's absorbed form
scores every head there), the new position written by the rank that owns
it, and the recurrent states' heads computed on their ranks and
all-gathered.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from repro_torch import spans
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.distributed.sharding import (
    CACHE_RULES,
    DEFAULT_RULES,
    OPT_RULES,
    NamedSharding,
    batch_axes,
    axis_names,
    axis_sizes,
    data_pspec,
    entry_axes,
    from_local,
    local_block,
    mesh_coordinate,
    mesh_device,
    place_tree,
    redistribute,
    replicated,
    sharding_of,
    tree_shardings,
)
from repro_torch.distributed import tp
from repro_torch.distributed.ctx import sharding_context
from repro_torch.models import transformer as tf
from repro_torch.models.model import Model, TensorSpec, tree_from_numpy
from repro_torch.optim.adamw import (AdamWConfig, adamw_leaf, adamw_scalars, adamw_update,
                                     global_norm, init_opt_state, opt_axes)
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.utils import flatten_with_paths, resolve_device, tree_map


def state_specs(cfg: ArchConfig, opt_cfg: AdamWConfig) -> dict[str, Any]:
    """TensorSpec tree of the train state, nothing allocated."""
    params = Model(cfg).param_specs()
    mdt = getattr(torch, opt_cfg.moment_dtype)
    i32 = TensorSpec((), torch.int32)
    return {
        "params": params,
        "opt": {"mu": tree_map(lambda s: TensorSpec(s.shape, mdt), params),
                "nu": tree_map(lambda s: TensorSpec(s.shape, mdt), params),
                "master": tree_map(lambda s: TensorSpec(s.shape, torch.float32), params),
                "count": i32},
        "step": i32,
        "rng": TensorSpec((2,), torch.uint32),
        "data": {"data_step": i32, "seed": i32},
    }


state_struct_for = state_specs  # the reference's name


@functools.lru_cache(maxsize=None)
def model_axes_for(cfg: ArchConfig) -> tuple[Any, Any]:
    """``(logical-axes tree, TensorSpec tree)`` of ``cfg``'s params,
    nothing allocated."""
    model = Model(cfg)
    return model.param_axes(), model.param_specs()


def cache_axes(cfg: ArchConfig) -> Any:
    """Logical axes of the decode cache tree (mirrors ``Model.cache_struct``)."""
    kvax = ("layers", "batch", "seq", "kv_heads", "head_dim")
    if cfg.encdec:
        return {"k": kvax, "v": kvax, "xk": kvax, "xv": kvax}
    out = {}
    for gname, _, mixer, _ in tf.block_groups(cfg):
        if mixer == "gqa":
            out[gname] = {"k": kvax, "v": kvax}
        elif mixer == "mla":
            out[gname] = {"ckv": ("layers", "batch", "seq", None),
                          "kr": ("layers", "batch", "seq", None)}
        elif mixer == "hybrid":
            out[gname] = {"attn": {"k": kvax, "v": kvax},
                          "ssd": ("layers", "batch", "heads", None, "head_dim")}
        elif mixer == "mlstm":
            out[gname] = {"mlstm": ("layers", "batch", "heads", "head_dim", None)}
    return out


def state_shardings(model_axes: Any, state_struct: Any, mesh) -> dict[str, Any]:
    """:class:`NamedSharding` tree of the train state on ``mesh``: params
    by ``DEFAULT_RULES``, the optimizer state by ``OPT_RULES``, the
    counters replicated."""
    rep = replicated(mesh)
    return {
        "params": tree_shardings(model_axes, state_struct["params"], mesh, DEFAULT_RULES),
        "opt": tree_shardings(opt_axes(model_axes), state_struct["opt"], mesh, OPT_RULES),
        "step": rep,
        "rng": rep,
        "data": {"data_step": rep, "seed": rep},
    }


def train_state_shardings(cfg: ArchConfig, opt_cfg: AdamWConfig, mesh) -> dict[str, Any]:
    return state_shardings(Model(cfg).param_axes(), state_specs(cfg, opt_cfg), mesh)


def batch_shardings(batch_struct: Any, mesh) -> Any:
    """Each batch leaf sharded over the batch axes on dim 0, with
    ``data_pspec``'s fallback when the batch does not divide."""
    return tree_map(lambda s: NamedSharding(
        mesh, data_pspec(mesh, len(s.shape), s.shape[0] if len(s.shape) else None)),
        batch_struct)


def make_init_fn(cfg: ArchConfig, opt_cfg: AdamWConfig, *, seed: int = 0, device=None,
                 mesh=None):
    """Returns ``() -> state`` on ``device`` (default: the CUDA card), the
    weights drawn from a ``torch.Generator`` seeded with ``seed`` (not the
    reference's numbers: :func:`train_state_from_numpy` carries those).
    With ``mesh``, every rank draws the same weights on its device of the
    mesh and keeps its blocks (:func:`state_shardings`)."""
    dev = mesh_device(mesh) if mesh is not None else resolve_device(device)
    model = Model(cfg)

    def init_fn() -> dict[str, Any]:
        params = model.init(torch.Generator(dev).manual_seed(seed))
        state = {
            "params": params,
            "opt": init_opt_state(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32, device=dev),
            "rng": torch.tensor([0, seed + 1], dtype=torch.uint32, device=dev),
            "data": {"data_step": torch.zeros((), dtype=torch.int32, device=dev),
                     "seed": torch.tensor(seed, dtype=torch.int32, device=dev)},
        }
        if mesh is None:
            return state
        return place_tree(state, train_state_shardings(cfg, opt_cfg, mesh))

    return init_fn


def train_state_from_numpy(tree: Any, cfg: ArchConfig, opt_cfg: AdamWConfig,
                           device=None, *, mesh=None) -> dict[str, Any]:
    """The JAX package's train state (numpy leaves) as the port's on
    ``device``, checked against :func:`state_specs`; with ``mesh``, placed
    on it by the port's rules (:func:`state_shardings`)."""
    if mesh is None:
        return tree_from_numpy(tree, state_specs(cfg, opt_cfg), device)
    state = tree_from_numpy(tree, state_specs(cfg, opt_cfg), mesh_device(mesh))
    return place_tree(state, train_state_shardings(cfg, opt_cfg, mesh))


def batch_to_device(batch: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """A pipeline batch (numpy) as tensors on ``device``; uint16 arrays are
    bf16 bits (the encoder's frames) and become bf16."""
    def tensor(v):
        t = torch.from_numpy(np.ascontiguousarray(v))
        return t.view(torch.bfloat16) if v.dtype == np.uint16 else t

    return {k: tensor(v).to(device) for k, v in batch.items()}


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000, n_route_groups: int = 0,
                    seq_shard: bool = False, moe_buf_shard: bool = False, mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the loss and
    its gradient, the warmup-cosine learning rate at ``state["step"]``, one
    AdamW update, the step and data counters advanced, all in place on
    ``state``. ``metrics``: 0-d tensors ``loss``, ``lr``, ``grad_norm``
    (and on a mesh the compute ``path``).

    With ``mesh``, ``state`` is the DTensor state of :func:`make_init_fn`
    and ``batch`` the global batch, which every rank holds whole: each
    computes on its own block (see the module's docstring).

    MoE routing groups default to the data-parallel degree, as in the
    reference (the product of the mesh's batch axes; 1 on one device), so
    each batch shard routes as its own group. ``seq_shard`` (the
    reference's sequence-parallel residual stream) and ``moe_buf_shard``
    (its expert-placed dispatch buffer: tokens move to the experts) need a
    mesh; each changes nothing where the reference's does not
    (``moe_buf_shard`` for a model without MoE layers, ``seq_shard`` for
    the encoder–decoder). A step runs under the span ``train_step``."""
    for flag, on, what in (("seq_shard", seq_shard, "splits the residual stream over a mesh's "
                            "model axis"),
                           ("moe_buf_shard", moe_buf_shard, "places the MoE dispatch buffer on "
                            "a mesh's expert axes")):
        if on and mesh is None:
            raise ValueError(f"{flag} {what}: it needs a mesh")
    if mesh is not None:
        return _make_sharded_train_step(cfg, opt_cfg, mesh, peak_lr=peak_lr, warmup=warmup,
                                        total_steps=total_steps, n_route_groups=n_route_groups,
                                        seq_shard=seq_shard, moe_buf_shard=moe_buf_shard)
    n_groups = n_route_groups or 1
    # torch.utils.checkpoint's first call imports torch._dynamo, and that
    # import keeps its caller's frames alive for good: whatever train state
    # the first step's frames hold would stay on the card. Imported here,
    # before any state exists, it holds nothing.
    import torch._dynamo  # noqa: F401

    model = Model(cfg)
    selection_only = model.selection_only_paths()  # zero gradients, as jax.grad's

    @spans.span("train_step")
    def train_step(state: dict[str, Any], batch: dict[str, torch.Tensor]):
        params = state["params"]
        flat, treedef = flatten_with_paths(params)
        leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
        loss = model.loss(treedef.unflatten(leaves), batch, n_groups=n_groups)
        grads = _gradients(loss, leaves, selection_only)
        lr = warmup_cosine(state["step"], peak_lr=peak_lr, warmup=warmup, total=total_steps)
        om = adamw_update(treedef.unflatten(grads), state["opt"], params, lr, opt_cfg)
        del grads
        state["step"] += 1
        state["data"]["data_step"] += 1
        return state, {"loss": loss.detach(), "lr": lr, **om}

    return train_step


def _gradients(loss, leaves: dict[str, torch.Tensor], selection_only: set[str]):
    """``{path: d loss / d leaf}``; the selection-only leaves get zeros (as
    ``jax.grad`` gives), and every other leaf must reach the loss
    (autograd raises where one does not)."""
    reached = [k for k in leaves if k not in selection_only]
    grads = dict(zip(reached, torch.autograd.grad(loss, [leaves[k] for k in reached])))
    return {k: grads[k] if k in grads else torch.zeros_like(v) for k, v in leaves.items()}


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _make_sharded_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, mesh, *, peak_lr: float,
                             warmup: int, total_steps: int, n_route_groups: int,
                             seq_shard: bool, moe_buf_shard: bool):
    import torch.distributed as dist
    import torch._dynamo  # noqa: F401  (see make_train_step)

    model = Model(cfg)
    selection_only = model.selection_only_paths()
    sizes = axis_sizes(mesh)
    if n_route_groups == 0:
        n_route_groups = 1
        for a in batch_axes(mesh):
            n_route_groups *= sizes[a]
    path = tp.compute_path(cfg)
    model_axes, params_struct = model_axes_for(cfg)
    p_sh = tree_shardings(model_axes, params_struct, mesh, DEFAULT_RULES)
    plan = tp.plan_for(cfg, p_sh, mesh, seq_shard=seq_shard, moe_buf_shard=moe_buf_shard)
    experts = list(plan.experts.axes) if plan is not None else []

    @torch.no_grad()
    def shard_batch(batch: dict[str, torch.Tensor]):
        """This rank's batch block, the axes it is split over, and the
        share of the global valid labels it holds."""
        shs = _batch_shardings(batch, mesh)
        local = {k: local_block(v, shs[k]) for k, v in batch.items()}
        axes = entry_axes(shs["labels"].spec[0])
        share = None
        if axes:  # a 0-d tensor on the rank's device: no host read
            n_local = (local["labels"] >= 0).sum().double()
            share = (n_local / (batch["labels"] >= 0).sum().clamp(min=1).double()).float()
        return local, axes, share

    def reduce(t: torch.Tensor, axes) -> None:
        for a in axes:  # a sum over the product of the batch axes
            dist.all_reduce(t, group=mesh.get_group(a))

    @spans.span("train_step")
    def train_step(state: dict[str, Any], batch: dict[str, torch.Tensor]):
        local, axes, share = shard_batch(batch)
        shards = 1
        for a in axes:
            shards *= sizes[a]
        if n_route_groups % shards:
            raise ValueError(f"{n_route_groups} routing groups do not split over {shards} "
                             "batch shards")
        p_flat, treedef = flatten_with_paths(state["params"])
        leaves = {k: _local(v).detach().requires_grad_(True) for k, v in p_flat.items()}
        constraints = {}
        if plan is not None and plan.seq_shard:
            s_total = local["tokens"].shape[1] + cfg.vision_prefix
            constraints["resid"] = tp.SeqParallel(plan, s_total)
        with sharding_context(constraints):
            loss = model.loss(treedef.unflatten(leaves), local,
                              n_groups=n_route_groups // shards, plan=plan)
            if share is not None:
                loss = loss * share
            grads = _gradients(loss, leaves, selection_only)
        del leaves
        loss = loss.detach()
        with torch.no_grad():
            if axes:
                reduce(loss, axes)
                for k, g in grads.items():  # not over an axis the weight is split over
                    reduce(g, [a for a in axes if a not in _split_axes(p_flat[k])])
            lr = warmup_cosine(_local(state["step"]), peak_lr=peak_lr, warmup=warmup,
                               total=total_steps)
            om = _adamw_sharded(grads, state["opt"], p_flat, lr, opt_cfg, plan)
        del grads
        _local(state["step"]).add_(1)
        _local(state["data"]["data_step"]).add_(1)
        return state, {"loss": loss, "lr": lr, **om, "path": path,
                       "moe_buf_shard": moe_buf_shard, "experts": experts}

    mesh_coordinate(mesh)  # this rank must be in the mesh
    train_step.path, train_step.moe_buf_shard, train_step.experts = path, moe_buf_shard, experts
    return train_step


def _split_axes(t) -> tuple[str, ...]:
    """The mesh axes (of size > 1) a DTensor's placements split it over."""
    from torch.distributed.tensor import Shard

    names, sizes = axis_names(t.device_mesh), t.device_mesh.shape
    return tuple(a for i, a in enumerate(names)
                 if sizes[i] > 1 and isinstance(t.placements[i], Shard))


def _grad_block(g: torch.Tensor, p, master) -> torch.Tensor:
    """The block of ``master``'s placements (``OPT_RULES``) in a gradient
    that is the param ``p``'s whole tensor or its local shard
    (``DEFAULT_RULES``), which holds it."""
    coord = mesh_coordinate(master.device_mesh)
    want = sharding_of(master).shard_index(master.shape, coord)
    have = (tuple((0, n) for n in master.shape) if tuple(g.shape) == tuple(master.shape)
            else sharding_of(p).shard_index(p.shape, coord))
    if any(m0 < h0 or m1 > h1 for (m0, m1), (h0, h1) in zip(want, have)):
        raise ValueError(f"the optimizer block {want} is not inside the gradient's {have}")
    return g[tuple(slice(m0 - h0, m1 - h0) for (m0, m1), (h0, _) in zip(want, have))]


def _sum_squares(tensors: list, device) -> torch.Tensor:
    """float32 sum of every element's square, tensors added in order (as
    ``global_norm``'s)."""
    total = torch.zeros((), dtype=torch.float32, device=device)
    for x in tensors:
        total = total + torch.sum(torch.square(x.float()))
    return total


def _axis_sum(x: torch.Tensor, group) -> torch.Tensor:
    f = torch.ops._c10d_functional
    return f.wait_tensor(f.all_reduce(x.contiguous(), "sum", group.group_name))


@torch.no_grad()
def _adamw_sharded(grads: dict[str, torch.Tensor], opt_state: dict, p_flat: dict, lr,
                   cfg: AdamWConfig, plan=None) -> dict:
    """``optim.adamw.adamw_update`` on DTensor state: ``grads`` already
    summed, each the param's local shard, each rank updating its block of
    the moments and the master weights;
    each param is the new master cast to its dtype and gathered to the
    param's placements. Under a plan the global norm counts each element
    once: each leaf's squares summed over the axes it is split over (the
    model axis, the data axis too for an expert), a whole leaf's (the
    same on every rank) once."""
    with spans.span("adamw_update"):
        mu_flat, _ = flatten_with_paths(opt_state["mu"])
        nu_flat, _ = flatten_with_paths(opt_state["nu"])
        m_flat, _ = flatten_with_paths(opt_state["master"])
        count = _local(opt_state["count"])
        count += 1
        if plan is None:
            gnorm = global_norm(grads)
        else:
            by_axes: dict[tuple, list] = {}
            for k, g in grads.items():
                by_axes.setdefault(_split_axes(p_flat[k]), []).append(g)
            total = _sum_squares(by_axes.pop((), []), count.device)
            mesh = next(iter(p_flat.values())).device_mesh
            for split_axes, gs in sorted(by_axes.items()):
                sq = _sum_squares(gs, count.device)
                for a in split_axes:
                    sq = _axis_sum(sq, mesh.get_group(a))
                total = total + sq
            gnorm = torch.sqrt(total)
        scale, c1, c2 = adamw_scalars(gnorm, count, cfg)
        for path, g in grads.items():
            master = m_flat[path]
            msh = sharding_of(master)
            adamw_leaf(_grad_block(g, p_flat[path], master), _local(mu_flat[path]),
                       _local(nu_flat[path]), master.to_local(), scale, c1, c2, lr, cfg)
            p = p_flat[path]
            cast = from_local(master.to_local().to(p.dtype), master.shape, msh)
            p.to_local().copy_(redistribute(cast, sharding_of(p)).to_local())
    return {"grad_norm": gnorm}


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------


def _rows(sharding: NamedSharding, shape, dim: int) -> tuple[int, int]:
    """``(start, stop)`` along ``dim`` of this rank's block under ``sharding``."""
    return sharding.shard_index(shape, mesh_coordinate(sharding.mesh))[dim]


def _batch_block(t, sharding: NamedSharding) -> torch.Tensor:
    """This rank's batch block of a batch leaf: a DTensor's local block
    (placed by ``sharding``) or the block of a tensor every rank holds whole."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        if list(t.placements) != list(sharding.placements):
            raise ValueError(f"a batch leaf placed {t.placements}, expected {sharding.spec}")
        return t.to_local()
    return local_block(t, sharding)


def _batch_shardings(batch: dict, mesh) -> dict:
    return batch_shardings({k: TensorSpec(tuple(v.shape), v.dtype) for k, v in batch.items()},
                           mesh)


def _cache_rows(sharding: NamedSharding, shape) -> tuple[int, int, int]:
    """``(start, stop, length)`` of this rank's block of a (L, B, S, ...)
    cache's positions."""
    a, b = sharding.shard_index(shape, mesh_coordinate(sharding.mesh))[2]
    return a, b, shape[2]


def _params_for(params):
    """Each rank's own shards of the params, the tree a step computes on."""
    flat, treedef = flatten_with_paths(params)
    return treedef.unflatten({k: _local(v) for k, v in flat.items()})


# the first attention cache leaf of each layout: its block of positions is
# every self-attention cache's (plan.cache_seq)
_ATTN_CACHE_LEAVES = ("g0/k", "g0/ckv", "g0/attn/k", "k")


def _serve_plan(cfg: ArchConfig, p_sh, mesh, c_flat: dict, shapes: dict):
    """The serve steps' plan (``None`` where nothing is split): the MoE
    dispatch moves tokens to the experts; ``cache_seq`` is this rank's
    block of the first layer group's attention cache (``k``, MLA's
    ``ckv``, the hybrid's ``attn/k``, the encoder–decoder's ``k``; none
    for the mLSTM) and ``cross_seq`` of the encoder–decoder's cross cache
    (``xk``)."""
    plan = tp.plan_for(cfg, p_sh, mesh, moe_buf_shard=True)
    if plan is None:
        return None
    seqs = {field: _cache_rows(c_flat[leaf], shapes[leaf]) for field, leaf in
            (("cache_seq", next((k for k in _ATTN_CACHE_LEAVES if k in c_flat), None)),
             ("cross_seq", "xk")) if leaf in c_flat}
    return plan.with_(**seqs)


def make_prefill_step(cfg: ArchConfig, mesh, shape: InputShape):
    """Returns ``(prefill_step, params_shardings, (logits_sharding,
    cache_shardings))``. ``prefill_step(params, batch) -> (logits,
    caches)``: params the DTensor tree placed by ``params_shardings``
    (``DEFAULT_RULES``), batch leaves DTensors placed by
    :func:`batch_shardings` or tensors every rank holds whole; logits (B,
    V) float32 and the caches (``s_max`` = seq_len + the vision prefix)
    DTensors placed by the returned shardings (``CACHE_RULES``): the model
    computes each rank's block of positions of the caches itself, and each
    rank keeps its batch block of those it computes whole.
    ``prefill_step.path`` names the path."""
    model = Model(cfg)
    s_max = shape.seq_len + cfg.vision_prefix
    model_axes, params_struct = model_axes_for(cfg)
    p_sh = tree_shardings(model_axes, params_struct, mesh, DEFAULT_RULES)
    cache_struct = model.cache_struct(shape.global_batch, s_max)
    c_sh = tree_shardings(cache_axes(cfg), cache_struct, mesh, CACHE_RULES)
    c_flat, _ = flatten_with_paths(c_sh)
    glob = {path: spec.shape for path, spec in flatten_with_paths(cache_struct)[0].items()}
    logits_shape = (shape.global_batch, cfg.vocab)
    logits_sh = NamedSharding(mesh, data_pspec(mesh, 2, shape.global_batch))
    path = tp.compute_path(cfg)
    plan = _serve_plan(cfg, p_sh, mesh, c_flat, glob)

    @torch.no_grad()
    def prefill_step(params, batch: dict):
        b_sh = _batch_shardings(batch, mesh)
        local = {k: _batch_block(v, b_sh[k]) for k, v in batch.items()}
        rows = _rows(b_sh["tokens"], batch["tokens"].shape, 0)
        logits, caches = model.prefill(_params_for(params), local, s_max, plan=plan)
        flat, treedef = flatten_with_paths(caches)
        out = {}
        for name, c in flat.items():
            sh = c_flat[name]
            index = sh.shard_index(glob[name], mesh_coordinate(mesh))
            if index[1] != rows:  # dim 1 of every cache is its batch
                raise ValueError(f"cache {name}'s batch block {index[1]} is not the batch's "
                                 f"{rows}")
            cut = []
            for d, (a, b) in enumerate(index):
                if c.shape[d] == b - a:  # already this rank's block (its batch rows too)
                    cut.append(slice(None))
                elif c.shape[d] == glob[name][d]:
                    cut.append(slice(a, b))
                else:
                    raise ValueError(f"cache {name} dim {d}: {c.shape[d]} is neither the "
                                     f"block {b - a} nor the whole {glob[name][d]}")
            block = c[tuple(cut)]
            # the whole computed cache is this rank's block where nothing splits it
            out[name] = from_local(block if block.shape == c.shape else block.contiguous(),
                                   glob[name], sh)
        del flat, caches
        return from_local(logits, logits_shape, logits_sh), treedef.unflatten(out)

    prefill_step.path = path
    prefill_step.experts = list(plan.experts.axes) if plan is not None else []
    prefill_step.moe_buf_shard = bool(prefill_step.experts)  # MoE tokens move to their experts
    return prefill_step, p_sh, (logits_sh, c_sh)


def make_decode_step(cfg: ArchConfig, mesh, shape: InputShape):
    """One-token serve step over a ``seq_len``-deep cache. Returns
    ``(decode_step, params_shardings, cache_shardings)``.
    ``decode_step(params, caches, tokens, pos) -> (logits, caches)``:
    caches the DTensor tree placed by ``cache_shardings`` (``CACHE_RULES``),
    written in place at ``pos`` and returned; tokens (B, 1) a DTensor placed
    by :func:`batch_shardings` or a tensor every rank holds whole; pos an
    int; logits (B, 1, V) float32 placed over the batch axes. Each rank
    attends over its block of positions where it lies.
    ``decode_step.path`` names the path."""
    model = Model(cfg)
    model_axes, params_struct = model_axes_for(cfg)
    p_sh = tree_shardings(model_axes, params_struct, mesh, DEFAULT_RULES)
    cache_struct = model.cache_struct(shape.global_batch, shape.seq_len)
    c_sh = tree_shardings(cache_axes(cfg), cache_struct, mesh, CACHE_RULES)
    logits_shape = (shape.global_batch, 1, cfg.vocab)
    logits_sh = NamedSharding(mesh, data_pspec(mesh, 3, shape.global_batch))
    path = tp.compute_path(cfg)
    plan = _serve_plan(cfg, p_sh, mesh, flatten_with_paths(c_sh)[0],
                       {k: v.shape for k, v in flatten_with_paths(cache_struct)[0].items()})

    @torch.no_grad()
    def decode_step(params, caches, tokens, pos: int):
        pos = int(pos)
        tok_sh = _batch_shardings({"tokens": tokens}, mesh)["tokens"]
        tok = _batch_block(tokens, tok_sh)
        rows = _rows(tok_sh, tokens.shape, 0)
        flat, treedef = flatten_with_paths(caches)
        work = {}
        for name, c in flat.items():  # the local blocks, written in place
            if _rows(sharding_of(c), c.shape, 1) != rows:
                raise ValueError(f"cache {name}'s batch block is not the tokens' {rows}")
            work[name] = c.to_local()
        logits, _ = model.decode(_params_for(params), treedef.unflatten(work), tok, pos,
                                 plan=plan)
        del work
        return from_local(logits, logits_shape, logits_sh), caches

    decode_step.path = path
    decode_step.experts = list(plan.experts.axes) if plan is not None else []
    decode_step.moe_buf_shard = bool(decode_step.experts)  # MoE tokens move to their experts
    return decode_step, p_sh, c_sh
