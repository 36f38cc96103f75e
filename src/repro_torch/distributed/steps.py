"""Step builders: init and train, on one device or on a ``DeviceMesh``.

Port of the JAX package's ``repro/distributed/steps.py`` (the sharded
prefill and decode step builders are not ported yet). Training state
layout (a plain dict, CMI-serializable, the reference's paths and dtypes,
so a train-state CMI crosses between the packages):

    {"params": ..., "opt": {mu, nu, master, count}, "step": int32[],
     "rng": uint32[2], "data": {"data_step": int32[], "seed": int32[]}}

The train step updates the state in place (see ``optim/adamw.py``) and
returns it.

On a mesh every leaf is a DTensor with the reference's placements
(:func:`state_shardings`): params by ``DEFAULT_RULES``, the optimizer
state by ``OPT_RULES`` (ZeRO), ``step``/``rng``/``data`` replicated. The
step stores by those placements and computes FSDP-style: it gathers every
weight whole on each rank, runs the model on the rank's batch shard (its
``data_pspec`` block) with plain local tensors (K3, the MoE scatter and
the chunked recurrence have no DTensor rules), weights the rank's mean
loss by its share of the global valid labels, sums the gradients over the
batch axes, and updates each rank's block of the moments and master
weights, the new params gathered back to their own placements. The loss
is the global mean, as the reference's. On a mesh whose batch axes have
size 1 nothing is summed and every number is the unsharded step's.
Tensor-parallel compute (placements kept through the layers) is later
speed work.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    OPT_RULES,
    NamedSharding,
    batch_axes,
    data_pspec,
    entry_axes,
    from_local,
    local_block,
    mesh_device,
    place_tree,
    redistribute,
    replicated,
    sharding_of,
    tree_shardings,
)
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
                    moe_buf_shard: bool = False, mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the loss and
    its gradient, the warmup-cosine learning rate at ``state["step"]``, one
    AdamW update, the step and data counters advanced, all in place on
    ``state``. ``metrics``: 0-d tensors ``loss``, ``lr``, ``grad_norm``.

    With ``mesh``, ``state`` is the DTensor state of :func:`make_init_fn`
    and ``batch`` the global batch, which every rank holds whole: each
    computes on its own block (see the module's docstring).

    MoE routing groups default to the data-parallel degree, as in the
    reference (the product of the mesh's batch axes; 1 on one device), so
    each batch shard routes as its own group. ``moe_buf_shard`` (the
    reference's expert-sharded dispatch buffer) is refused: this step runs
    the MoE on plain local tensors, so there is no DTensor buffer to place
    until the expert-parallel compute lands (ROADMAP, speed follow-ups)."""
    if moe_buf_shard:
        raise NotImplementedError(
            "moe_buf_shard: the sharded step gathers the experts and runs the MoE on local "
            "tensors, so its dispatch buffer is not a DTensor to shard; expert-parallel "
            "compute is a speed follow-up (ROADMAP queue 1, speed follow-ups: the mesh)")
    if mesh is not None:
        return _make_sharded_train_step(cfg, opt_cfg, mesh, peak_lr=peak_lr, warmup=warmup,
                                        total_steps=total_steps, n_route_groups=n_route_groups)
    n_groups = n_route_groups or 1
    # torch.utils.checkpoint's first call imports torch._dynamo, and that
    # import keeps its caller's frames alive for good: whatever train state
    # the first step's frames hold would stay on the card. Imported here,
    # before any state exists, it holds nothing.
    import torch._dynamo  # noqa: F401

    model = Model(cfg)
    selection_only = model.selection_only_paths()  # zero gradients, as jax.grad's

    def train_step(state: dict[str, Any], batch: dict[str, torch.Tensor]):
        params = state["params"]
        flat, treedef = flatten_with_paths(params)
        leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
        loss = model.loss(treedef.unflatten(leaves), batch, n_groups=n_groups)
        # every other leaf must reach the loss: autograd raises where one does not
        reached = [k for k in leaves if k not in selection_only]
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
                             warmup: int, total_steps: int, n_route_groups: int):
    import torch.distributed as dist
    import torch._dynamo  # noqa: F401  (see make_train_step)

    from repro_torch.distributed.sharding import axis_sizes, mesh_coordinate

    model = Model(cfg)
    selection_only = model.selection_only_paths()
    sizes = axis_sizes(mesh)
    if n_route_groups == 0:
        n_route_groups = 1
        for a in batch_axes(mesh):
            n_route_groups *= sizes[a]

    @torch.no_grad()
    def shard_batch(batch: dict[str, torch.Tensor]):
        """This rank's batch block, the axes it is split over, and the
        share of the global valid labels it holds."""
        shs = batch_shardings({k: TensorSpec(tuple(v.shape), v.dtype) for k, v in batch.items()},
                              mesh)
        local = {k: local_block(v, shs[k]) for k, v in batch.items()}
        axes = entry_axes(shs["labels"].spec[0])
        share = 1.0
        if axes:
            n_local = int((local["labels"] >= 0).sum())
            share = n_local / max(int((batch["labels"] >= 0).sum()), 1)
        return local, axes, share

    def reduce(t: torch.Tensor, axes) -> None:
        for a in axes:  # a sum over the product of the batch axes
            dist.all_reduce(t, group=mesh.get_group(a))

    def train_step(state: dict[str, Any], batch: dict[str, torch.Tensor]):
        local, axes, share = shard_batch(batch)
        shards = 1
        for a in axes:
            shards *= sizes[a]
        if n_route_groups % shards:
            raise ValueError(f"{n_route_groups} routing groups do not split over {shards} "
                             "batch shards")
        p_flat, treedef = flatten_with_paths(state["params"])
        with torch.no_grad():
            full = {k: v.full_tensor() for k, v in p_flat.items()}  # FSDP gather
        leaves = {k: v.detach().requires_grad_(True) for k, v in full.items()}
        loss = model.loss(treedef.unflatten(leaves), local, n_groups=n_route_groups // shards)
        if share != 1.0:
            loss = loss * share
        grads = _gradients(loss, leaves, selection_only)
        del leaves, full
        loss = loss.detach()
        with torch.no_grad():
            if axes:
                reduce(loss, axes)
                for g in grads.values():
                    reduce(g, axes)
            lr = warmup_cosine(_local(state["step"]), peak_lr=peak_lr, warmup=warmup,
                               total=total_steps)
            om = _adamw_sharded(grads, state["opt"], p_flat, lr, opt_cfg)
        del grads
        _local(state["step"]).add_(1)
        _local(state["data"]["data_step"]).add_(1)
        return state, {"loss": loss, "lr": lr, **om}

    mesh_coordinate(mesh)  # this rank must be in the mesh
    return train_step


@torch.no_grad()
def _adamw_sharded(grads: dict[str, torch.Tensor], opt_state: dict, p_flat: dict, lr,
                   cfg: AdamWConfig) -> dict:
    """``optim.adamw.adamw_update`` on DTensor state: ``grads`` whole on
    every rank (already summed), each rank updating its block of the
    moments and the master weights; each param is the new master cast to
    its dtype and gathered to the param's placements."""
    with torch.profiler.record_function("adamw_update"):
        mu_flat, _ = flatten_with_paths(opt_state["mu"])
        nu_flat, _ = flatten_with_paths(opt_state["nu"])
        m_flat, _ = flatten_with_paths(opt_state["master"])
        count = _local(opt_state["count"])
        count += 1
        gnorm = global_norm(grads)
        scale, c1, c2 = adamw_scalars(gnorm, count, cfg)
        for path, g in grads.items():
            master = m_flat[path]
            msh = sharding_of(master)
            adamw_leaf(local_block(g, msh), _local(mu_flat[path]), _local(nu_flat[path]),
                       master.to_local(), scale, c1, c2, lr, cfg)
            p = p_flat[path]
            cast = from_local(master.to_local().to(p.dtype), master.shape, msh)
            p.to_local().copy_(redistribute(cast, sharding_of(p)).to_local())
    return {"grad_norm": gnorm}
