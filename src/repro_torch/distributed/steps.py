"""Step builders on one device: init and train.

Port of the single-device half of the JAX package's
``repro/distributed/steps.py``. Training state layout (a plain dict,
CMI-serializable, the reference's paths and dtypes, so a train-state CMI
crosses between the packages):

    {"params": ..., "opt": {mu, nu, master, count}, "step": int32[],
     "rng": uint32[2], "data": {"data_step": int32[], "seed": int32[]}}

The train step updates the state in place (see ``optim/adamw.py``) and
returns it. There are no shardings yet: meshes, FSDP and the prefill and
decode step builders come with the multi-card slice (ROADMAP item 11).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import Model, TensorSpec, tree_from_numpy
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
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


def make_init_fn(cfg: ArchConfig, opt_cfg: AdamWConfig, *, seed: int = 0, device=None):
    """Returns ``() -> state`` on ``device`` (default: the CUDA card), the
    weights drawn from a ``torch.Generator`` seeded with ``seed`` (not the
    reference's numbers: :func:`train_state_from_numpy` carries those)."""
    dev = resolve_device(device)
    model = Model(cfg)

    def init_fn() -> dict[str, Any]:
        params = model.init(torch.Generator(dev).manual_seed(seed))
        return {
            "params": params,
            "opt": init_opt_state(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32, device=dev),
            "rng": torch.tensor([0, seed + 1], dtype=torch.uint32, device=dev),
            "data": {"data_step": torch.zeros((), dtype=torch.int32, device=dev),
                     "seed": torch.tensor(seed, dtype=torch.int32, device=dev)},
        }

    return init_fn


def train_state_from_numpy(tree: Any, cfg: ArchConfig, opt_cfg: AdamWConfig,
                           device) -> dict[str, Any]:
    """The JAX package's train state (numpy leaves) as the port's on
    ``device``, checked against :func:`state_specs`."""
    return tree_from_numpy(tree, state_specs(cfg, opt_cfg), device)


def batch_to_device(batch: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """A pipeline batch (numpy) as tensors on ``device``; uint16 arrays are
    bf16 bits (the encoder's frames) and become bf16."""
    def tensor(v):
        t = torch.from_numpy(np.ascontiguousarray(v))
        return t.view(torch.bfloat16) if v.dtype == np.uint16 else t

    return {k: tensor(v).to(device) for k, v in batch.items()}


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000, n_route_groups: int = 0,
                    moe_buf_shard: bool = False):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the loss and
    its gradient, the warmup-cosine learning rate at ``state["step"]``, one
    AdamW update, the step and data counters advanced, all in place on
    ``state``. ``metrics``: 0-d tensors ``loss``, ``lr``, ``grad_norm``.

    MoE routing groups default to the data-parallel degree, as in the
    reference: 1 on one device, so a step routes its whole batch as one
    group. ``moe_buf_shard`` shards the dispatch buffer over a mesh's
    expert axes, so it comes with the meshes."""
    if moe_buf_shard:
        raise NotImplementedError(
            "moe_buf_shard shards the MoE dispatch buffer over a mesh: it comes with the "
            "multi-card slice (ROADMAP queue 1, item 11: distributed/*)")
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
        grads = dict(zip(reached, torch.autograd.grad(loss, [leaves[k] for k in reached])))
        grads = treedef.unflatten({k: grads[k] if k in grads else torch.zeros_like(v)
                                   for k, v in leaves.items()})
        lr = warmup_cosine(state["step"], peak_lr=peak_lr, warmup=warmup, total=total_steps)
        om = adamw_update(grads, state["opt"], params, lr, opt_cfg)
        del grads
        state["step"] += 1
        state["data"]["data_step"] += 1
        return state, {"loss": loss.detach(), "lr": lr, **om}

    return train_step
