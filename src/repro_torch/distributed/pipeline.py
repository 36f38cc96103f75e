"""In-mesh pipeline parallelism — the Mobile Pipeline (paper ref [7]) on a
mesh axis.

Port of the JAX package's ``repro/distributed/pipeline.py``. The NavP
view: a microbatch is a traveler whose itinerary visits every pipeline
stage; a point-to-point send on the stage axis's sub-group is the hop.
GPipe schedule: each rank along the ``stage`` axis holds one stage's
parameters (stacked params sharded on their leading dim); at tick *t*
stage *s* runs microbatch *t − s* and sends its activation to *s + 1*.
Bubble fraction = (S−1)/(M+S−1), the usual GPipe cost. The last stage's
outputs are then broadcast over the axis, so every rank returns them, as
the reference's ``psum`` makes every device hold them.

This is the layer-level counterpart of ``core.itinerary.MobilePipeline``
(which schedules whole jobs across nodes).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.distributed.sharding import NamedSharding, P, axis_sizes, mesh_coordinate
from repro_torch.utils import flatten_with_paths, tree_map, unflatten_from_paths


def _stage_slice(leaf: Any) -> torch.Tensor:
    """This rank's stage of a stacked leaf: the local block of a DTensor
    sharded on its leading dim (:func:`stage_shardings`), one stage."""
    from torch.distributed.tensor import DTensor

    if isinstance(leaf, DTensor):
        local = leaf.to_local()
        if local.shape[0] != 1:
            raise ValueError(f"a stage holds {local.shape[0]} stages of a stacked leaf, not 1")
        return local[0]
    raise TypeError("stacked params must be DTensors placed by stage_shardings")


def pipeline_forward(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stacked_params: Any,  # DTensor leaves with leading dim S = n_stages, sharded on `axis`
    x: torch.Tensor,  # (M, mb, ...) microbatched input, the same on every rank
    mesh,
    axis: str = "model",
) -> torch.Tensor:
    """Run x through S chained stages pipelined over mesh axis ``axis``.

    ``stage_fn(params_for_one_stage, activation) -> activation`` must be
    shape-preserving (residual-block style, like the transformer stacks).
    Returns (M, mb, ...) outputs after all S stages, on every rank.
    """
    import torch.distributed as dist

    n_stages = axis_sizes(mesh)[axis]
    m = x.shape[0]
    flat, treedef = flatten_with_paths(stacked_params)
    first = next(iter(flat.values()))
    if first.shape[0] != n_stages:
        raise ValueError(f"stacked params leading dim {first.shape[0]} != stages {n_stages}")
    group = mesh.get_group(axis)
    names = list(mesh.mesh_dim_names)
    s = mesh_coordinate(mesh)[names.index(axis)]
    peer = [dist.get_global_rank(group, i) for i in range(n_stages)]
    pl = unflatten_from_paths(treedef, {k: _stage_slice(v) for k, v in flat.items()})
    out = torch.zeros_like(x)
    buf = torch.empty_like(x[0])
    for t in range(m + n_stages - 1):
        mb = t - s  # the microbatch at this stage now
        if not 0 <= mb < m:
            continue
        if s == 0:
            cur = x[mb]
        else:
            dist.recv(buf, src=peer[s - 1], group=group)
            cur = buf
        y = stage_fn(pl, cur)
        if s == n_stages - 1:
            out[mb] = y
        else:
            dist.send(y.contiguous(), dst=peer[s + 1], group=group)
    dist.broadcast(out, src=peer[n_stages - 1], group=group)
    return out


def stage_shardings(stacked_params: Any, mesh, axis: str = "model") -> Any:
    """Each stacked leaf sharded on its leading (stage) dim over ``axis``."""
    return tree_map(lambda l: NamedSharding(mesh, P(axis, *([None] * (l.dim() - 1)))),
                    stacked_params)
