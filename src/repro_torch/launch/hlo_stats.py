"""Per-device cost of a traced step: FLOPs, bytes, collectives and memory.

The torch counterpart of the JAX package's ``repro/launch/hlo_stats.py``.
There is no HLO: :class:`StepCounter` is a ``TorchDispatchMode`` that
sees every ATen op one rank runs (under ``FakeTensorMode`` in the dry run,
so nothing is computed or allocated) and returns the reference's keys:

  flops        — ``torch.utils.flop_counter``'s formulas (FlopCounterMode's
                 registry: matrix products, convolutions, attention), K3's
                 own among them (``kernels/flash_attention/ops.py``: 2 (D +
                 Dv) a visible (q, k) pair forward, 2 (4 D + 3 Dv) backward:
                 the two-pass algorithm's products, before the bf16
                 tensor-core kernels split P and dS into hi and lo halves);
  bytes        — per op: output + operand bytes, each tensor at its own
                 (view) size; views, ``detach``, allocations and metadata
                 ops count 0, as the reference's ``_FREE_OPS``. A layer
                 reads its slice of a stacked (L, …) weight through a view,
                 so a sweep over the layers costs one pass over the stack;
  collectives  — count and payload (output) bytes per kind, the reference's
                 names: ``all-reduce``, ``all-gather``, ``reduce-scatter``,
                 ``all-to-all``, ``collective-permute`` (GPipe's send and
                 recv); ``c10d_functional`` ops (DTensor's redistributes,
                 the tensor-parallel collectives of ``distributed/tp.py``)
                 and the in-place ``c10d`` ops (``dist.all_reduce``) both.

The models loop over their layers in Python, so every layer's ops are seen
and there is no trip count to recover. An op on DTensors is left to
DTensor, whose ops on the local blocks are the ones counted: every number
is this rank's.

The same mode keeps the live storages (weakrefs, freed when their last
tensor goes): :meth:`StepCounter.memory` gives the reference's
``memory_analysis`` keys per device.

    python -m repro_torch.launch.hlo_stats --arch qwen3-1.7b --shape prefill_32k --device cpu

prints one cell's counts (the dry run's trace, ``launch/dryrun.py``).
"""

from __future__ import annotations

import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")

# functional collectives: the payload is the output
_FUNCTIONAL = {
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::all_reduce_coalesced_": "all-reduce",
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_out": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
}
# in-place c10d ops: the payload is the tensors of the first argument (the
# outputs, written in place; a send's input)
_IN_PLACE = {
    "c10d::allreduce_": "all-reduce",
    "c10d::allreduce_coalesced_": "all-reduce",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allgather_coalesced_": "all-gather",
    "c10d::allgather_into_tensor_coalesced_": "all-gather",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d::alltoall_": "all-to-all",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::send": "collective-permute",
    "c10d::recv_": "collective-permute",
    "c10d::recv_any_source_": "collective-permute",
}
# ops that move no bytes: allocation, metadata, waits (views are found by
# their schema)
_FREE = {
    "aten::detach", "aten::alias", "aten::lift_fresh", "aten::empty", "aten::empty_like",
    "aten::empty_strided", "aten::new_empty", "aten::new_empty_strided", "aten::sym_size",
    "aten::sym_stride", "aten::sym_numel", "aten::sym_storage_offset", "aten::is_contiguous",
    "aten::_local_scalar_dense", "prim::device", "prim::layout", "prim::dtype",
    "_c10d_functional::wait_tensor", "c10d::barrier", "c10d::monitored_barrier_",
}


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts what one rank runs while the mode is on (see the module's
    docstring). :meth:`result` gives ``{flops, bytes, collectives}``;
    :meth:`hold` registers the step's arguments, :meth:`memory` the
    per-device sizes after it."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.by_kind: dict[str, dict[str, float]] = {}
        self.by_op: dict[str, int] = {}  # flops by op, for reading a cell
        self._live: dict[int, tuple[weakref.ref, int]] = {}  # storage id -> (ref, bytes)
        self.live_bytes = 0
        self.peak_bytes = 0
        self.argument_bytes = 0
        self._args: set[int] = set()

    # -- live storages ------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live and self._live[key][0]() is st:
            return
        n = st.nbytes()
        self._live[key] = (weakref.ref(st, self._freed(key, n)), n)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _freed(self, key: int, n: int):
        def callback(ref) -> None:
            entry = self._live.get(key)
            if entry is not None and entry[0] is ref:
                del self._live[key]
                self.live_bytes -= n
        return callback

    def hold(self, *trees: Any) -> None:
        """Count the storages of these trees' tensors (a DTensor's local
        block) as live from the start: the step's arguments."""
        for t in _tensors(trees):
            self._track(_local(t))
            self._args.add(id(_local(t).untyped_storage()))
        self.argument_bytes = self.live_bytes

    def memory(self, outputs: Any) -> dict[str, int]:
        """The reference's ``memory_analysis`` keys, this rank's: arguments
        (held at the start), outputs (the storages ``outputs`` reach that
        the step made), the peak of live storages, and the rest of the
        peak as temporaries."""
        out, seen = 0, set(self._args)  # an argument written in place is no output
        for t in _tensors(outputs):
            st = _local(t).untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                out += st.nbytes()
        return {"argument_size_in_bytes": self.argument_bytes, "output_size_in_bytes": out,
                "temp_size_in_bytes": max(0, self.peak_bytes - self.argument_bytes - out),
                "peak_memory_in_bytes": self.peak_bytes}

    # -- the counts ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        inputs = _tensors((args, kwargs))
        if any(_is_dtensor(t) for t in inputs):
            return NotImplemented  # DTensor runs it on the local blocks, counted there
        out = func(*args, **kwargs)
        outputs = _tensors(out)
        for t in outputs:
            self._track(t)
        name = func._schema.name
        if name in _FREE or func.is_view:
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += n
            self.by_op[str(packet)] = self.by_op.get(str(packet), 0) + n
        self.bytes += sum(_nbytes(t) for t in inputs) + sum(_nbytes(t) for t in outputs)
        kind = _FUNCTIONAL.get(name)
        payload = outputs
        if kind is None and name in _IN_PLACE:
            kind, payload = _IN_PLACE[name], _tensors(args[0] if args else ())
        if kind is not None:
            e = self.by_kind.setdefault(kind, {"count": 0, "bytes": 0.0})
            e["count"] += 1
            e["bytes"] += float(sum(_nbytes(t) for t in payload))
        return out

    def result(self) -> dict:
        return {
            "flops": float(self.flops),
            "bytes": float(self.bytes),
            "collectives": {
                "total_bytes": sum(v["bytes"] for v in self.by_kind.values()),
                "total_count": sum(v["count"] for v in self.by_kind.values()),
                "by_kind": {k: dict(v) for k, v in self.by_kind.items()},
            },
        }


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor  # imported by then: a dict lookup

    return isinstance(t, DTensor)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if _is_dtensor(t) else t


def count(fn, *args, **kwargs) -> tuple[Any, dict]:
    """``(fn(*args, **kwargs), StepCounter.result())``."""
    counter = StepCounter()
    with counter:
        out = fn(*args, **kwargs)
    return out, counter.result()


def main(argv: list[str] | None = None) -> dict:
    """Print one cell's counts: ``--arch``, ``--shape``, ``--multi-pod``,
    ``--device`` (the dry run's)."""
    import argparse
    import json

    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun

    ap = argparse.ArgumentParser(description="one dry-run cell's per-device counts")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    rec = dryrun.trace_in_group(args.arch, args.shape, args.multi_pod, args.device)
    print(json.dumps(rec, indent=1))
    return rec


if __name__ == "__main__":
    main()
