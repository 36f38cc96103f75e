"""DSC itineraries and the Mobile Pipeline (paper §1.5, refs [6][7]).

An *itinerary* is the Lagrangian program the paper advocates: a sequential
list of stages, each annotated with the node where it should execute. The
runner hops the live state between nodes and optionally publishes a CMI
after stages the application marks worthwhile — Figure 8's

    hop(other); read; hop(other); compute; hop(other); write

Stages run where the state lives: on the port's in-process nodes the stage
function is simply called on the state, which sits on that node's device.
(Tours across process-backed nodes, where the stage travels to the state,
need the fabric, which the port does not have yet.)

A :class:`MobilePipeline` runs several itineraries over a stream of work
items in software-pipelined order (ref [7]): item *i* executes stage *s* at
logical tick ``i + s``, so at steady state every node is busy with a
different item.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.core.dhp import DHP
from repro_torch.core.jobstore import STATUS_CKPT
from repro_torch.utils import logger


def ref_obstacle(mod: str | None, qual: str | None, *, bound: bool = False,
                 partial: bool = False) -> str | None:
    """Why a ``(module, qualname)`` pair is NOT worker-addressable, or
    ``None`` when it is (the JAX package's rules, kept so that tours written
    for the port are ready for process-backed nodes)."""
    if bound:
        return "bound method — the worker would misbind the state as `self`"
    if partial:
        return "functools.partial — not importable by name in a worker"
    if not mod or not qual:
        return "no module-qualified name"
    if "<lambda>" in qual:
        return "lambda — has no importable name"
    if "<" in qual:
        return "closure/nested function — its qualname is not importable"
    if mod == "__main__":
        return "defined in __main__ — a worker process cannot import it"
    return None


def _fn_obstacle(fn: Callable) -> str | None:
    return ref_obstacle(
        getattr(fn, "__module__", None),
        getattr(fn, "__qualname__", None),
        bound=getattr(fn, "__self__", None) is not None,
        partial=isinstance(fn, functools.partial),
    )


def stage_ref(fn: Callable) -> str | None:
    """Module-qualified reference (``pkg.mod:qualname``) for a stage
    function, or ``None`` when it is not addressable across processes."""
    if _fn_obstacle(fn) is not None:
        return None
    return f"{fn.__module__}:{fn.__qualname__}"


@dataclass
class Stage:
    dest: str  # node name to hop to before running
    fn: Callable[[Any], Any]  # state -> state
    name: str = ""
    publish: bool = False  # publish a "ckpt" CMI after this stage (Fig. 7)
    # explicit cross-process reference for fn ("pkg.mod:func"); derived from
    # fn's module/qualname when empty
    fn_ref: str = ""


def validate_stages(stages: list["Stage"], nbs=None) -> list[str]:
    """Pre-flight check of a tour: one warning string per migration hazard —
    destinations the NBS has never heard of, and stage functions a worker
    process could not address."""
    problems: list[str] = []
    for i, st in enumerate(stages):
        label = st.name or f"stage{i}"
        if nbs is not None and st.dest not in nbs.nodes:
            problems.append(
                f"stage {label!r} hops to undeclared node {st.dest!r} "
                f"(declared: {sorted(nbs.nodes)})"
            )
        if st.fn_ref:
            continue
        obstacle = _fn_obstacle(st.fn)
        if obstacle is not None:
            problems.append(
                f"stage {label!r} fn is not worker-addressable ({obstacle}); "
                "remote runs will localize the state instead of shipping the "
                "computation"
            )
    return problems


class Itinerary:
    """Run a list of :class:`Stage` as one migrating computation.

    ``via`` selects the hop transport for every move in the tour: ``"auto"``
    (default) moves the state device to device; ``"store"`` forces the
    disk-mediated path (a transit CMI per hop).
    """

    def __init__(self, dhp: DHP, job_id: str | None = None, *, via: str = "auto"):
        self.dhp = dhp
        self.job_id = job_id
        self.via = via
        self.trace: list[tuple[str, str]] = []  # (stage, node) execution log

    def run(self, state: Any, stages: list[Stage], *, start_stage: int = 0,
            step0: int = 0) -> Any:
        """Execute stages sequentially, hopping the state between nodes.

        Publishing stages checkpoint after running (``step0 + i`` numbers
        the CMIs, so resumed tours keep monotone steps).
        """
        if start_stage == 0:
            for problem in validate_stages(stages, self.dhp.nbs):
                logger.warning("itinerary pre-flight: %s", problem)
        for i in range(start_stage, len(stages)):
            st = stages[i]
            if self.dhp.node != st.dest:
                state = self.dhp.hop(state, st.dest, step=step0 + i, via=self.via)
            state = st.fn(state)
            self.trace.append((st.name or f"stage{i}", self.dhp.node))
            if st.publish and self.job_id is not None:
                self._publish_stage(state, i, step0)
        return state

    def _publish_stage(self, state: Any, i: int, step0: int) -> None:
        # record which stage completed so restart skips finished work
        if isinstance(state, dict):
            pub_state = {**state, "itinerary_stage": i + 1}
        else:
            # non-dict states ride in a marked wrapper that resume()
            # unwraps, so the itinerary continues with the original
            # state rather than the bookkeeping dict
            pub_state = {
                "state": state,
                "itinerary_stage": i + 1,
                "itinerary_wrapped": True,
            }
        self.dhp.publish(self.job_id, STATUS_CKPT, pub_state, step=step0 + i)

    def resume(self, stages: list[Stage]) -> Any:
        """Restart an interrupted itinerary from its last published stage.

        The restored CMI's step is threaded back through ``run(step0=...)``
        so post-resume publishes continue the pre-preemption numbering —
        ``keep_last`` GC orders CMIs by step.
        """
        state, step = self.dhp.restart(self.job_id)
        start = 0
        if isinstance(state, dict):
            start = int(state.pop("itinerary_stage", 0))
            if state.pop("itinerary_wrapped", False):
                state = state["state"]
        # the CMI at stage i carried step0 + i and start == i + 1, so this
        # reconstructs the original step0; without stage bookkeeping the
        # restored step itself is the best anchor
        step0 = step - (start - 1) if start > 0 else step
        logger.info("itinerary resume at stage %d/%d (step0=%d)", start, len(stages), step0)
        return self.run(state, stages, start_stage=start, step0=step0)


@dataclass
class MobilePipeline:
    """Software-pipelined execution of one itinerary over many work items."""

    dhp: DHP
    stages: list[Stage]
    tick_log: list[list[tuple[int, str]]] = field(default_factory=list)
    via: str = "auto"

    def run(self, items: list[Any]) -> list[Any]:
        n, s = len(items), len(self.stages)
        states: dict[int, Any] = {}
        done: dict[int, Any] = {}
        for tick in range(n + s - 1):
            active = []
            # reverse stage order so item i's stage s runs before item i+1's s
            for stage_idx in reversed(range(s)):
                item_idx = tick - stage_idx
                if 0 <= item_idx < n:
                    st = self.stages[stage_idx]
                    cur = states.pop(item_idx, None)
                    if cur is None:
                        cur = items[item_idx]
                    if self.dhp.node != st.dest:
                        cur = self.dhp.hop(cur, st.dest, step=tick, via=self.via)
                    cur = st.fn(cur)
                    active.append((item_idx, st.name or f"stage{stage_idx}"))
                    if stage_idx == s - 1:
                        done[item_idx] = cur
                    else:
                        states[item_idx] = cur
            self.tick_log.append(active)
        return [done[i] for i in range(n)]
