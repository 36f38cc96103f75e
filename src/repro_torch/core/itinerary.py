"""DSC itineraries and the Mobile Pipeline (paper §1.5, refs [6][7]).

An *itinerary* is the Lagrangian program the paper advocates: a sequential
list of stages, each annotated with the node where it should execute. The
runner hops the live state between nodes and optionally publishes a CMI
after stages the application marks worthwhile — Figure 8's

    hop(other); read; hop(other); compute; hop(other); write

Stages run **where the state lives**. On an in-process node the stage
function is simply called on the state, which sits on that node's device; on
a process-backed node (``RemoteNode``) the hop left only a
:class:`RemoteStateRef` receipt behind, so the runner sends the stage *to
the state* instead: ``svc/run_stage`` executes the function — addressed by
its module-qualified name, which the worker imports — on the resident state
inside the worker, on the worker's device. Node-to-node moves between
remote stages are worker-initiated streamed relays (``svc/relay``), and the
tour's final product streams back over ``svc/fetch_stream`` — on the happy
path a remote tour never touches the shared store. Every streamed leg falls
back per-hop to the store-mediated path on failure, and mid-tour publishes
(``svc/publish_resident``) are always disk-durable, so the preemption
guarantees are exactly those of local itineraries.

Stage functions that cannot be imported by a worker (lambdas, closures,
partials, ``__main__`` locals) degrade gracefully: the state is fetched back
and the stage runs in the driver — the tour completes, just without the
ship-the-computation win for that stage.

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
from repro_torch.core.nbs import RemoteStateRef
from repro_torch.utils import logger


def ref_obstacle(mod: str | None, qual: str | None, *, bound: bool = False,
                 partial: bool = False) -> str | None:
    """Why a ``(module, qualname)`` pair is NOT worker-addressable, or
    ``None`` when it is (the JAX package's rules: what ``svc/run_stage``
    would refuse, or silently localize, at runtime)."""
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


def declared_destinations(stages: list["Stage"]) -> list[str]:
    """Distinct stage destinations in tour order (first occurrence wins)."""
    seen: dict[str, None] = {}
    for st in stages:
        seen.setdefault(st.dest, None)
    return list(seen)


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


def _exec_stage(dhp: DHP, st: Stage, state: Any, *, step: int = 0,
                via: str = "auto") -> Any:
    """Run one stage function where the state lives.

    Remote-resident state (a receipt) dispatches ``svc/run_stage`` to the
    holding worker; an unaddressable fn localizes the state first.
    """
    if isinstance(state, RemoteStateRef):
        ref = st.fn_ref or stage_ref(st.fn)
        if ref is None:
            logger.info(
                "stage %r is not addressable remotely; localizing state from %s",
                st.name or st.fn, state.node,
            )
            state = dhp.fetch(state, via=via)
        else:
            try:
                r = dhp.nbs.call(state.node, "svc/run_stage",
                                 token=state.token, fn=ref, step=step)
            except Exception as e:
                # the worker could not RESOLVE the reference (module not on
                # its path): degrade like an unaddressable fn — fetch and run
                # here. Failures from the stage body itself still surface.
                if "StageResolutionError" not in str(e):
                    raise
                logger.warning(
                    "stage ref %r unresolvable on %s (%s); localizing",
                    ref, state.node, e,
                )
                state = dhp.fetch(state, via=via)
                return st.fn(state)
            return RemoteStateRef(
                node=r.get("node", state.node),
                token=r["token"],
                step=int(r.get("step", step)),
                leaves=int(r.get("leaves", 0)),
                via=state.via,
            )
    return st.fn(state)


class Itinerary:
    """Run a list of :class:`Stage` as one migrating computation.

    ``via`` selects the transport preference for every hop/relay/fetch in
    the tour: ``"auto"`` (default) moves the state device to device between
    in-process nodes and streams wherever a process boundary lies, with
    transparent store fallback; ``"store"`` forces the disk-mediated path (a
    transit CMI per hop).
    """

    def __init__(self, dhp: DHP, job_id: str | None = None, *, via: str = "auto"):
        self.dhp = dhp
        self.job_id = job_id
        self.via = via
        self.trace: list[tuple[str, str]] = []  # (stage, node) execution log

    def run(self, state: Any, stages: list[Stage], *, start_stage: int = 0,
            step0: int = 0, localize: bool = True) -> Any:
        """Execute stages sequentially, hopping the state between nodes.

        Publishing stages checkpoint after running (``step0 + i`` numbers
        the CMIs, so resumed tours keep monotone steps). With ``localize``
        (default) a tour ending on a process-backed node streams its final
        product back to the caller (``dhp.fetch``: onto the device of the
        node the DHP was made on).
        """
        if start_stage == 0:
            for problem in validate_stages(stages, self.dhp.nbs):
                logger.warning("itinerary pre-flight: %s", problem)
        for i in range(start_stage, len(stages)):
            st = stages[i]
            src = state.node if isinstance(state, RemoteStateRef) else self.dhp.node
            if src != st.dest:
                state = self.dhp.hop(state, st.dest, step=step0 + i, via=self.via)
            state = _exec_stage(self.dhp, st, state, step=step0 + i, via=self.via)
            self.trace.append((st.name or f"stage{i}", self.dhp.node))
            if st.publish and self.job_id is not None:
                self._publish_stage(state, i, step0)
        if localize and isinstance(state, RemoteStateRef):
            state = self.dhp.fetch(state, via=self.via)
        return state

    def _publish_stage(self, state: Any, i: int, step0: int) -> None:
        # record which stage completed so restart skips finished work
        if isinstance(state, RemoteStateRef):
            # the worker holding the state saves the CMI into the job's
            # cmi_root on the shared store — disk-durable, resident untouched
            self.dhp.publish_ref(self.job_id, state, step=step0 + i,
                                 extra={"itinerary_stage": i + 1})
            return
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
    """Software-pipelined execution of one itinerary over many work items.

    Remote stages work exactly as in :class:`Itinerary`: work items whose
    state is resident in a worker are advanced via ``svc/run_stage`` and
    relayed node-to-node; finished items are streamed back before being
    returned.
    """

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
                    src = cur.node if isinstance(cur, RemoteStateRef) else self.dhp.node
                    if src != st.dest:
                        cur = self.dhp.hop(cur, st.dest, step=tick, via=self.via)
                    cur = _exec_stage(self.dhp, st, cur, step=tick, via=self.via)
                    active.append((item_idx, st.name or f"stage{stage_idx}"))
                    if stage_idx == s - 1:
                        if isinstance(cur, RemoteStateRef):
                            cur = self.dhp.fetch(cur, via=self.via)
                        done[item_idx] = cur
                    else:
                        states[item_idx] = cur
            self.tick_log.append(active)
        return [done[i] for i in range(n)]
