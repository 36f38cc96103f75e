"""Spot-instance preemption: notices, schedules, and the market simulator.

Paper context (§2.2, §5 Q1): EC2 spot instances are ~90% cheaper but give a
2-minute termination notice — too short to checkpoint a large job from
scratch, which is exactly why the paper publishes CMIs *proactively* at
application-chosen points and treats the notice as "finish the current step,
publish, exit".

Pieces:
  * :class:`PreemptionNotice` — thread-safe notice flag with a deadline.
    Installable on SIGTERM (the real notice path) or driven programmatically
    (tests / simulator).
  * :class:`SpotSchedule` — deterministic or hazard-rate preemption event
    source, seedable for reproducible end-to-end kill/resume tests.
  * :func:`run_preemptible` — supervision loop: run a worker, catch
    :class:`~repro_torch.core.dhp.Preempted`, provision a "new instance" (possibly
    a different mesh shape — elastic), resume from the job store.
  * :class:`SpotMarket` — price model used by the cost benchmark.
"""

from __future__ import annotations

import signal
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from repro_torch.core.dhp import Preempted
from repro_torch.utils import logger


class PreemptionNotice:
    """The 2-minute-warning flag a worker polls between steps."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._deadline: float | None = None

    def notify(self, grace_s: float = 120.0) -> None:
        with self._lock:
            self._deadline = time.time() + grace_s
        logger.warning("preemption notice: %.0fs grace", grace_s)

    def clear(self) -> None:
        with self._lock:
            self._deadline = None

    def imminent(self) -> bool:
        with self._lock:
            return self._deadline is not None

    def time_left(self) -> float:
        with self._lock:
            return float("inf") if self._deadline is None else max(0.0, self._deadline - time.time())

    def can_fit(self, duration_s: float, *, safety: float = 2.0) -> bool:
        """Would an action taking ``duration_s`` finish inside the grace?

        ``safety`` (default 2x) covers publish-cost variance: a publish that
        gets SIGKILLed mid-commit wastes the whole grace AND leaves a torn
        stage dir, so workers only start one they are confident about.
        """
        return self.time_left() >= duration_s * safety

    def install_sigterm(self, grace_s: float = 120.0) -> None:
        signal.signal(signal.SIGTERM, lambda *_: self.notify(grace_s))


@dataclass
class HazardTrace:
    """A per-step reclaim-hazard (and price) time series for one node class.

    Real spot markets are non-stationary: hazard spikes when the on-demand
    pool tightens and prices climb with it. A trace captures that as a plain
    array the simulator and the fleet scheduler both index by step; past the
    end the last value holds (markets do not un-exist).
    """

    hazard: tuple[float, ...]  # P(reclaim) at each step index
    price: tuple[float, ...] = ()  # optional $/hour per step (same indexing)
    notice_frac: float = 1.0  # fraction of reclaims that arrive WITH notice
    name: str = "trace"

    def hazard_at(self, step: int) -> float:
        if not self.hazard:
            return 0.0
        return float(self.hazard[min(max(step, 0), len(self.hazard) - 1)])

    def price_at(self, step: int) -> float:
        if not self.price:
            return 0.0
        return float(self.price[min(max(step, 0), len(self.price) - 1)])

    @staticmethod
    def constant(hazard: float, steps: int = 1, *, notice_frac: float = 1.0,
                 name: str = "constant") -> "HazardTrace":
        return HazardTrace(hazard=(float(hazard),) * max(1, steps),
                           notice_frac=notice_frac, name=name)

    @staticmethod
    def diurnal(base: float, peak: float, period: int, steps: int, *,
                notice_frac: float = 1.0, name: str = "diurnal") -> "HazardTrace":
        """Sinusoidal day/night cycle between ``base`` and ``peak`` hazard."""
        t = np.arange(max(1, steps))
        wave = 0.5 * (1.0 - np.cos(2.0 * np.pi * t / max(1, period)))
        hz = base + (peak - base) * wave
        price = 1.0 + 9.0 * wave  # price rides the same tightness signal
        return HazardTrace(hazard=tuple(float(h) for h in hz),
                           price=tuple(float(p) for p in price),
                           notice_frac=notice_frac, name=name)

    @staticmethod
    def bursty(calm: float, storm: float, storm_at: int, storm_len: int,
               steps: int, *, notice_frac: float = 1.0,
               name: str = "bursty") -> "HazardTrace":
        """Calm background hazard with one capacity-crunch storm window."""
        hz = [float(calm)] * max(1, steps)
        for i in range(storm_at, min(storm_at + storm_len, len(hz))):
            hz[i] = float(storm)
        return HazardTrace(hazard=tuple(hz), notice_frac=notice_frac, name=name)


@dataclass
class SpotSchedule:
    """Preemption events, by step (deterministic), hazard rate, or trace."""

    preempt_steps: tuple[int, ...] = ()  # deterministic: preempt before these steps
    hazard_per_step: float = 0.0  # P(reclaim) each step (flat)
    seed: int = 0
    max_preemptions: int = 1_000_000
    trace: HazardTrace | None = None  # non-stationary hazard (wins over flat)
    notice_frac: float = 1.0  # P(reclaim arrives as SIGTERM-with-notice)
    _rng: np.random.Generator = field(init=False, repr=False)
    _notice_rng: np.random.Generator = field(init=False, repr=False)
    _count: int = field(default=0, init=False)

    def __post_init__(self) -> None:
        self._rng = np.random.default_rng(self.seed)
        # Separate stream for notice-type draws, consumed ONLY on hits: the
        # hazard stream must stay one-draw-per-call (see should_preempt), so
        # notice draws cannot share it without breaking seed determinism.
        self._notice_rng = np.random.default_rng(self.seed ^ 0x9E3779B9)
        if self.trace is not None:
            self.notice_frac = self.trace.notice_frac

    def _hazard_at(self, step: int) -> float:
        if self.trace is not None:
            return self.trace.hazard_at(step)
        return self.hazard_per_step

    def should_preempt(self, step: int) -> bool:
        # Draw the hazard unconditionally (one draw per call whenever a
        # hazard is configured): short-circuiting on preempt_steps or the
        # budget would make the RNG stream depend on which steps hit, so two
        # schedules sharing a seed would diverge after the first difference.
        hazard = self._hazard_at(step)
        hazard_hit = hazard > 0 and self._rng.random() < hazard
        if self._count >= self.max_preemptions:
            return False
        hit = step in self.preempt_steps or hazard_hit
        if hit:
            self._count += 1
        return hit

    def draw_notice(self) -> bool:
        """After a hit: does this reclaim come with the 2-minute notice
        (SIGTERM) or not (straight SIGKILL)? Drawn from a dedicated stream so
        calling or not calling this never shifts ``should_preempt``'s draws."""
        if self.notice_frac >= 1.0:
            return True
        if self.notice_frac <= 0.0:
            return False
        return bool(self._notice_rng.random() < self.notice_frac)


class FleetSchedule:
    """Per-node preemption schedules with correlated fleet-wide shocks.

    Real reclaims are correlated — a capacity crunch takes out many spot
    instances in one sweep. Each node gets its own :class:`SpotSchedule`
    (seeded from ``(seed, node name)`` so fleets are reproducible node-by-
    node), plus a shared "common shock" stream: with probability
    ``shock_per_step`` a step is a fleet-wide event and EVERY node's
    ``should_preempt`` reports a hit at that step, with notice drawn from
    the node's own stream as usual.
    """

    def __init__(
        self,
        traces: dict[str, HazardTrace],
        *,
        seed: int = 0,
        shock_per_step: float = 0.0,
        shock_notice_frac: float = 0.0,  # crunches usually give NO notice
    ):
        self.traces = dict(traces)
        self.seed = int(seed)
        self.shock_per_step = float(shock_per_step)
        self.shock_notice_frac = float(shock_notice_frac)
        self._lock = threading.Lock()
        self._shock_rng = np.random.default_rng(self.seed ^ 0x5F3759DF)
        # step index -> bool, drawn once and shared by every node that asks
        # (nodes poll from different threads at their own pace; the cache is
        # what makes the shock COMMON instead of independent per node)
        self._shock_draws: dict[int, bool] = {}

    def _shock_at(self, step: int) -> bool:
        if self.shock_per_step <= 0:
            return False
        with self._lock:
            while len(self._shock_draws) <= step:
                i = len(self._shock_draws)
                self._shock_draws[i] = bool(self._shock_rng.random() < self.shock_per_step)
            return self._shock_draws[step]

    def node_schedule(self, name: str) -> "_FleetNodeSchedule":
        trace = self.traces.get(name) or self.traces.get("*") \
            or HazardTrace.constant(0.0)
        # crc32, not hash(): string hashing is randomized per process, and
        # "reproducible node-by-node" must hold across runs and processes
        node_seed = (self.seed * 1_000_003 + (zlib.crc32(name.encode()) & 0xFFFF)) & 0x7FFFFFFF
        return _FleetNodeSchedule(
            fleet=self,
            schedule=SpotSchedule(seed=node_seed, trace=trace),
        )


@dataclass
class _FleetNodeSchedule:
    """One node's view of a :class:`FleetSchedule` — duck-compatible with
    :class:`SpotSchedule` (``should_preempt`` / ``draw_notice``)."""

    fleet: FleetSchedule
    schedule: SpotSchedule
    _shock_hit: bool = field(default=False, init=False)

    def should_preempt(self, step: int) -> bool:
        own = self.schedule.should_preempt(step)  # always draw (determinism)
        self._shock_hit = self.fleet._shock_at(step)
        return own or self._shock_hit

    def draw_notice(self) -> bool:
        if self._shock_hit:
            # fleet-wide crunch: notice policy comes from the fleet, drawn
            # from the node's dedicated notice stream to stay reproducible
            frac = self.fleet.shock_notice_frac
            if frac >= 1.0:
                return True
            if frac <= 0.0:
                return False
            return bool(self.schedule._notice_rng.random() < frac)
        return self.schedule.draw_notice()


class AdaptiveCadence:
    """Young–Daly publish cadence from measured cost and observed hazard.

    The optimal checkpoint interval for publish cost ``C`` and per-step
    failure probability ``h`` over steps of ``s`` seconds is the Young–Daly
    point ``n* = sqrt(2 C / (h s))`` steps. Everything on the right is
    *measurable at runtime*: the worker times its own publishes, times its
    steps, and reads the reclaim hazard off the market signal (or estimates
    it from observed reclaims). The cadence then tracks the market — sparse
    publishing while calm, dense the moment hazard spikes — instead of
    freezing a guess at submit time.

    All inputs are EMA-smoothed so one slow publish or one hazard blip does
    not whipsaw the cadence.
    """

    def __init__(
        self,
        *,
        publish_cost_s: float = 1.0,  # prior until first measurement
        step_s: float = 0.1,
        hazard_per_step: float = 1e-4,
        min_every: int = 1,
        max_every: int = 500,
        ema: float = 0.3,
    ):
        self.publish_cost_s = float(publish_cost_s)
        self.step_s = float(step_s)
        self.hazard_per_step = float(hazard_per_step)
        self.min_every = int(min_every)
        self.max_every = int(max_every)
        self.ema = float(ema)

    def _blend(self, old: float, new: float) -> float:
        return (1.0 - self.ema) * old + self.ema * float(new)

    def observe_publish(self, seconds: float) -> None:
        self.publish_cost_s = self._blend(self.publish_cost_s, seconds)

    def observe_step(self, seconds: float) -> None:
        self.step_s = self._blend(self.step_s, seconds)

    def observe_hazard(self, hazard_per_step: float) -> None:
        self.hazard_per_step = self._blend(self.hazard_per_step, hazard_per_step)

    def publish_every(self) -> int:
        """Steps between publishes: ``clamp(round(sqrt(2C / (h s))))``."""
        h = max(self.hazard_per_step, 1e-12)
        s = max(self.step_s, 1e-9)
        n = np.sqrt(2.0 * self.publish_cost_s / (h * s))
        return int(np.clip(round(n), self.min_every, self.max_every))


def run_preemptible(
    make_worker: Callable[[int], Callable[[], Any]],
    *,
    max_restarts: int = 16,
) -> tuple[Any, int]:
    """Supervision loop: ``make_worker(incarnation)() -> result``.

    The worker raises :class:`Preempted` when its instance is reclaimed; the
    supervisor provisions the next incarnation (the factory may hand back a
    worker bound to a *different* mesh — elastic restart). Returns
    ``(result, incarnations_used)``.
    """
    for incarnation in range(max_restarts + 1):
        worker = make_worker(incarnation)
        try:
            return worker(), incarnation + 1
        except Preempted as e:
            logger.info("incarnation %d preempted (%s); restarting", incarnation, e)
    raise RuntimeError(f"exceeded {max_restarts} restarts")


@dataclass
class SpotMarket:
    """Price model for the cost benchmark (paper §2.2: ~90% discount)."""

    on_demand_per_hour: float = 3.0  # m4.4xlarge-ish
    spot_discount: float = 0.9
    mean_uptime_hours: float = 6.0  # exponential reclaim model
    seed: int = 0

    @property
    def spot_per_hour(self) -> float:
        return self.on_demand_per_hour * (1.0 - self.spot_discount)

    def sample_uptimes(self, n: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        return rng.exponential(self.mean_uptime_hours, size=n)

    def cost_to_finish(
        self,
        work_hours: float,
        *,
        publish_period_hours: float,
        publish_overhead_hours: float,
        restart_overhead_hours: float = 0.05,
        use_checkpoints: bool = True,
        trials: int = 512,
    ) -> dict[str, float]:
        """Monte-Carlo cost/makespan of finishing ``work_hours`` on spot.

        Without checkpoints an interrupted *atomic* job restarts from zero
        (the paper's problem 1); with application-initiated publishes only
        work since the last publish is lost.
        """
        rng = np.random.default_rng(self.seed + 1)
        costs, spans = [], []
        for _ in range(trials):
            done = 0.0
            paid = 0.0
            span = 0.0
            while done < work_hours:
                up = rng.exponential(self.mean_uptime_hours)
                if use_checkpoints:
                    # progress advances in publish_period quanta + overhead
                    usable = up
                    prog = 0.0
                    while usable > 0 and done + prog < work_hours:
                        need = min(publish_period_hours, work_hours - done - prog)
                        cost_step = need + publish_overhead_hours
                        if usable >= cost_step:
                            usable -= cost_step
                            prog += need
                        else:
                            break  # partial period lost
                    ran = up - max(0.0, usable)
                    done += prog
                else:
                    ran = min(up, work_hours + 0.0)
                    if up >= work_hours - done:
                        ran = work_hours - done
                        done = work_hours
                    # else: atomic job lost entirely, done stays
                paid += ran * self.spot_per_hour
                span += ran + restart_overhead_hours
            costs.append(paid)
            spans.append(span)
        on_demand_cost = work_hours * self.on_demand_per_hour
        return {
            "spot_cost": float(np.mean(costs)),
            "spot_cost_p90": float(np.percentile(costs, 90)),
            "makespan_hours": float(np.mean(spans)),
            "on_demand_cost": on_demand_cost,
            "savings_frac": float(1.0 - np.mean(costs) / on_demand_cost),
        }
