"""Online straggler-discipline controller (≙ ``distributedmnist_tpu/
train/discipline.py``, the same decisions on the same inputs).

The source paper studies sync-with-backup-workers, quorum, timeout and
interval aggregation as static configurations chosen beforehand; this
controller watches the rolling per-replica step-time CDF (the
Trainer's :class:`..obsv.timing.StepTimeCollector`) and adapts the
discipline's quorum ``k`` and ``timeout_ms`` while the run goes on.

* :func:`decide` is pure — no clock, no IO, no torch. Its signal is the
  window tail ratio: p99 over the fastest replica's median (the cohort
  pace); dead-band hysteresis between ``adaptive_tail_high`` (tighten)
  and ``adaptive_tail_low`` (relax), a cooldown in steps from the last
  change.
* :class:`DisciplineController` executes decisions: it journals the
  ``event: "discipline"`` begin/complete pair (the reference's
  ``obsv/schema.py`` records), swaps the ``[3]`` discipline vector the
  train step reads every call (``parallel/api.py
  make_discipline_vector``: no rebuild) and keeps the epoch trace.
* :func:`threshold_holds` is the predicate the begin record's ``value
  op threshold`` claim is made with, and that the reference's replay
  invariant (``obsv/invariants.py`` ``discipline``) re-checks.

Every process runs the same controller on the same ``[n]`` times (they
are computed alike on every process), so all processes swap alike; only
the writer's journal records the pair.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Sequence

from ..core.config import SyncConfig
from ..core.log import get_logger

logger = get_logger("discipline")

# the only trigger the controller emits; the reference's invariant
# rejects a license naming anything else
TAIL_RATIO = "tail_ratio"


def threshold_holds(value: float, op: str, threshold: float) -> bool:
    """Does ``value op threshold`` hold? Shared between decide() and the
    replay invariant."""
    return value >= threshold if op == ">=" else value <= threshold


@dataclasses.dataclass(frozen=True)
class DisciplineParams:
    """The runtime aggregation-discipline parameters (one epoch)."""

    k: int                 # quorum size (quorum mode)
    timeout_ms: float      # deadline (timeout mode)
    interval_ms: float     # interval window (never adapted — wall-clock
    #                        pacing only; see SyncConfig.validate)
    num_replicas: int


@dataclasses.dataclass(frozen=True)
class WindowStats:
    """Rolling-window CDF summary of the per-replica step times (ms).

    ``fast_p50_ms`` is the fastest replica's window median — the cohort
    pace. The pooled p50 is contaminated once the straggling fraction
    approaches half the replicas (two 8x stragglers of four drag the
    pooled median to the midpoint and the ratio into the dead band,
    exactly when tightening matters most); the fastest median stays the
    healthy cohort's pace at any straggler fraction below n."""

    p50_ms: float
    p90_ms: float
    p99_ms: float
    n_samples: int
    fast_p50_ms: float = 0.0   # 0 = unknown: fall back to pooled p50

    @property
    def base_ms(self) -> float:
        """The tail ratio's denominator: the cohort pace."""
        return self.fast_p50_ms if self.fast_p50_ms > 0.0 else self.p50_ms

    @property
    def tail_ratio(self) -> float:
        """p99 over the cohort pace — the straggler signal. >= 1 by
        construction when the window is non-degenerate; 0 marks an
        unusable window."""
        if self.base_ms <= 0.0:
            return 0.0
        return self.p99_ms / self.base_ms


@dataclasses.dataclass(frozen=True)
class Decision:
    """One licensed discipline change — mirrors the ``begin`` record."""

    decision: str          # "tighten" | "relax"
    trigger: str           # TAIL_RATIO
    value: float           # observed signal (rounded)
    threshold: float       # the mark it crossed
    op: str                # ">=" (tighten) | "<=" (relax)
    old_k: int
    new_k: int
    old_timeout_ms: float
    new_timeout_ms: float


def static_params(cfg: SyncConfig, num_replicas: int) -> DisciplineParams:
    """The configured (pre-adaptation) discipline — also the ceiling
    relax steps back toward."""
    k = (num_replicas if cfg.num_replicas_to_aggregate == -1
         else cfg.num_replicas_to_aggregate)
    return DisciplineParams(k=k, timeout_ms=float(cfg.timeout_ms),
                            interval_ms=float(cfg.interval_ms),
                            num_replicas=num_replicas)


def quorum_floor(cfg: SyncConfig, num_replicas: int) -> int:
    """Lowest k the controller may tighten to: ceil(n · min_frac),
    never below 1 — arXiv:1604.00981's caution that too few
    contributors costs more in gradient quality than it buys in wait."""
    return max(1, math.ceil(num_replicas * cfg.adaptive_min_quorum_frac))


def decide(cfg: SyncConfig, window_stats: WindowStats | None,
           current: DisciplineParams, last_change_t: float | None,
           now: float) -> Decision | None:
    """The pure controller core.

    ``last_change_t``/``now`` are STEP indices (the controller's clock
    is the step counter — wall time would make decisions depend on host
    speed and break the seeded-replay contract). Returns None inside
    the cooldown, inside the dead band, on a short/degenerate window,
    or when the indicated change is a no-op (already at a bound).
    """
    if not cfg.adaptive:
        return None
    if window_stats is None or window_stats.n_samples < cfg.adaptive_window_steps:
        return None
    if (last_change_t is not None
            and (now - last_change_t) < cfg.adaptive_cooldown_steps):
        return None
    ratio = window_stats.tail_ratio
    if ratio <= 0.0:  # degenerate window (p50 == 0)
        return None

    def _mk(decision: str, threshold: float, op: str, new_k: int,
            new_timeout: float) -> Decision | None:
        if new_k == current.k and round(new_timeout, 6) == round(
                current.timeout_ms, 6):
            return None  # at the bound already — not a change
        return Decision(
            decision=decision, trigger=TAIL_RATIO,
            value=round(ratio, 6), threshold=threshold, op=op,
            old_k=current.k, new_k=new_k,
            old_timeout_ms=round(current.timeout_ms, 6),
            new_timeout_ms=round(new_timeout, 6))

    static = static_params(cfg, current.num_replicas)
    if threshold_holds(ratio, ">=", cfg.adaptive_tail_high):
        # tail blown out past the high mark: TIGHTEN — stop waiting for
        # the stragglers the window just measured
        if cfg.mode == "quorum":
            new_k = max(quorum_floor(cfg, current.num_replicas),
                        current.k - 1)
            return _mk("tighten", cfg.adaptive_tail_high, ">=", new_k,
                       current.timeout_ms)
        # timeout mode: pull the deadline to a multiple of the cohort
        # pace — drops exactly the tail that blew the ratio
        target = max(cfg.adaptive_timeout_floor_ms,
                     window_stats.base_ms * cfg.adaptive_timeout_factor)
        target = min(target, static.timeout_ms)
        if current.timeout_ms > 0 and abs(
                target - current.timeout_ms) / current.timeout_ms < 0.01:
            return None  # sub-percent retarget: dead band, not a change
        return _mk("tighten", cfg.adaptive_tail_high, ">=", current.k,
                   target)
    if threshold_holds(ratio, "<=", cfg.adaptive_tail_low):
        # tail back under the low mark: RELAX one notch toward the
        # configured static discipline (never past it)
        if cfg.mode == "quorum":
            new_k = min(static.k, current.k + 1)
            return _mk("relax", cfg.adaptive_tail_low, "<=", new_k,
                       current.timeout_ms)
        if current.timeout_ms >= static.timeout_ms:
            return None
        return _mk("relax", cfg.adaptive_tail_low, "<=", current.k,
                   static.timeout_ms)
    return None  # dead band between the marks


class DisciplineController:
    """Executes :func:`decide` against the live run.

    The trainer calls :meth:`maybe_adapt` at flush cadence with the
    rolling window stats; on a decision the controller journals the
    ``begin`` record, stages the new discipline vector via
    ``make_vector`` (``parallel/api.py make_discipline_vector``: a
    3-number host tensor the step reads every call, no rebuild), then
    journals ``complete`` with the staging reaction time and the first
    step the new epoch governs.

    ``emit`` is the trainer's journal writer (train_log.jsonl) — the
    begin/complete pair lands in the SAME log as the step records the
    replay invariant matches them against.
    """

    def __init__(self, cfg: SyncConfig, num_replicas: int,
                 emit: Callable[[dict], None],
                 make_vector: Callable[[float, float, float], Any],
                 clock: Callable[[], float] = time.time) -> None:
        cfg.validate(num_replicas=num_replicas)
        if not cfg.adaptive:
            raise ValueError("DisciplineController requires "
                             "sync.adaptive=true")
        self.cfg = cfg
        self.num_replicas = num_replicas
        self.current = static_params(cfg, num_replicas)
        self._emit = emit
        self._make_vector = make_vector
        self._clock = clock
        self.vector = make_vector(self.current.k, self.current.timeout_ms,
                                  self.current.interval_ms)
        self.last_change_step: float | None = None
        self.changes = 0
        # epoch trace: (effective_step, k, timeout_ms) per change — the
        # per-window discipline trace benches/summaries report
        self.trace: list[tuple[int, int, float]] = []

    def params_list(self) -> list[float]:
        """The [k, timeout_ms] pair step records observe."""
        return [float(self.current.k), round(self.current.timeout_ms, 6)]

    def maybe_adapt(self, step: int,
                    window_stats: WindowStats | None) -> Decision | None:
        """Evaluate the pure core at ``step``; execute + journal any
        decision. Returns the decision (None = no change)."""
        d = decide(self.cfg, window_stats, self.current,
                   self.last_change_step, float(step))
        if d is None:
            return None
        now = self._clock()
        self._emit({
            "event": "discipline", "action": "begin", "time": now,
            "decision": d.decision, "trigger": d.trigger,
            "value": d.value, "threshold": d.threshold, "op": d.op,
            "old_k": d.old_k, "new_k": d.new_k,
            "old_timeout_ms": d.old_timeout_ms,
            "new_timeout_ms": d.new_timeout_ms, "at_step": int(step),
            "window_steps": self.cfg.adaptive_window_steps,
            "cooldown_steps": self.cfg.adaptive_cooldown_steps,
            "p50_ms": round(window_stats.p50_ms, 6),
            "p99_ms": round(window_stats.p99_ms, 6),
            "num_replicas": self.num_replicas,
        })
        self.current = dataclasses.replace(
            self.current, k=d.new_k, timeout_ms=d.new_timeout_ms)
        # the swap itself: a fresh [3] vector for the next step_fn call
        self.vector = self._make_vector(
            self.current.k, self.current.timeout_ms,
            self.current.interval_ms)
        effective = int(step) + 1  # first step the new epoch governs
        self._emit({
            "event": "discipline", "action": "complete",
            "time": self._clock(), "decision": d.decision,
            "trigger": d.trigger,
            "reaction_s": round(self._clock() - now, 6),
            "k": d.new_k, "timeout_ms": d.new_timeout_ms,
            "effective_step": effective,
        })
        self.last_change_step = float(step)
        self.changes += 1
        self.trace.append((effective, d.new_k,
                           round(d.new_timeout_ms, 6)))
        logger.info(
            "discipline %s @ step %d: %s=%s %s %s -> k=%d timeout=%.1fms",
            d.decision, step, d.trigger, d.value, d.op, d.threshold,
            d.new_k, d.new_timeout_ms)
        return d

    def summary(self) -> dict:
        """Roll-up for run summaries."""
        return {
            "changes": self.changes,
            "current_k": self.current.k,
            "current_timeout_ms": round(self.current.timeout_ms, 6),
            "trace": [list(t) for t in self.trace],
        }


def discipline_trace(records: Sequence[dict]) -> list[tuple[int, float, float]]:
    """The epoch trace a journal records: (effective_step, k,
    timeout_ms) per completed change, in order (the projection of the
    log the reference's replay invariant and summaries read)."""
    out: list[tuple[int, float, float]] = []
    for rec in records:
        if (rec.get("event") == "discipline"
                and rec.get("action") == "complete"):
            try:
                out.append((int(rec["effective_step"]),
                            float(rec["k"]), float(rec["timeout_ms"])))
            except (KeyError, TypeError, ValueError):
                continue  # malformed completes are the invariant's job
    return out
