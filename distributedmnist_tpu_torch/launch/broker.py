"""Resource broker (≙ ``distributedmnist_tpu/launch/broker.py``, copied
whole; one change: :meth:`ResourceBroker._maybe_promote` compares the
parked pool's payload with the slot's as the port's cluster spawns it,
its ``--device`` appended): demand-driven autoscaling over one mixed
roster.

One device/process budget, two tenants. A publisher trainer (plus any
extra train workers) and a set of serving replicas share a single
:class:`~.cluster.LocalProcessCluster` roster — serving slots are the
worker ids carrying a ``worker_commands`` override, train slots run
the default payload. The :class:`ResourceBroker` owns that budget and
trades slots between the tenants on live demand:

* **pressure up** — the loadgen's rolling-window snapshot (p99,
  overloaded-reject rate, decode TTFT p99) or a replica heartbeat's
  pressure fields (admission-queue occupancy, KV block-pool
  exhaustion) crosses its high-water mark: the broker drains the
  highest train worker (never the publisher), reshapes the roster
  through :meth:`~.cluster.LocalProcessCluster.reconfigure`, and
  brings a new serving replica up in the freed slot — promoted from a
  warm standby when the parked pool runs the serving payload, cold
  spawned otherwise.
* **pressure down** — every present signal is back below its
  LOW-water mark (hysteresis: the band between low and high is dead,
  so a signal hovering near the threshold cannot flap the roster):
  the newest replica drains and a train worker grows back, resuming
  from the survivors' newest checkpoint via the reshape's seeding.

Decisions are paced by a cooldown measured from the last *completed*
change, and the split never leaves the configured
``[min,max]`` bounds for either tenant (:class:`~..core.config.
BrokerConfig`). The decision core (:func:`decide`) is a pure function
of (config, signal snapshot, last-change time, now) — deterministic,
property-testable without a process tree.

The broker runs ON the supervise thread as a
:meth:`~.supervisor.ClusterSupervisor.supervise_until_step` per-tick
callback (``on_tick=broker.tick``): a roster change it performs can
never race the supervisor's per-worker trackers, and a True return
resets them under the same discipline as the supervisor's own
reconfigures.

Every decision is journaled as an ``event: "autoscale"`` record
(declared in ``obsv/schema.py``): ``begin`` carries the trigger
signal, its observed value, and the threshold it crossed — the causal
license the replay invariant (``obsv/invariants.py`` "autoscale")
demands for every roster change in a brokered run; ``complete``
closes it with the detect→capacity-live reaction time.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Any

from ..core.config import BrokerConfig
from ..obsv.journal import tail_records
from ..servesvc.loadgen import read_latest_window

logger = logging.getLogger(__name__)

SCALE_UP = "scale_up_serving"
SCALE_DOWN = "scale_down_serving"

# signal -> (high-water cfg attr, op that means "pressure", low-water
# cfg attr, op that means "calm"). KV pressure is inverted: a LOW free
# fraction is the pressure signal.
_THRESHOLDS: tuple[tuple[str, str, str, str, str], ...] = (
    ("p99_ms", "p99_high_ms", ">=", "p99_low_ms", "<="),
    ("reject_rate", "reject_high", ">=", "reject_low", "<="),
    ("ttft_p99_ms", "ttft_high_ms", ">=", "ttft_low_ms", "<="),
    ("queue_frac", "queue_high", ">=", "queue_low", "<="),
    ("kv_free_frac", "kv_free_low", "<=", "kv_free_high", ">="),
)


def threshold_holds(value: float, op: str, threshold: float) -> bool:
    """The one comparison the journal's ``begin`` records license
    against — shared with the replay invariant so the two can never
    disagree about what "crossed" means."""
    return value >= threshold if op == ">=" else value <= threshold


def tail_heartbeat(logdir: str | Path,
                   tail_bytes: int = 1 << 15) -> dict | None:
    """The newest intact heartbeat record in a replica's
    ``train_log.jsonl`` — the per-replica pressure channel (queue
    occupancy, KV block-pool fill) the broker polls every tick. Reads
    only the file tail and scans backwards past torn lines, same
    discipline (obsv/journal.py ``tail_records``) as
    :func:`~..servesvc.loadgen.read_latest_window`."""
    for rec in tail_records(Path(logdir) / "train_log.jsonl",
                            tail_bytes=tail_bytes):
        if rec.get("event") == "heartbeat":
            return rec
    return None


def collect_signals(window: dict | None, heartbeats: list[dict],
                    train_steps_per_s: float | None = None,
                    now: float | None = None,
                    window_s: float = 10.0) -> dict[str, float]:
    """Fold the raw observations into the canonical signal snapshot
    :func:`decide` consumes. Pure.

    ``window``: the newest loadgen rolling-window record (or None) —
    contributes ``p99_ms`` / ``reject_rate`` / ``ttft_p99_ms``, but
    only while fresh (a snapshot older than two windows describes a
    load that may no longer exist). ``heartbeats``: one record per
    live serving replica — queue pressure aggregates as the MAX
    occupancy fraction (one saturated replica is a problem even if
    its peers idle), KV pressure as the MIN free fraction.
    ``train_steps_per_s`` rides along informationally (journals,
    bench detail); it is not a scaling trigger."""
    sig: dict[str, float] = {}
    if window is not None:
        t = window.get("time")
        fresh = (not isinstance(t, (int, float)) or now is None
                 or (now - t) <= max(2 * window_s, 5.0))
        if fresh:
            for name in ("p99_ms", "reject_rate", "ttft_p99_ms"):
                v = window.get(name)
                if isinstance(v, (int, float)):
                    sig[name] = float(v)
    queue_fracs: list[float] = []
    kv_fracs: list[float] = []
    for hb in heartbeats:
        if not isinstance(hb, dict):
            continue
        qd, ql = hb.get("queue_depth"), hb.get("queue_limit")
        if isinstance(qd, (int, float)) and isinstance(ql, (int, float)) \
                and ql > 0:
            queue_fracs.append(qd / ql)
        free, tot = hb.get("kv_blocks_free"), hb.get("kv_blocks_total")
        if isinstance(free, (int, float)) and isinstance(tot, (int, float)) \
                and tot > 0:
            kv_fracs.append(free / tot)
    if queue_fracs:
        sig["queue_frac"] = max(queue_fracs)
    if kv_fracs:
        sig["kv_free_frac"] = min(kv_fracs)
    if isinstance(train_steps_per_s, (int, float)):
        sig["train_steps_per_s"] = float(train_steps_per_s)
    return sig


@dataclasses.dataclass(frozen=True)
class Decision:
    """One roster change the decision core wants: what fires it
    (``trigger``/``value``/``threshold``/``op`` — exactly the license
    the journal's ``begin`` record carries) and the before/after
    tenant split it moves to."""
    decision: str
    trigger: str
    value: float
    threshold: float
    op: str
    old_serve: int
    new_serve: int
    old_train: int
    new_train: int


def decide(cfg: BrokerConfig, serve_n: int, train_n: int,
           signals: dict[str, float], last_change_t: float | None,
           now: float) -> Decision | None:
    """The pure decision core: deterministic in its arguments, no
    clock, no I/O — the property tests replay signal traces through
    this directly.

    Scale-up fires on the FIRST pressure signal (in the canonical
    :data:`_THRESHOLDS` order) at or past its high-water mark, and
    only with headroom on both sides of the trade (a serving slot
    available under ``max_serve_replicas``, a train worker to give up
    above ``min_train_workers``). Scale-down requires EVERY present
    signal calm below its low-water mark — the dead band between the
    marks is the hysteresis that keeps a hovering signal from
    flapping the roster — and a cooldown window after the last change
    suppresses everything."""
    if last_change_t is not None and (now - last_change_t) < cfg.cooldown_s:
        return None
    present = []
    for name, hi_attr, hi_op, lo_attr, lo_op in _THRESHOLDS:
        v = signals.get(name)
        if isinstance(v, (int, float)):
            present.append((name, float(v), float(getattr(cfg, hi_attr)),
                            hi_op, float(getattr(cfg, lo_attr)), lo_op))
    if not present:
        return None
    for name, v, hi, hi_op, lo, lo_op in present:
        if threshold_holds(v, hi_op, hi):
            if (serve_n >= cfg.max_serve_replicas
                    or train_n <= cfg.min_train_workers):
                return None  # pressure, but the trade has no headroom
            return Decision(SCALE_UP, name, round(v, 6), hi, hi_op,
                            serve_n, serve_n + 1, train_n, train_n - 1)
    if serve_n > cfg.min_serve_replicas and all(
            threshold_holds(v, lo_op, lo)
            for _, v, _, _, lo, lo_op in present):
        name, v, _, _, lo, lo_op = present[0]
        grow = train_n < cfg.max_train_workers
        return Decision(SCALE_DOWN, name, round(v, 6), lo, lo_op,
                        serve_n, serve_n - 1, train_n,
                        train_n + (1 if grow else 0))
    return None


class ResourceBroker:
    """Executes :func:`decide`'s roster changes through the backend's
    existing verbs, journaling every move. Construct over a running
    :class:`~.supervisor.ClusterSupervisor` and pass :meth:`tick` as
    ``supervise_until_step(..., on_tick=broker.tick)``."""

    def __init__(self, supervisor: Any, cfg: BrokerConfig | None = None,
                 serve_command: str = "",
                 loadgen_journal: str | Path | None = None,
                 warm_standbys: int = 0):
        if not serve_command:
            raise ValueError("ResourceBroker needs the serve_command a "
                             "scaled-up replica slot will run")
        self.sup = supervisor
        self.backend = supervisor.backend
        self.cfg = cfg or BrokerConfig()
        self.cfg.validate()
        self.serve_command = serve_command
        self.loadgen_journal = (Path(loadgen_journal)
                                if loadgen_journal is not None else None)
        self.warm_standbys = warm_standbys
        self.fired = 0
        self.decisions: list[dict[str, Any]] = []
        self._last_change_t: float | None = None
        self._pending: dict[str, Any] | None = None
        self._train_prog: tuple[float, int] | None = None
        self._started = False

    # -- journaling ------------------------------------------------------

    def _autoscale_event(self, action: str, **fields: Any) -> None:
        self.sup._record({"event": "autoscale", "layer": "broker",
                          "action": action, "time": time.time(), **fields})

    # -- roster/signal observation ----------------------------------------

    def _roles(self, workers: list[dict]) -> tuple[list[int], list[int]]:
        """(serving ids, train ids): a slot is SERVING iff its
        ``worker_commands`` override IS the serving payload — the
        broker itself maintains that mapping as it trades slots, so
        the roster's role split is always derivable from config +
        state, never cached. Command EQUALITY (not mere override
        presence) keeps a train worker with its own overridden payload
        (a donor trainer paced differently from the publisher) on the
        train side of the trade."""
        cmds = getattr(self.backend.cfg, "worker_commands", None) or {}
        serve = sorted(w["worker"] for w in workers
                       if cmds.get(str(w["worker"])) == self.serve_command)
        train = sorted(w["worker"] for w in workers
                       if cmds.get(str(w["worker"])) != self.serve_command)
        return serve, train

    def _train_rate(self, train_ids: list[int],
                    progress: dict[int, int] | None,
                    now: float) -> float | None:
        if not progress:
            return None
        steps = [progress.get(k, -1) for k in train_ids]
        steps = [s for s in steps if s >= 0]
        if not steps:
            return None
        s = max(steps)
        prev = self._train_prog
        self._train_prog = (now, s)
        if prev is None or now <= prev[0]:
            return None
        return max(0.0, (s - prev[1]) / (now - prev[0]))

    def read_signals(self, workers: list[dict],
                     progress: dict[int, int] | None,
                     now: float) -> dict[str, float]:
        window = (read_latest_window(self.loadgen_journal)
                  if self.loadgen_journal is not None else None)
        serve_ids, train_ids = self._roles(workers)
        by_id = {w["worker"]: w for w in workers}
        heartbeats = [hb for hb in
                      (tail_heartbeat(by_id[k]["logdir"])
                       for k in serve_ids if by_id[k].get("logdir"))
                      if hb is not None]
        rate = self._train_rate(train_ids, progress, now)
        return collect_signals(window, heartbeats, rate, now=now,
                               window_s=self.cfg.window_s)

    # -- the per-tick entry point -----------------------------------------

    def start(self) -> None:
        """One-time setup: provision the warm-standby pool when asked.
        Best-effort — the pool is an optimization, cold spawns are the
        always-correct fallback."""
        if self._started:
            return
        self._started = True
        if self.warm_standbys > 0 and hasattr(self.backend,
                                              "ensure_standbys"):
            try:
                self.backend.ensure_standbys(self.warm_standbys)
            except Exception as e:
                logger.warning("broker could not provision %d standbys "
                               "(%s: %s) — scaling will cold-spawn",
                               self.warm_standbys, type(e).__name__, e)

    def tick(self, got: dict | None = None) -> bool:
        """One supervise-loop tick: settle any in-flight change first
        (its capacity going live is what closes the journal entry and
        starts the cooldown), otherwise observe → decide → execute.
        Returns True iff the roster changed this tick."""
        self.start()
        now = time.time()
        got = got or {}
        workers = got.get("workers")
        if workers is None:
            workers = (self.backend.status() or {}).get("workers", [])
        if self._pending is not None:
            self._settle(workers, now)
            return False
        serve_ids, train_ids = self._roles(workers)
        signals = self.read_signals(workers, got.get("worker_progress"),
                                    now)
        d = decide(self.cfg, len(serve_ids), len(train_ids), signals,
                   self._last_change_t, now)
        if d is None:
            return False
        return self.execute(d, serve_ids, train_ids, now)

    # -- execution ---------------------------------------------------------

    def execute(self, d: Decision, serve_ids: list[int],
                train_ids: list[int], now: float) -> bool:
        """Perform one decided trade. Scale-up: drain the highest train
        worker (the publisher, worker 0, is protected by the decision
        core's ``min_train_workers >= 1`` bound), reshape the roster to
        drop it and grow a fresh slot (checkpoint-seeded by the
        backend), register the serving payload for that slot, and
        bring it up — warm standby if the parked pool runs the serving
        payload, cold spawn otherwise. Scale-down mirrors it: drain
        the newest replica, reshape, grow a train worker back (which
        resumes from the seeded checkpoint) while under
        ``max_train_workers``."""
        self._autoscale_event(
            "begin", decision=d.decision, trigger=d.trigger, value=d.value,
            threshold=d.threshold, op=d.op, old_serve=d.old_serve,
            new_serve=d.new_serve, old_train=d.old_train,
            new_train=d.new_train, window_s=self.cfg.window_s,
            cooldown_s=self.cfg.cooldown_s)
        self._last_change_t = now
        backend = self.backend
        try:
            if d.decision == SCALE_UP:
                victim = max(train_ids)
                survivors = sorted(set(serve_ids)
                                   | (set(train_ids) - {victim}))
                self._drain(victim)
                rec = backend.reconfigure(len(survivors) + 1,
                                          survivors=survivors)
                new_id = [k for k in rec["workers"]
                          if k not in survivors][0]
                # promotion must precede the command registration:
                # promote_standby refuses overridden slots (role-swap
                # protection), and here the role swap is exactly the
                # point — guarded by _maybe_promote's pool-payload check
                promoted = self._maybe_promote(new_id, self.serve_command)
                self._set_serve_command(new_id)
                if not promoted:
                    backend.restart_worker(new_id)
                self._pending = {"decision": d, "t0": now,
                                 "worker": new_id, "role": "serve",
                                 "dropped": victim}
            else:
                victim = max(serve_ids)
                survivors = sorted((set(serve_ids) - {victim})
                                   | set(train_ids))
                grow = d.new_train > d.old_train
                self._drain(victim)
                rec = backend.reconfigure(
                    len(survivors) + (1 if grow else 0),
                    survivors=survivors)
                self._clear_serve_command(victim)
                new_id = None
                if grow:
                    new_id = [k for k in rec["workers"]
                              if k not in survivors][0]
                    promoted = self._maybe_promote(
                        new_id,
                        getattr(backend.cfg, "train_command", ""))
                    if not promoted:
                        backend.restart_worker(new_id)
                self._pending = {"decision": d, "t0": now,
                                 "worker": new_id, "role": "train",
                                 "dropped": victim}
        except Exception as e:
            logger.exception("autoscale %s failed", d.decision)
            self._autoscale_event("error", decision=d.decision,
                                  error=f"{type(e).__name__}: {e}")
            self._pending = None
            # the reshape may have landed before the failure: report a
            # roster change so the supervisor resets its trackers
            return True
        return True

    def _drain(self, victim: int) -> None:
        """Graceful SIGTERM to the victim's process group, bounded wait
        for exit — a trainer flushes its preemption checkpoint, a
        replica finishes in-flight requests. Stragglers are killed by
        the reshape that follows."""
        backend = self.backend
        if not hasattr(backend, "stop_all"):
            return
        backend.stop_all(worker=str(victim))
        drain_s = min(float(getattr(self.sup.cfg, "reconfigure_drain_s",
                                    10.0)), 10.0)
        deadline = time.monotonic() + drain_s
        while time.monotonic() < deadline:
            st = backend.status() or {}
            sel = [w for w in st.get("workers", [])
                   if w.get("worker") == victim]
            if not sel or not sel[0].get("alive"):
                return
            time.sleep(0.2)

    def _maybe_promote(self, k: int, role_command: str) -> bool:
        """Promote a warm standby into slot ``k`` — but only when the
        parked pool runs ``role_command``, the payload this slot needs.
        A pool parked on the wrong payload (train spares for a serving
        slot, or vice versa) silently swapping the role is exactly the
        failure promote_standby's own guard exists for; this is the
        broker-side mirror of that check for the slots it deliberately
        re-roles."""
        backend = self.backend
        if not role_command or not hasattr(backend, "promote_standby"):
            return False
        resolved = getattr(backend.cfg, "resolved_standby_command", None)
        pool_cmd = resolved() if callable(resolved) else ""
        # the port's cluster appends its device to every port-verb
        # payload it spawns (LocalClusterConfig.with_device), the parked
        # pool's included: compare the pool with the slot's payload as
        # it would be spawned, or a --device cpu roster never promotes
        with_device = getattr(backend.cfg, "with_device", None)
        if callable(with_device):
            role_command = with_device(role_command)
        if pool_cmd != role_command:
            return False
        try:
            return bool(backend.promote_standby(k))
        except Exception as e:
            logger.warning("standby promotion for worker %s failed "
                           "(%s: %s) — cold spawning", k,
                           type(e).__name__, e)
            return False

    def _set_serve_command(self, k: int) -> None:
        cfg = self.backend.cfg
        cmds = dict(getattr(cfg, "worker_commands", None) or {})
        cmds[str(k)] = self.serve_command
        self.backend.cfg = dataclasses.replace(cfg, worker_commands=cmds)

    def _clear_serve_command(self, k: int) -> None:
        cfg = self.backend.cfg
        cmds = dict(getattr(cfg, "worker_commands", None) or {})
        if cmds.pop(str(k), None) is not None:
            self.backend.cfg = dataclasses.replace(cfg,
                                                   worker_commands=cmds)

    # -- settlement ---------------------------------------------------------

    def _serve_live_at(self, k: int, workers: list[dict],
                       t0: float) -> float | None:
        """When the new replica's capacity went LIVE: its ``serve.json``
        endpoint card landing (written at bind) or its first heartbeat,
        whichever evidence appears. The grown slot's logdir is fresh,
        so any card there postdates the decision."""
        w = next((w for w in workers if w.get("worker") == k), None)
        if w is None or not w.get("logdir"):
            return None
        card = Path(w["logdir"]) / "serve.json"
        try:
            m = card.stat().st_mtime
            if m >= t0 - 1.0:
                return m
        except OSError:
            pass
        hb = tail_heartbeat(w["logdir"])
        if (hb is not None and isinstance(hb.get("time"), (int, float))
                and hb["time"] >= t0):
            return float(hb["time"])
        return None

    def _train_live_at(self, k: int, workers: list[dict],
                       t0: float) -> float | None:
        w = next((w for w in workers if w.get("worker") == k), None)
        if w is None:
            return None
        if not w.get("logdir"):
            return time.time() if w.get("alive") else None
        log = Path(w["logdir"]) / "train_log.jsonl"
        try:
            m = log.stat().st_mtime
            return m if m >= t0 - 1.0 else None
        except OSError:
            return None

    def _settle(self, workers: list[dict], now: float) -> None:
        """Close the in-flight change: journal ``complete`` with the
        detect→capacity-live reaction time once the new capacity shows
        evidence of life (or the pure shrink's victim left the
        roster), ``error`` past the settle timeout. The cooldown
        restarts from settlement — back-to-back trades cannot overlap."""
        p = self._pending
        assert p is not None
        d: Decision = p["decision"]
        if p["role"] == "serve":
            live_at = self._serve_live_at(p["worker"], workers, p["t0"])
        elif p["worker"] is None:
            # pure shrink: the reshape already removed the victim — the
            # budget change is live as soon as we observe the roster
            live_at = now
        else:
            live_at = self._train_live_at(p["worker"], workers, p["t0"])
        if live_at is not None:
            serve_ids, train_ids = self._roles(workers)
            fields: dict[str, Any] = {
                "decision": d.decision, "trigger": d.trigger,
                "reaction_s": round(max(0.0, live_at - p["t0"]), 3),
                "serve": len(serve_ids), "train": len(train_ids),
                "dropped": p["dropped"]}
            if p["worker"] is not None:
                fields["worker"] = p["worker"]
            self._autoscale_event("complete", **fields)
            self.decisions.append({**fields, "t": now})
            self.fired += 1
            self._pending = None
            self._last_change_t = now
        elif now - p["t0"] > self.cfg.settle_timeout_s:
            self._autoscale_event(
                "error", decision=d.decision,
                error=f"settle timeout: worker {p['worker']} showed no "
                      f"life within {self.cfg.settle_timeout_s}s")
            self._pending = None

    # -- reporting ----------------------------------------------------------

    def summary(self) -> dict[str, Any]:
        """The run's autoscale summary (decision mix, reaction-time
        percentiles, flap count) from the supervisor's own event
        stream — what the chaos trial record and bench detail embed."""
        from ..obsv.journal import summarize_autoscale
        recs = [r for r in self.sup.events
                if r.get("event") == "autoscale"]
        got = summarize_autoscale(recs)
        got["fired"] = self.fired
        return got
