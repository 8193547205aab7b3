"""Self-healing cluster supervisor (≙ ``distributedmnist_tpu/launch/
supervisor.py``, copied whole): fault *injection* → fault *recovery*.

The cluster engine's fault plan kills, hangs or corrupts a worker
mid-run, and the fail-fast driver :func:`~.cluster.wait_until_step`
raises the moment every worker is gone. The source paper's regime
(arXiv:1604.00981 backup workers) and the systems it grew into
(TF-Replicator, arXiv:1902.00465; TensorFlow, arXiv:1605.08695) treat
replica loss as a *runtime event to recover from*, not a terminal
condition. This module is that layer:

* **Liveness tracking** — per-worker alive/dead from ``status()`` on
  every poll tick, plus per-worker log *progress* (``worker_progress``)
  so a hung worker (SIGSTOP, wedged I/O — alive to ``kill -0``, silent
  in its log) is detected by stall timeout, the failure liveness probes
  structurally cannot see.
* **Automatic restart** — a dead or hung worker is restarted through
  ``backend.restart_worker`` under a bounded per-worker budget with
  exponential backoff (a worker that dies on boot must not be respawned
  in a hot loop). The restarted process resumes from its latest
  *loadable* checkpoint — the worker's own Trainer handles
  corrupt-latest fallback (train/checkpoint.py), so a checkpoint torn
  at the worst moment costs one checkpoint interval, not the run.
* **Degraded-quorum continuation** — the run stays up while
  ``workers_alive >= quorum`` (the cluster-level analogue of the
  k-of-n aggregation masks in ``parallel/policies.py``): a worker whose
  restart budget is exhausted degrades the cluster instead of killing
  the run; only dropping below quorum — with nothing left to restart —
  raises.
* **Structured recovery events** — every transition (detect → restart →
  resume, quorum changes, budget exhaustion) is journaled as an
  ``event: "recovery"`` record in the same command journal the executor
  writes, so ``obsv.journal.summarize_recovery`` reconstructs the whole
  episode from the artifact alone.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any

from ..core.log import get_logger
from .cluster import (ClusterBackend, ClusterError,
                      worker_resumed_step_since_spawn)

logger = get_logger("supervisor")


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    """Recovery policy knobs (JSON-loadable, like the cluster configs).

    ``quorum``: minimum live workers for the run to be considered
    healthy enough to continue — the all-or-nothing fail-fast of plain
    ``wait_until_step`` is ``quorum == num_workers`` with
    ``max_restarts_per_worker == 0``.
    """

    quorum: int = 1
    max_restarts_per_worker: int = 3
    restart_backoff_s: float = 0.5
    restart_backoff_mult: float = 2.0
    max_restart_backoff_s: float = 30.0
    # 0 disables hang detection; otherwise a worker whose log makes no
    # progress for this long (while the pid stays alive) is killed and
    # restarted under the same budget
    stall_timeout_s: float = 0.0
    # Warm standbys: keep N pre-booted spare processes
    # parked (imported torch, trainer built, train step precompiled) on
    # backends that support them; a due restart PROMOTES a ready spare
    # — handing it the dead worker's logdir to resume from — instead of
    # cold-starting, and the pool back-fills asynchronously. Promotions
    # ride the same per-worker restart budget (journaled as
    # ``action: "restart", via: "standby"``). 0 = off.
    standby_workers: int = 0
    # The run's schedule seed (chaos campaigns / `--seed`): stamped on
    # every recovery event so a journaled episode is replayable from
    # the artifact alone — the seed regenerates the fault schedule and
    # the jitter sequence that produced it. None = unseeded run.
    seed: int | None = None
    # -- elastic world-size reconfiguration ----------
    # Below quorum with every restart budget exhausted, an elastic run
    # RESHAPES instead of aborting: survivors are drained (SIGTERM →
    # checkpoint flush), the backend roster shrinks to them, quorum
    # rescales (see rescaled_quorum), and the run relaunches as the
    # smaller world resuming from the last loadable step. Off by
    # default — aborting is the safe answer when nobody opted in.
    elastic: bool = False
    # smallest world an elastic shrink may produce; fewer survivors
    # than this aborts exactly as a non-elastic run would
    min_workers: int = 1
    # bound on reconfigures per supervised run (a crash-looping world
    # must not shrink one worker at a time forever)
    max_reconfigures: int = 2
    # how long a graceful drain (SIGTERM → flush → exit) may take
    # before stragglers are killed outright
    reconfigure_drain_s: float = 30.0

    def __post_init__(self) -> None:
        if self.quorum < 1:
            raise ClusterError(f"quorum must be >= 1, got {self.quorum}")
        if self.max_restarts_per_worker < 0:
            raise ClusterError("max_restarts_per_worker must be >= 0")
        if self.min_workers < 1:
            raise ClusterError(f"min_workers must be >= 1, "
                               f"got {self.min_workers}")

    def rescaled_quorum(self, new_world: int) -> int:
        """The effective quorum for a resized world, clamped into
        ``[1, new_world]``: a 3→2 shrink with quorum=3 must not abort
        the instant it relaunches (the quorum was specified against
        the OLD world). Journaled on every reconfigure so the policy
        actually applied is artifact-visible; re-specify explicitly by
        supervising the resized cluster with a fresh config if a
        different policy is wanted."""
        return max(1, min(self.quorum, new_world))

    @classmethod
    def from_file(cls, path: str | Path) -> "SupervisorConfig":
        d = json.loads(Path(path).read_text())
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ClusterError(
                f"unknown supervisor config keys: {sorted(unknown)}")
        return cls(**d)

    def backoff_s(self, restarts_so_far: int) -> float:
        return min(self.max_restart_backoff_s,
                   self.restart_backoff_s
                   * self.restart_backoff_mult ** restarts_so_far)


class ClusterSupervisor:
    """Wraps any :class:`~.cluster.ClusterBackend` and keeps its run
    alive through worker loss, hangs, and checkpoint corruption."""

    def __init__(self, backend: ClusterBackend,
                 cfg: SupervisorConfig | None = None):
        self.backend = backend
        self.cfg = cfg or SupervisorConfig()
        self.events: list[dict[str, Any]] = []
        self._restarts: dict[int, int] = {}
        # open recovery episodes: restarted workers whose own log has
        # not moved yet, plus the MTTR anchors (wall clock, matching
        # event "time" stamps) their eventual resume closes with.
        # Instance state, not supervise-locals: a run that reaches its
        # target while a restarted worker is still mid-boot leaves
        # the episode OPEN, and the caller (the chaos drain — exactly
        # the window where that worker finishes booting) closes it via
        # close_episode so its MTTR is still journaled.
        self._watch_resume: set[int] = set()
        self._detect_t: dict[int, float] = {}
        self._respawn_t: dict[int, float] = {}
        # open world-reshape transition: set by reconfigure(), closed
        # (with the drain→first-moved-step latency) when a relaunched
        # worker's OWN first step record lands — the MTTR analogue for
        # a world change. Survives into supervise_until_step so a
        # manual reconfigure-then-supervise flow still closes it.
        self._reconf_open: dict[str, Any] | None = None
        self.reconfigures = 0

    # -- event plumbing -------------------------------------------------

    def _record(self, rec: dict[str, Any]) -> None:
        if self.cfg.seed is not None:
            rec.setdefault("seed", self.cfg.seed)
        self.events.append(rec)
        ex = getattr(self.backend, "exec", None)
        if ex is not None and hasattr(ex, "journal"):
            ex.journal(rec)

    def _event(self, action: str, **fields: Any) -> None:
        logger.info("recovery: %s %s", action,
                    {k: v for k, v in fields.items() if k != "time"})
        self._record({"event": "recovery", "layer": "supervisor",
                      "action": action, "time": time.time(), **fields})

    def _reconf_event(self, action: str, **fields: Any) -> None:
        """World-reshape transitions get their OWN journal event type
        (``event: "reconfigure"``) — the causal license the chaos
        cross-world resume invariant requires: a run whose world
        changed without one of these fails replay."""
        logger.info("reconfigure: %s %s", action,
                    {k: v for k, v in fields.items() if k != "time"})
        self._record({"event": "reconfigure", "layer": "supervisor",
                      "action": action, "time": time.time(), **fields})

    def _mttr_fields(self, k: int, at: float | None = None
                     ) -> dict[str, Any]:
        """The detect→respawned→first-moved-step latencies a resume
        event closes its recovery episode with — MTTR as a first-class
        journal fact (obsv.journal.summarize_recovery_events computes
        the percentiles). ``at`` is when the first moved step actually
        HAPPENED where the caller knows it (the step record's own
        timestamp) — observation time is quantized to the poll cadence
        and would overstate short episodes by up to a whole tick."""
        out: dict[str, Any] = {}
        now = time.time() if at is None else at
        if k in self._detect_t:
            out["detected_at"] = self._detect_t[k]
            out["mttr_s"] = round(now - self._detect_t[k], 3)
        if k in self._respawn_t:
            out["respawned_at"] = self._respawn_t[k]
            out["resume_after_respawn_s"] = round(
                now - self._respawn_t[k], 3)
        return out

    @property
    def open_episodes(self) -> set[int]:
        """Workers restarted during the last supervised run whose own
        log has not been seen moving yet — episodes without a closing
        ``resume`` event. Non-empty after a run that completed while a
        restart was still booting; the caller closes them from its own
        post-run observation window (:meth:`close_episode`)."""
        return set(self._watch_resume)

    def close_episode(self, k: int, step: int | None = None,
                      at: float | None = None) -> None:
        """Journal the ``resume`` that closes worker ``k``'s open
        recovery episode — called by whoever observes the restarted
        worker's first log movement AFTER the supervised loop returned
        (the chaos drain). ``at``: the first moved step's own wall
        timestamp when the caller holds the record (else observation
        time). No-op for workers without an open episode, so callers
        can sweep unconditionally."""
        if k in self._watch_resume:
            self._watch_resume.discard(k)
            self._event("resume", worker=k, step=step,
                        **self._mttr_fields(k, at))

    def summary(self) -> dict[str, Any]:
        """Aggregate this run's recovery episode — the SAME aggregation
        ``obsv.journal.summarize_recovery`` applies to the journal,
        over the in-memory events, plus the live restart counters and
        any world-reshape transitions."""
        from ..obsv.journal import (summarize_reconfigure_events,
                                    summarize_recovery_events)
        recovery = [e for e in self.events
                    if e.get("event", "recovery") == "recovery"]
        out = {**summarize_recovery_events(recovery),
               "restarts_by_worker": dict(self._restarts)}
        reconf = [e for e in self.events
                  if e.get("event") == "reconfigure"]
        if reconf:
            out["reconfigure"] = summarize_reconfigure_events(reconf)
        return out

    # -- elastic world-size reconfiguration ------------

    def _can_reconfigure(self) -> bool:
        """Whether the backend actually OVERRIDES the elastic verb.
        ``hasattr`` is useless here — the base class defines
        ``reconfigure`` (raising NotImplementedError), and discovering
        that AFTER draining the survivors would turn a clean
        below-quorum abort into a dead cluster with no journal."""
        fn = getattr(type(self.backend), "reconfigure", None)
        return (callable(fn)
                and fn is not ClusterBackend.reconfigure)

    def reconfigure(self, new_num_workers: int, trigger: str = "manual",
                    survivors: list[int] | None = None,
                    poll_secs: float = 0.5) -> dict[str, Any]:
        """Drain → reshape → relaunch: the cluster resizes itself
        instead of aborting (the TF-Replicator ending of the source
        paper's backup-workers story).

        1. **Drain**: live workers get SIGTERM (``stop_all``) — a
           preemption-aware trainer finishes its step, flushes a
           checkpoint, and exits resumable; stragglers past
           ``cfg.reconfigure_drain_s`` are killed (their latest cadence
           save is the resume point).
        2. **Reshape**: ``backend.reconfigure`` keeps the survivors
           (shrink prefers LIVE workers when none are named) or grows
           fresh seeded workers; quorum rescales per
           ``cfg.rescaled_quorum`` and the effective value is
           journaled.
        3. **Relaunch**: grown slots promote a ready warm standby when
           the backend has one; everything else respawns cold. Each
           worker's own resume-from-checkpoint logic — the
           mesh-portable ``restore_for_topology`` path — decides where
           it continues.

        Every transition is journaled as ``event: "reconfigure"``
        (begin → relaunched → resume) with old/new world, trigger, and
        the MTTR-style drain→first-moved-step latency closed by the
        supervise loop (or :meth:`close_reconfigure`)."""
        backend = self.backend
        st = backend.status() or {"workers": []}
        roster = st.get("workers", [])
        old_world = len(roster)
        if survivors is None:
            if new_num_workers >= old_world:
                survivors = [w["worker"] for w in roster]  # grow: keep all
            else:
                # shrink: prefer live workers, then lowest ids
                alive_ids = sorted(w["worker"] for w in roster
                                   if w.get("alive"))
                dead_ids = sorted(w["worker"] for w in roster
                                  if not w.get("alive"))
                survivors = sorted(
                    (alive_ids + dead_ids)[:new_num_workers])
        t0 = time.time()
        new_q = self.cfg.rescaled_quorum(new_num_workers)
        # open recovery episodes are SUPERSEDED by the world reshape:
        # the drain/relaunch below replaces any in-flight restart, so
        # no per-worker resume will ever close them — journal the
        # supersede so summarize_mttr files them as neither recovered
        # nor unrecovered (the transition's own reconfigure_s carries
        # the latency evidence from here on)
        for k in sorted(self._watch_resume):
            self._event("episode_superseded", worker=k,
                        by="reconfigure", trigger=trigger)
        self._watch_resume.clear()
        self._detect_t.clear()
        self._respawn_t.clear()
        self._reconf_event("begin", old_world=old_world,
                           new_world=new_num_workers, trigger=trigger,
                           quorum=self.cfg.quorum, effective_quorum=new_q,
                           survivors=sorted(survivors))
        # (1) graceful drain, bounded. The wait must cover the whole
        # process GROUP where the backend can tell (wait_drained): the
        # recorded pid is a shell leader that dies to the group SIGTERM
        # instantly while the trainer behind it is still flushing its
        # preemption checkpoint — a status()-only wait would SIGKILL
        # that flush mid-write and lose the resume point.
        if hasattr(backend, "stop_all"):
            backend.stop_all()
            if hasattr(backend, "wait_drained"):
                backend.wait_drained(self.cfg.reconfigure_drain_s,
                                     poll_secs)
            else:
                deadline = time.monotonic() + self.cfg.reconfigure_drain_s
                while time.monotonic() < deadline:
                    st2 = backend.status()
                    if st2 is None or not any(w.get("alive")
                                              for w in st2["workers"]):
                        break
                    time.sleep(poll_secs)
        # straggler kill is PER WORKER: kill_all("all") also reaps
        # parked standbys, and the warm grow path below needs them
        # alive to promote
        if roster:
            for w in roster:
                backend.kill_all(worker=str(w["worker"]))
        else:
            backend.kill_all()
        # (2) reshape + quorum rescale
        rec = backend.reconfigure(new_num_workers, survivors=survivors)
        if new_q != self.cfg.quorum:
            self.cfg = dataclasses.replace(self.cfg, quorum=new_q)
        # (3) relaunch — standbys first for GROWN slots (the warm grow
        # path: a parked, precompiled spare adopts the seeded logdir)
        grown = {int(k) for k in (rec.get("grown") or {})}
        via: dict[int, str] = {}
        for k in rec.get("workers", []):
            promoted = False
            if k in grown and hasattr(backend, "promote_standby"):
                try:
                    promoted = bool(backend.promote_standby(k))
                except Exception as e:
                    if not isinstance(e, NotImplementedError):
                        logger.warning(
                            "standby promotion for grown worker %d "
                            "failed (%s: %s) — cold spawn", k,
                            type(e).__name__, e)
                    promoted = False
            if not promoted:
                backend.restart_worker(k)
            via[k] = "standby" if promoted else "respawn"
        drain_s = round(time.time() - t0, 3)
        self._reconf_event("relaunched", old_world=old_world,
                           new_world=new_num_workers, trigger=trigger,
                           drain_s=drain_s, workers=sorted(via),
                           via={str(k): v for k, v in via.items()},
                           grown=sorted(grown))
        self.reconfigures += 1
        self._reconf_open = {"t0": t0, "old_world": old_world,
                             "new_world": new_num_workers,
                             "trigger": trigger, "workers": set(via)}
        return rec

    def close_reconfigure(self, k: int, step: int | None = None,
                          at: float | None = None) -> None:
        """Journal the ``resume`` closing the open reconfigure
        transition: the FIRST relaunched worker whose own step record
        lands defines the drain→first-moved-step latency (the world
        change is over once the resized world trains). No-op without
        an open transition."""
        ro = self._reconf_open
        if not ro or k not in ro["workers"]:
            return
        now = time.time() if at is None else at
        self._reconf_open = None
        self._reconf_event("resume", worker=k, step=step,
                           old_world=ro["old_world"],
                           new_world=ro["new_world"],
                           trigger=ro["trigger"],
                           reconfigure_s=round(now - ro["t0"], 3))

    # -- the supervised run ---------------------------------------------

    def run_until_step(self, target: int, poll_secs: float = 1.0,
                       timeout_secs: float = 24 * 3600.0,
                       target_worker: int | None = None,
                       on_tick: Any = None) -> dict[str, Any]:
        """Launch training and supervise it to ``target`` steps; the
        cluster is stopped on EVERY exit path (success, below-quorum
        failure, timeout, Ctrl-C)."""
        self.backend.run_train()
        try:
            return self.supervise_until_step(target, poll_secs, timeout_secs,
                                             target_worker=target_worker,
                                             on_tick=on_tick)
        finally:
            self.backend.kill_all()

    def supervise_until_step(self, target: int, poll_secs: float = 1.0,
                             timeout_secs: float = 24 * 3600.0,
                             target_worker: int | None = None,
                             on_tick: Any = None) -> dict[str, Any]:
        """Supervise the running cluster until ``target`` progress.

        ``target_worker``: count progress toward the target from ONE
        worker's log only (liveness/stall/restart still cover every
        worker). What a mixed-payload cluster needs — a serving
        topology's replicas heartbeat their request counts into the
        same progress channel, and the run is over when the
        PUBLISHER's train step hits the target, not when some busy
        replica has served ``target`` requests. None = the fastest
        worker (the historical behavior).

        ``on_tick``: an optional ``callable(poll_dict) -> bool`` run
        once per poll tick, after the target check and before failure
        detection — the seam the resource broker (launch/broker.py)
        plugs into. It runs ON the supervise thread, so a roster change
        it performs cannot race this loop's per-worker trackers; a
        True return declares the roster changed and resets them (the
        same discipline as this loop's own reconfigures)."""
        cfg = self.cfg
        deadline = time.monotonic() + timeout_secs
        pending_restart: dict[int, float] = {}  # worker -> due monotonic
        exhausted: set[int] = set()
        last_alive: int | None = None
        # hang detection state: last observed step + when it changed
        last_progress: dict[int, int] = {}
        last_progress_t: dict[int, float] = {}
        # fresh episode state per supervised run (instance-level so a
        # post-run caller can close episodes the run left open);
        # _reconf_open deliberately survives — a manual reconfigure
        # followed by supervise still closes its transition here
        self._watch_resume = set()
        self._detect_t = {}
        self._respawn_t = {}
        watch_resume = self._watch_resume

        # the elastic resize fault (FaultPlan.resize_world_at_step):
        # cluster-level, so the SUPERVISOR executes it — the backend's
        # poll hook only sees single workers
        resize: tuple[int, int] | None = None
        ex = getattr(self.backend, "exec", None)
        if ex is not None and getattr(ex, "fault_plan", None) is not None:
            resize = ex.fault_plan.resize_world_at_step
        resize_fired = False

        def reset_roster_state() -> None:
            """After a reconfigure the roster changed under the loop:
            every per-worker tracker restarts from the relaunched
            world's own observations (a survivor's pre-drain log tail
            must not read as progress, a dropped worker's exhausted
            budget must not linger)."""
            nonlocal last_alive
            pending_restart.clear()
            exhausted.clear()
            last_progress.clear()
            last_progress_t.clear()
            watch_resume.clear()
            last_alive = None

        if (cfg.standby_workers > 0
                and hasattr(self.backend, "ensure_standbys")):
            # async: the spares boot + precompile in the background
            # while the run proceeds; only READY spares get promoted.
            # The pool is an OPTIMIZATION — a spawn failure (fork
            # pressure under a chaos campaign, exhausted fds) must
            # degrade to standby-less cold restarts, never abort the
            # run the standbys exist to protect.
            try:
                self.backend.ensure_standbys(cfg.standby_workers)
                self._event("standbys_requested",
                            count=cfg.standby_workers)
            except Exception as e:
                logger.warning("could not provision standbys (%s: %s) — "
                               "continuing without the warm pool",
                               type(e).__name__, e)
                self._event("standbys_unavailable",
                            error=f"{type(e).__name__}: {e}")

        def schedule_restart(k: int, now: float) -> None:
            """Shared dead/hung bookkeeping: a worker entering recovery
            is no longer awaiting resume; within budget it gets a
            backed-off restart slot, past it the cluster degrades."""
            watch_resume.discard(k)
            n_prior = self._restarts.get(k, 0)
            if n_prior >= cfg.max_restarts_per_worker:
                exhausted.add(k)
                self._event("restart_budget_exhausted", worker=k,
                            restarts=n_prior)
            else:
                backoff = cfg.backoff_s(n_prior)
                pending_restart[k] = now + backoff
                self._event("restart_scheduled", worker=k,
                            attempt=n_prior + 1, backoff_s=backoff)

        can_progress = hasattr(self.backend, "worker_progress")
        while True:
            got = self.backend.poll()
            if got is None:  # dry-run backend: argvs recorded, nothing to do
                return {"step": target, "record": None, "dry_run": True}
            # target progress = the FASTEST worker's log when the backend
            # can report per-worker progress (poll tails only worker 0 —
            # a degraded run whose permanently-lost worker IS worker 0
            # must still be able to finish on the survivors); reuse the
            # sweep poll() already ran for its fault triggers when it
            # attached one
            progress = got.get("worker_progress")
            if progress is None and can_progress:
                progress = self.backend.worker_progress()
            now = time.monotonic()
            # ---- per-worker log movement: resume attribution ----------
            # BEFORE the target check: an episode whose restarted
            # worker's log moves on the very tick the run completes
            # must still get its closing resume (and MTTR) journaled
            moved: set[int] = set()
            if progress is not None:
                for k, step_k in progress.items():
                    if step_k != last_progress.get(k):
                        last_progress[k] = step_k
                        last_progress_t[k] = now
                        moved.add(k)
                        if k in watch_resume and step_k >= 0:
                            # the restarted worker's own log moved: THIS
                            # step (not worker 0's) is where it resumed
                            self.close_episode(k, step_k)
            # ---- open reconfigure transition: first-moved-step -------
            if self._reconf_open is not None:
                snapshot = got.get("workers") or []
                closed_by_log = False
                for w in snapshot:
                    if (w.get("worker") in self._reconf_open["workers"]
                            and w.get("logdir")):
                        closed_by_log = True
                        r = worker_resumed_step_since_spawn(w)
                        if r is not None:
                            self.close_reconfigure(w["worker"], *r)
                            break
                if not closed_by_log and progress is not None:
                    # backends without logdir evidence (scripted tests):
                    # any tracked worker's log movement counts
                    for k in sorted(moved):
                        if (k in self._reconf_open["workers"]
                                and progress.get(k, -1) >= 0):
                            self.close_reconfigure(k, progress[k])
                            break
            if target_worker is not None:
                # poll()'s headline step is worker 0's tail; only trust
                # it for the target when worker 0 IS the target worker
                best_step = (progress or {}).get(
                    target_worker,
                    got["step"] if target_worker == 0 else -1)
            else:
                best_step = got["step"]
                if progress:
                    best_step = max(best_step, *progress.values())
            if best_step >= target:
                if progress is None and watch_resume:
                    # no per-worker log signal on this backend: a
                    # restarted worker that shows alive at completion
                    # counts as resumed (same rule as the in-run
                    # fallback below)
                    final = got.get("workers")
                    if final is None:
                        final = (self.backend.status() or {}).get(
                            "workers", [])
                    for w in final:
                        if w.get("alive"):
                            self.close_episode(w["worker"], got["step"])
                self._event("target_reached", step=best_step)
                got["step"] = best_step
                got["recovery"] = self.summary()
                return got
            # ---- elastic resize fault (after the target check: a run
            # that already finished does not resize) -------------------
            if (resize is not None and not resize_fired
                    and best_step >= resize[0]):
                resize_fired = True
                if (self.reconfigures < cfg.max_reconfigures
                        and self._can_reconfigure()):
                    self.reconfigure(resize[1], trigger="fault_plan",
                                     poll_secs=min(poll_secs, 0.5))
                    cfg = self.cfg  # quorum may have rescaled
                    reset_roster_state()
                    time.sleep(poll_secs)
                    continue
            # ---- broker tick ------------------------------------------
            # A True return declares the roster changed under us: the
            # per-worker trackers describe workers that may no longer
            # exist, so they reset exactly as after this loop's own
            # reconfigures. A broken callback must not take down the
            # supervision it rides on.
            if on_tick is not None:
                try:
                    tick_changed = bool(on_tick(got))
                except Exception:
                    logger.exception("on_tick callback failed — "
                                     "supervision continues without it "
                                     "this tick")
                    tick_changed = False
                if tick_changed:
                    cfg = self.cfg
                    reset_roster_state()
                    time.sleep(poll_secs)
                    continue
            # reuse the liveness snapshot poll() already took this tick
            # (LocalProcessCluster attaches it); only backends that
            # don't get the separate status() sweep
            workers = got.get("workers")
            if workers is None:
                workers = (self.backend.status() or {}).get("workers", [])
            alive = {w["worker"]: w["alive"] for w in workers}
            n_alive = sum(alive.values())

            # ---- detect newly dead workers ----------------------------
            for k, is_alive in alive.items():
                if is_alive or k in pending_restart or k in exhausted:
                    continue
                self._detect_t[k] = time.time()
                self._event("detect", worker=k, at_step=got["step"],
                            kind="dead")
                schedule_restart(k, now)

            # ---- hang detection over workers whose log did NOT move --
            if progress is not None:
                for k, step_k in progress.items():
                    if (k not in moved
                            and cfg.stall_timeout_s > 0
                            and alive.get(k) and k not in pending_restart
                            and k not in exhausted
                            and now - last_progress_t.get(k, now)
                            >= cfg.stall_timeout_s):
                        self._detect_t[k] = time.time()
                        self._event("detect", worker=k, at_step=got["step"],
                                    kind="hung", stalled_at=step_k)
                        # a hung pid must die before its slot restarts
                        self.backend.kill_all(worker=str(k))
                        schedule_restart(k, now)
            elif watch_resume:
                # no progress signal on this backend: a restarted worker
                # that shows alive again counts as resumed
                for k in list(watch_resume):
                    if alive.get(k):
                        self.close_episode(k, got["step"])

            # ---- perform due restarts ---------------------------------
            for k in [k for k, due in pending_restart.items() if now >= due]:
                del pending_restart[k]
                self._restarts[k] = self._restarts.get(k, 0) + 1
                # standby fast path first: promoting a parked,
                # precompiled spare skips process boot AND compile; no
                # ready spare (or no backend support) → cold respawn
                promoted = False
                if (cfg.standby_workers > 0
                        and hasattr(self.backend, "promote_standby")):
                    try:
                        promoted = bool(self.backend.promote_standby(k))
                    except Exception as e:
                        # the fast path failing (torn activation file,
                        # spawn pressure) must not cost the restart
                        # itself — fall through to the cold respawn
                        if not isinstance(e, NotImplementedError):
                            logger.warning(
                                "standby promotion for worker %d failed "
                                "(%s: %s) — cold respawn", k,
                                type(e).__name__, e)
                        promoted = False
                if not promoted:
                    try:
                        self.backend.restart_worker(k)
                    except NotImplementedError:
                        exhausted.add(k)
                        self._event("restart_budget_exhausted", worker=k,
                                    restarts=self._restarts[k] - 1,
                                    reason="backend cannot restart workers")
                        continue
                self._respawn_t[k] = time.time()
                extra = {}
                if k in self._detect_t:
                    extra["detected_at"] = self._detect_t[k]
                    extra["respawn_s"] = round(
                        self._respawn_t[k] - self._detect_t[k], 3)
                self._event("restart", worker=k,
                            attempt=self._restarts[k], at_step=got["step"],
                            via="standby" if promoted else "respawn",
                            **extra)
                watch_resume.add(k)
                last_progress_t[k] = time.monotonic()

            # ---- quorum accounting ------------------------------------
            if n_alive != last_alive:
                if last_alive is not None or n_alive < len(alive):
                    self._event("quorum_transition", workers_alive=n_alive,
                                num_workers=len(alive), quorum=cfg.quorum,
                                degraded=n_alive < len(alive))
                last_alive = n_alive
            # abort only when BELOW quorum with no recovery in flight:
            # pending_restart covers scheduled-not-yet-performed restarts,
            # watch_resume the just-restarted workers this tick's (stale)
            # liveness snapshot predates — aborting on that snapshot
            # would kill the run right after the restart that saved it
            if (workers and n_alive < cfg.quorum
                    and not pending_restart and not watch_resume):
                # elastic shrink: permanent capacity loss reshapes the
                # world to the survivors instead of degraded-quorum
                # forever / an abort — the cluster resizes itself
                survivors = sorted(k for k, a in alive.items() if a)
                if (cfg.elastic
                        and self.reconfigures < cfg.max_reconfigures
                        and len(survivors) >= cfg.min_workers
                        and len(survivors) < len(alive)
                        and self._can_reconfigure()):
                    self.reconfigure(len(survivors),
                                     trigger="below_quorum",
                                     survivors=survivors,
                                     poll_secs=min(poll_secs, 0.5))
                    cfg = self.cfg  # quorum rescaled for the new world
                    reset_roster_state()
                    time.sleep(poll_secs)
                    continue
                self._event("below_quorum_abort", workers_alive=n_alive,
                            quorum=cfg.quorum)
                raise ClusterError(
                    f"{n_alive} live workers < quorum {cfg.quorum} and no "
                    f"restarts remain (budget "
                    f"{cfg.max_restarts_per_worker}/worker exhausted for "
                    f"{sorted(exhausted)}) at step {got['step']}")

            if time.monotonic() >= deadline:
                raise ClusterError(
                    f"supervised run did not reach step {target} within "
                    f"{timeout_secs:.0f}s (last seen: {got['step']})")
            logger.info("step %d/%d — %d/%d alive (quorum %d) — next poll "
                        "in %.1fs", got["step"], target, n_alive,
                        len(alive) or 0, cfg.quorum, poll_secs)
            time.sleep(poll_secs)
