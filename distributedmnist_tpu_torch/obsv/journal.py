"""Journal analysis (≙ ``distributedmnist_tpu/obsv/journal.py``): load
JSONL journals torn-write-tolerantly and aggregate them — a command
journal into per-verb stats (attempts, retries, failures, durations),
recovery records into episodes and MTTR, serve records into weight
swaps by tier, the discipline controller's records into its
adaptation trace, reconfigure records into world transitions. The
cluster-campaign summaries (chaos, network and disk faults, autoscale)
are not ported yet: the port writes no cluster trial directories.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Iterator

from . import schema
from .report import load_jsonl


def tail_records(path: str | Path | None = None, *,
                 text: str | None = None,
                 tail_bytes: int = 1 << 16) -> Iterator[dict]:
    """Intact dict records from the tail of a live JSONL stream,
    NEWEST FIRST.

    The one torn-tail discipline every poll-loop reader shares: the
    writer may be mid-append (or the tail window may start mid-line),
    so blank, torn, and non-dict lines are skipped rather than treated
    as evidence — a reader that reports "nothing" for a whole poll
    tick because one line was torn makes live progress look stalled.
    Callers filter for the record shape they want and stop at the
    first hit; this generator does no more file I/O than the single
    tail read.

    Pass EITHER ``path`` (reads only the final ``tail_bytes`` of the
    file; unreadable/missing file yields nothing) OR ``text`` (a tail
    another transport already captured, e.g. a remote ``tail -n``
    result). Distinct keywords, not one polymorphic argument: a str
    path and a str blob are indistinguishable by type.
    """
    if (path is None) == (text is None):
        raise ValueError("tail_records: pass exactly one of path/text")
    if text is None:
        try:
            with open(Path(path), "rb") as f:
                f.seek(0, 2)
                size = f.tell()
                f.seek(max(0, size - tail_bytes))
                text = f.read().decode("utf-8", errors="replace")
        except OSError:
            return
    for line in reversed(text.splitlines()):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue  # torn write (or the window started mid-line)
        if isinstance(rec, dict):
            yield rec


def load_journal(path: str | Path) -> list[dict]:
    """Command records from a journal (tolerates a torn tail write)."""
    return load_jsonl(path, event=schema.COMMAND)


def load_recovery_events(path: str | Path) -> list[dict]:
    """Structured recovery records (``event: "recovery"``) — written by
    the supervisor into the command journal and by the trainer /
    checkpoint layer into ``train_dir/recovery_journal.jsonl``."""
    return load_jsonl(path, event=schema.RECOVERY)


def load_reconfigure_events(path: str | Path) -> list[dict]:
    """Elastic world-reshape records (``event: "reconfigure"``) —
    written by the supervisor (begin → relaunched → resume) and the
    cluster backend (reshape) into the command journal. Their presence
    is the causal LICENSE for a world change: the cross-world resume
    invariant (obsv/invariants.py) fails a run whose world silently
    changed shape without one."""
    return load_jsonl(path, event=schema.RECONFIGURE)


def summarize_reconfigure_events(records: list[dict]) -> dict[str, Any]:
    """Aggregate reconfigure records into the transition evidence:
    one entry per ``begin`` (old/new world, trigger, the quorum as
    specified and as rescaled for the new world) folded with its
    ``relaunched`` (drain latency, per-worker respawn-vs-standby) and
    ``resume`` (drain→first-moved-step latency — the MTTR analogue
    for a world change). Supervisor-less reshapes (a bare backend
    ``reconfigure``) count as their own transitions."""
    transitions: list[dict[str, Any]] = []
    cur: dict[str, Any] | None = None
    for r in records:
        a = r.get("action")
        if a == "begin":
            # the schema registry IS the field list: every required
            # begin field lands in the transition, so emitter and
            # summarizer can't drift
            cur = {k: r.get(k) for k in schema.required_fields(
                schema.RECONFIGURE, "begin")}
            transitions.append(cur)
        elif a == "reshape" and cur is None:
            t = {k: r.get(k) for k in schema.required_fields(
                schema.RECONFIGURE, "reshape")}
            t["trigger"] = "backend"
            transitions.append(t)
        elif a == "relaunched" and cur is not None:
            cur["drain_s"] = r.get("drain_s")
            cur["via"] = r.get("via")
            cur["grown"] = r.get("grown")
        elif a == "resume" and cur is not None:
            cur["reconfigure_s"] = r.get("reconfigure_s")
            cur["first_moved_worker"] = r.get("worker")
            cur["first_moved_step"] = r.get("step")
            cur = None
    return {"count": len(transitions), "transitions": transitions}


def summarize_reconfigures(path: str | Path) -> dict[str, Any]:
    """Load + aggregate the reconfigure events in one journal file."""
    return summarize_reconfigure_events(load_reconfigure_events(path))


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def summarize_serving_swaps(records: list[dict]) -> dict[str, Any]:
    """Weight-swap accounting over serve-journal records (``event:
    "serve"``), broken down by the precision tier each swap installed.
    A ``weight_swap`` WITHOUT a ``tier`` field is a legacy journal
    from before the quantized serving tiers existed — it counts as
    ``fp32`` (the only representation that path ever served), so
    replaying pre-quantization artifacts can never KeyError here.
    ``quant_sidecar_fallbacks`` counts publishes where a quantized
    replica fell back to full precision (absent/torn/tier-less
    sidecar) — the nightly campaign's evidence that the sidecar digest
    refusal actually fired."""
    swaps = [r for r in records if r.get("action") == "weight_swap"]
    by_tier: dict[str, int] = {}
    for r in swaps:
        tier = r.get("tier") or "fp32"
        by_tier[tier] = by_tier.get(tier, 0) + 1
    return {"swaps": len(swaps), "by_tier": by_tier,
            "quant_sidecar_fallbacks": sum(
                1 for r in records
                if r.get("action") == "follow_quant_sidecar_fallback")}


def summarize_mttr(records: list[dict]) -> dict[str, Any]:
    """MTTR (mean-time-to-recovery) over the recovery episodes in a
    journal: each ``resume`` closes a detect→respawned→first-moved-step
    episode. Prefers the explicit ``mttr_s`` the supervisor stamps on
    resume events; legacy journals without it fall back to the wall
    timestamps of the worker's pending detect. Always returns the dict
    (``episodes: 0`` when none) so campaign reports can assert the
    metric is PRESENT, not just non-crashing; ``unrecovered`` counts
    detects no resume ever closed (exhausted budgets, teardown before
    the restarted worker moved)."""
    pending_detect: dict[int, float] = {}
    episodes: list[float] = []
    respawn: list[float] = []
    superseded = 0
    by_worker: dict[int, list[float]] = {}
    for rec in records:
        action = rec.get("action")
        k = rec.get("worker")
        if action == "detect" and k is not None:
            pending_detect[k] = rec.get("time")
        elif action == "episode_superseded" and k is not None:
            # a world reshape (reconfigure) replaced the in-flight
            # restart: the episode is neither recovered nor lost — the
            # reconfigure transition's own latency covers it
            if pending_detect.pop(k, None) is not None:
                superseded += 1
        elif action == "resume" and k is not None:
            m = rec.get("mttr_s")
            if m is None:
                t0 = pending_detect.get(k)
                t1 = rec.get("time")
                m = (round(t1 - t0, 3)
                     if t0 is not None and t1 is not None else None)
            pending_detect.pop(k, None)
            if m is not None:
                episodes.append(m)
                by_worker.setdefault(k, []).append(m)
            if rec.get("resume_after_respawn_s") is not None:
                respawn.append(rec["resume_after_respawn_s"])
    # detects never closed by a resume: budget-exhausted workers (no
    # recovery to time) or a run torn down before the restarted worker
    # ever moved — surfaced instead of silently undercounting episodes
    out: dict[str, Any] = {"episodes": len(episodes),
                           "unrecovered": len(pending_detect),
                           "superseded": superseded}
    if episodes:
        s = sorted(episodes)
        out.update(mean_s=round(sum(s) / len(s), 3),
                   p50_s=_percentile(s, 0.50),
                   p90_s=_percentile(s, 0.90),
                   max_s=s[-1],
                   by_worker={k: v for k, v in sorted(by_worker.items())})
    if respawn:
        # the respawn→first-moved-step leg alone: what the compile
        # cache / standby fast path actually shrinks
        s = sorted(respawn)
        out["resume_after_respawn_p50_s"] = _percentile(s, 0.50)
        out["resume_after_respawn_max_s"] = s[-1]
    return out


def summarize_recovery_events(records: list[dict]) -> dict[str, Any]:
    """Aggregate recovery records into the episode's evidence:

    * ``by_action`` — counts per action (detect, restart, resume,
      nan_rollback, corrupt_checkpoint_fallback, …),
    * ``by_worker`` — each worker's ordered action chain, e.g.
      ``["detect", "restart", "resume"]`` for a clean
      kill → restart → resume episode,
    * ``quorum_transitions`` — the workers_alive trajectory,
    * ``resume_steps`` — {worker: step} where restarted workers picked
      the run back up,
    * ``mttr`` — detect→first-moved-step latency percentiles per
      :func:`summarize_mttr` (present even when zero episodes).
    """
    by_action: dict[str, int] = {}
    by_worker: dict[int, list[str]] = {}
    quorum: list[dict] = []
    resume_steps: dict[int, int] = {}
    for rec in records:
        action = rec.get("action", "?")
        by_action[action] = by_action.get(action, 0) + 1
        if "worker" in rec:
            by_worker.setdefault(rec["worker"], []).append(action)
        if action == "quorum_transition":
            quorum.append({k: rec.get(k) for k in schema.required_fields(
                schema.RECOVERY, "quorum_transition")})
        if action == "resume" and "worker" in rec:
            resume_steps[rec["worker"]] = rec.get("step")
    return {"events": len(records), "by_action": by_action,
            "by_worker": by_worker, "quorum_transitions": quorum,
            "resume_steps": resume_steps,
            "mttr": summarize_mttr(records)}


def summarize_recovery(path: str | Path) -> dict[str, Any]:
    """Load + aggregate the recovery events in one journal file."""
    return summarize_recovery_events(load_recovery_events(path))


def summarize_discipline(records: list[dict]) -> dict[str, Any]:
    """Aggregate a run's ``event: "discipline"`` records (the straggler
    discipline controller's decision journal, ``train/discipline.py``)
    into its adaptation evidence:

    * ``changes`` / ``completed`` — begin records and how many closed,
    * ``by_trigger`` / ``by_direction`` — which CDF signal licensed
      each change and which way the discipline moved (tighten/relax
      quorum, retarget/restore timeout),
    * ``trace`` — the per-window discipline trajectory
      ``[(effective_step, k, timeout_ms), ...]`` from the completes:
      the parameter-vs-step curve a bench report plots,
    * ``reaction_s`` — decide→staged latency percentiles,
    * ``flaps`` — consecutive opposite-direction changes closer (in
      STEPS — the controller's clock) than twice the recorded
      cooldown: the oscillation the dead band exists to prevent,
      surfaced so campaigns gate on it staying zero.
    """
    begins = [r for r in records if r.get("event") == schema.DISCIPLINE
              and r.get("action") == "begin"]
    completes = [r for r in records if r.get("event") == schema.DISCIPLINE
                 and r.get("action") == "complete"]
    by_trigger: dict[str, int] = {}
    by_direction: dict[str, int] = {}
    for r in begins:
        t = r.get("trigger", "?")
        by_trigger[t] = by_trigger.get(t, 0) + 1
        d = r.get("decision", "?")
        by_direction[d] = by_direction.get(d, 0) + 1
    # tighten_* vs relax_*/restore_* are the two directions; a flap is
    # a reversal inside 2× the step cooldown
    def _dir(decision: str | None) -> str:
        return "tighten" if (decision or "").startswith("tighten") \
            else "relax"
    flaps = 0
    prev: dict | None = None
    for r in begins:
        if prev is not None and _dir(r.get("decision")) != _dir(
                prev.get("decision")):
            gap = (r.get("at_step") or 0) - (prev.get("at_step") or 0)
            lim = 2 * int(r.get("cooldown_steps") or 40)
            if 0 <= gap < lim:
                flaps += 1
        prev = r
    trace = [(r.get("effective_step"), r.get("k"), r.get("timeout_ms"))
             for r in completes]
    out: dict[str, Any] = {"changes": len(begins),
                           "completed": len(completes),
                           "by_trigger": by_trigger,
                           "by_direction": by_direction,
                           "flaps": flaps,
                           "trace": trace,
                           "reaction_s": {}}
    reactions = sorted(float(r["reaction_s"]) for r in completes
                       if isinstance(r.get("reaction_s"), (int, float)))
    if reactions:
        out["reaction_s"] = {
            "mean": round(sum(reactions) / len(reactions), 3),
            "p50": _percentile(reactions, 0.50),
            "p99": _percentile(reactions, 0.99),
            "max": reactions[-1]}
    return out


def summarize_journal(path: str | Path) -> dict[str, Any]:
    """Aggregate a command journal into run-level evidence.

    Returns {"commands", "attempts", "retries", "failures",
    "probe_nonzero", "timeouts", "injected", "dry_run", "by_verb":
    {verb: {"attempts", "failures", "retries", "total_duration_ms"}}} —
    "commands" counts final attempts (one per executor.run call),
    "failures" final attempts of CHECKED commands that still failed.
    A nonzero rc from a check=False command (e.g. the ``kill -0``
    liveness probe of a dead worker) is an observation, not a control-
    plane failure — it lands in "probe_nonzero" instead, so
    ``failures == 0`` keeps meaning "nothing unexpected happened".
    """
    records = load_journal(path)
    by_verb: dict[str, dict[str, float]] = {}
    summary: dict[str, Any] = {"commands": 0, "attempts": 0, "retries": 0,
                               "failures": 0, "probe_nonzero": 0,
                               "timeouts": 0, "injected": 0,
                               "dry_run": 0, "by_verb": by_verb}
    for rec in records:
        verb = rec.get("verb", "?")
        v = by_verb.setdefault(verb, {"attempts": 0, "failures": 0,
                                      "retries": 0, "total_duration_ms": 0.0})
        if rec.get("dry_run"):
            summary["dry_run"] += 1
            continue
        summary["attempts"] += 1
        v["attempts"] += 1
        v["total_duration_ms"] = round(
            v["total_duration_ms"] + (rec.get("duration_ms") or 0.0), 3)
        if rec.get("timed_out"):
            summary["timeouts"] += 1
        if rec.get("injected"):
            summary["injected"] += 1
        if rec.get("will_retry"):
            summary["retries"] += 1
            v["retries"] += 1
        else:
            summary["commands"] += 1  # final attempt of its run() call
            ok = rec.get("rc") == 0 and not rec.get("timed_out")
            if not ok:
                if rec.get("check", True):
                    summary["failures"] += 1
                    v["failures"] += 1
                else:
                    summary["probe_nonzero"] += 1
    return summary
