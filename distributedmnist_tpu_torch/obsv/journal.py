"""Journal analysis (≙ ``distributedmnist_tpu/obsv/journal.py``,
whole): load JSONL journals torn-write-tolerantly and aggregate them —
a command journal into per-verb stats (attempts, retries, failures,
durations), recovery records into episodes and MTTR, reconfigure
records into world transitions, serve records into weight swaps by
tier, the discipline controller's and the resource broker's decision
records into their adaptation evidence, a trial directory's network
and disk faults into their books, and a chaos report into the
campaign's one-line summary (:func:`summarize_chaos`).
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


def summarize_autoscale(records: list[dict]) -> dict[str, Any]:
    """Aggregate a run's ``event: "autoscale"`` records (the resource
    broker's decision journal, ``launch/broker.py``) into its scaling
    evidence:

    * ``decisions`` / ``completed`` / ``errors`` — begin records and
      how each closed,
    * ``by_trigger`` / ``by_direction`` — which signal fired each
      decision and which way the roster moved,
    * ``reaction_s`` — detect→capacity-live latency percentiles from
      the ``complete`` records (the broker's MTTR analogue),
    * ``flaps`` — consecutive opposite-direction decisions closer than
      twice the recorded cooldown: the oscillation the hysteresis
      band exists to prevent, surfaced so a campaign can gate on it
      staying zero.
    """
    begins = [r for r in records if r.get("action") == "begin"]
    completes = [r for r in records if r.get("action") == "complete"]
    errors = [r for r in records if r.get("action") == "error"]
    by_trigger: dict[str, int] = {}
    by_direction: dict[str, int] = {}
    for r in begins:
        t = r.get("trigger", "?")
        by_trigger[t] = by_trigger.get(t, 0) + 1
        d = r.get("decision", "?")
        by_direction[d] = by_direction.get(d, 0) + 1
    flaps = 0
    prev: dict | None = None
    for r in begins:
        if prev is not None and r.get("decision") != prev.get("decision"):
            gap = (r.get("time") or 0) - (prev.get("time") or 0)
            lim = 2 * float(r.get("cooldown_s") or 30.0)
            if 0 <= gap < lim:
                flaps += 1
        prev = r
    out: dict[str, Any] = {"decisions": len(begins),
                           "completed": len(completes),
                           "errors": len(errors),
                           "by_trigger": by_trigger,
                           "by_direction": by_direction,
                           "flaps": flaps,
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


def summarize_discipline(records: list[dict]) -> dict[str, Any]:
    """Aggregate a run's ``event: "discipline"`` records (the straggler
    discipline controller's decision journal, ``train/discipline.py``)
    into its adaptation evidence — the same shape
    :func:`summarize_autoscale` gives the broker:

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


def summarize_net_chaos(trial_dir: str | Path) -> dict[str, Any] | None:
    """One trial's network-fault evidence, from artifacts alone: the
    ``net_*`` fault records the chaos proxies (launch/netchaos.py)
    journaled, the dedup-cache hits and deadline aborts the hardened
    replicas booked, and the client-side retry amplification the load
    journal shows. Returns ``None`` when the trial carries no network
    evidence at all — the per-trial ``net`` slot in the chaos report
    stays absent for non-network campaigns."""
    trial_dir = Path(trial_dir)
    by_kind: dict[str, int] = {}
    for r in load_jsonl(trial_dir / "command_journal.jsonl"):
        a = str(r.get("action", ""))
        if r.get("event") == schema.FAULT and a.startswith("net_"):
            by_kind[a] = by_kind.get(a, 0) + 1
    dedup_hits = conn_aborts = 0
    for f in sorted(trial_dir.glob("worker*/serve_log.jsonl")):
        for r in load_jsonl(f, schema.SERVE):
            if r.get("action") == "dedup_hit":
                dedup_hits += 1
            elif r.get("action") == "conn_abort":
                conn_aborts += 1
    attempts: list[float] = []
    retried = terminals = 0
    for r in load_jsonl(trial_dir / "loadgen.jsonl", schema.LOAD):
        if r.get("action") != "outcome":
            continue
        terminals += 1
        n = r.get("attempts")
        if isinstance(n, (int, float)):
            attempts.append(float(n))
        if r.get("retried") or (isinstance(n, int) and n > 1):
            retried += 1
    if not by_kind and not dedup_hits and not retried:
        return None
    out: dict[str, Any] = {
        "faults": by_kind, "fired": sum(by_kind.values()),
        "dedup_hits": dedup_hits, "conn_aborts": conn_aborts,
        "retried": retried,
        "retry_rate": round(retried / max(1, terminals), 4)}
    if attempts:
        s = sorted(attempts)
        out["attempts"] = {"p50": _percentile(s, 0.50),
                           "p99": _percentile(s, 0.99), "max": s[-1]}
    return out


def summarize_disk_chaos(trial_dir: str | Path) -> dict[str, Any] | None:
    """One trial's storage-fault evidence, from artifacts alone: the
    ``disk_*`` fault records each worker's injector (train/storage.py)
    journaled into its own ``storage_faults.jsonl``, and the
    degradation bookkeeping the trainer left behind — ``save_failed``
    (a cadence save skipped under ENOSPC/EIO, training continued) and
    ``fallback_restore`` (a restore that walked past a torn or
    power-cut artifact) in each worker's ``recovery_journal.jsonl``.
    Returns ``None`` when the trial carries no storage evidence at all
    — the per-trial ``disk`` slot in the chaos report stays absent for
    non-disk campaigns."""
    trial_dir = Path(trial_dir)
    by_action: dict[str, int] = {}
    workers: set[int] = set()
    for f in sorted(trial_dir.glob("worker*/storage_faults.jsonl")):
        for r in load_jsonl(f, schema.FAULT):
            a = str(r.get("action", ""))
            if not a.startswith("disk_"):
                continue
            by_action[a] = by_action.get(a, 0) + 1
            if isinstance(r.get("worker"), int):
                workers.add(r["worker"])
    save_failed = fallbacks = 0
    for f in sorted(trial_dir.glob("worker*/recovery_journal.jsonl")):
        for r in load_jsonl(f, schema.RECOVERY):
            if r.get("action") == "save_failed":
                save_failed += 1
            elif r.get("action") == "fallback_restore":
                fallbacks += 1
    if not by_action and not save_failed:
        return None
    return {"faults": by_action, "fired": sum(by_action.values()),
            "workers": sorted(workers), "save_failed": save_failed,
            "fallback_restores": fallbacks}


def summarize_chaos(path: str | Path) -> dict[str, Any]:
    """Aggregate a chaos campaign's ``chaos_report.jsonl`` (one
    ``event: "chaos_trial"`` record per trial, written by
    ``launch/chaos.py``) into the single-line campaign verdict: trial
    outcomes, per-invariant pass/fail/skip tallies, which trials
    violated what, and any shrunk reproducer paths. ``all_green`` means
    every trial passed every applicable invariant — the regression
    signal a scheduled chaos sweep gates on."""
    records = load_jsonl(path, event=schema.CHAOS_TRIAL)
    outcomes: dict[str, int] = {}
    by_invariant: dict[str, dict[str, int]] = {}
    failing: list[dict[str, Any]] = []
    reproducers: list[str] = []
    mttr_trials: list[dict[str, Any]] = []
    mttr_all: list[float] = []
    fault_trials: list[dict[str, Any]] = []
    serving_trials: list[dict[str, Any]] = []
    autoscale_trials: list[dict[str, Any]] = []
    discipline_trials: list[dict[str, Any]] = []
    net_trials: list[dict[str, Any]] = []
    disk_trials: list[dict[str, Any]] = []
    reconfigures = 0
    swaps_by_tier: dict[str, int] = {}
    quant_fallbacks = 0
    for rec in records:
        sv = rec.get("serving")
        if sv is not None:
            serving_trials.append({
                "trial": rec.get("trial"),
                "issued": sv.get("issued"),
                "dropped": sv.get("dropped"),
                "responses": sv.get("responses"),
                "rejected": sv.get("rejected"),
                "errors": sv.get("errors"),
                "reject_rate": sv.get("reject_rate"),
                "p50_ms": (sv.get("latency_ms") or {}).get("p50"),
                "p99_ms": (sv.get("latency_ms") or {}).get("p99"),
                # decode sweeps: tokens actually streamed and the
                # time-to-first-token tail (None on classify trials)
                "tokens_streamed": sv.get("tokens_streamed"),
                "ttft_p99_ms": (sv.get("ttft_ms") or {}).get("p99"),
                "model_steps_served": sv.get("model_steps_served"),
                "tiers_served": sv.get("tiers_served"),
                "serve_swaps": rec.get("serve_swaps")})
            # swap-by-tier tally across the campaign; a trial record
            # (or its swaps) written before the quantized tiers
            # existed carries no tier breakdown — those swaps count as
            # fp32, the only tier that path ever served (never a
            # KeyError on legacy journals)
            sw = rec.get("serve_swaps") or {}
            tiers = sw.get("by_tier")
            if tiers is None:
                tiers = {"fp32": sw.get("swaps", 0)} if sw else {}
            for tier, n in tiers.items():
                key = tier or "fp32"
                swaps_by_tier[key] = swaps_by_tier.get(key, 0) + (n or 0)
            quant_fallbacks += sw.get("quant_sidecar_fallbacks") or 0
        a = rec.get("autoscale")
        if a is not None:
            autoscale_trials.append({
                "trial": rec.get("trial"),
                "decisions": a.get("decisions", 0),
                "fired": a.get("fired", 0),
                "by_direction": a.get("by_direction") or {},
                "flaps": a.get("flaps", 0),
                "reaction_p99_s": (a.get("reaction_s") or {}).get("p99")})
        dc = rec.get("discipline")
        if dc is not None:
            discipline_trials.append({
                "trial": rec.get("trial"),
                "changes": dc.get("changes", 0),
                "by_direction": dc.get("by_direction") or {},
                "flaps": dc.get("flaps", 0),
                "trace": dc.get("trace") or []})
        nt = rec.get("net")
        if nt is not None:
            net_trials.append({
                "trial": rec.get("trial"),
                "faults": nt.get("faults") or {},
                "fired": nt.get("fired", 0),
                "dedup_hits": nt.get("dedup_hits", 0),
                "conn_aborts": nt.get("conn_aborts", 0),
                "retried": nt.get("retried", 0),
                "retry_rate": nt.get("retry_rate"),
                "attempts_p50": (nt.get("attempts") or {}).get("p50"),
                "attempts_p99": (nt.get("attempts") or {}).get("p99")})
        dk = rec.get("disk")
        if dk is not None:
            disk_trials.append({
                "trial": rec.get("trial"),
                "faults": dk.get("faults") or {},
                "fired": dk.get("fired", 0),
                "save_failed": dk.get("save_failed", 0),
                "fallback_restores": dk.get("fallback_restores", 0)})
        f = rec.get("faults")
        if f is not None:
            fault_trials.append({"trial": rec.get("trial"),
                                 "scheduled": f.get("scheduled", 0),
                                 "fired": f.get("fired", 0),
                                 "unfired": f.get("unfired", [])})
        reconfigures += rec.get("reconfigures") or 0
        outcomes[rec.get("outcome", "?")] = (
            outcomes.get(rec.get("outcome", "?"), 0) + 1)
        for inv, verdict in (rec.get("verdicts") or {}).items():
            slot = by_invariant.setdefault(
                inv, {"pass": 0, "fail": 0, "skipped": 0})
            slot[verdict] = slot.get(verdict, 0) + 1
        if rec.get("violations"):
            failing.append({
                "trial": rec.get("trial"),
                "schedule": rec.get("described"),
                "invariants": sorted({v["invariant"]
                                      for v in rec["violations"]})})
        shrunk = rec.get("shrunk")
        if shrunk and shrunk.get("fault_plan_path"):
            reproducers.append(shrunk["fault_plan_path"])
        m = rec.get("mttr")
        if m is not None:
            mttr_trials.append({"trial": rec.get("trial"),
                                "episodes": m.get("episodes", 0),
                                "unrecovered": m.get("unrecovered", 0),
                                "p50_s": m.get("p50_s"),
                                "max_s": m.get("max_s")})
            mttr_all += [v for w in (m.get("by_worker") or {}).values()
                         for v in w]
    mttr: dict[str, Any] = {
        "episodes": sum(t["episodes"] for t in mttr_trials),
        # detects no resume ever closed (exhausted budgets, or a worker
        # torn down before it moved): surfaced so "every recovery
        # episode has an MTTR" is checkable, not assumed
        "unrecovered": sum(t["unrecovered"] for t in mttr_trials),
        "per_trial": mttr_trials}
    if mttr_all:
        s = sorted(mttr_all)
        mttr.update(mean_s=round(sum(s) / len(s), 3),
                    p50_s=_percentile(s, 0.50),
                    p90_s=_percentile(s, 0.90), max_s=s[-1])
    return {"trials": len(records),
            "seed": records[0].get("seed") if records else None,
            "outcomes": outcomes,
            "invariants": by_invariant,
            "all_green": not failing and bool(records),
            "failing_trials": failing,
            "reproducers": reproducers,
            # scheduled-vs-fired accounting: a kill that lands after
            # run-end fires nothing — without this a zero-episode
            # trial is indistinguishable from a real all-quiet run,
            # and the nightly gate asserts the campaign actually
            # FIRED something (fired > 0)
            "faults": {
                "scheduled": sum(t["scheduled"] for t in fault_trials),
                "fired": sum(t["fired"] for t in fault_trials),
                "never_fired": sum(len(t["unfired"])
                                   for t in fault_trials),
                "per_trial": fault_trials},
            # elastic world reshapes across the campaign (the resize
            # fault kind / below-quorum shrinks)
            "reconfigures": reconfigures,
            # MTTR as a first-class campaign metric: detect→first-
            # moved-step latency over every recovery episode in every
            # trial (the chaos CI asserts this key exists and uploads
            # its one-line summary)
            "mttr": mttr,
            # serving-mode campaigns: per-trial load-sweep evidence
            # (issued/dropped/rejects/p99 under live faults) — the
            # zero-drop claim is checkable from the one-line summary
            "serving": ({
                "trials": len(serving_trials),
                "issued": sum(t["issued"] or 0 for t in serving_trials),
                "dropped": sum(t["dropped"] or 0 for t in serving_trials),
                "responses": sum(t["responses"] or 0
                                 for t in serving_trials),
                "errors": sum(t["errors"] or 0 for t in serving_trials),
                # decode campaigns: total generated tokens + the worst
                # per-trial time-to-first-token tail (the decode
                # latency split the loadgen records per request)
                "tokens_streamed": sum(t["tokens_streamed"] or 0
                                       for t in serving_trials),
                "ttft_p99_ms": max(
                    (t["ttft_p99_ms"] for t in serving_trials
                     if t["ttft_p99_ms"] is not None), default=None),
                # which precision tier each installed swap served
                # (tier-less legacy swaps counted as fp32) and how
                # often a quantized replica's sidecar preference fell
                # back to full precision — the campaign-level evidence
                # for the quantized serving path
                "swaps_by_tier": swaps_by_tier,
                "quant_sidecar_fallbacks": quant_fallbacks,
                "per_trial": serving_trials}
                if serving_trials else None),
            # brokered campaigns: the autoscale evidence per trial and
            # in aggregate — the nightly broker gate asserts decisions
            # fired (> 0), in BOTH directions, with zero flaps
            "autoscale": ({
                "trials": len(autoscale_trials),
                "decisions": sum(t["decisions"] or 0
                                 for t in autoscale_trials),
                "fired": sum(t["fired"] or 0 for t in autoscale_trials),
                "scale_ups": sum(
                    t["by_direction"].get("scale_up_serving", 0)
                    for t in autoscale_trials),
                "scale_downs": sum(
                    t["by_direction"].get("scale_down_serving", 0)
                    for t in autoscale_trials),
                "flaps": sum(t["flaps"] or 0 for t in autoscale_trials),
                "reaction_p99_s": max(
                    (t["reaction_p99_s"] for t in autoscale_trials
                     if t["reaction_p99_s"] is not None), default=None),
                "per_trial": autoscale_trials}
                if autoscale_trials else None),
            # controller-armed campaigns: the straggler-discipline
            # evidence per trial and in aggregate — the nightly gate
            # asserts changes fired with zero flaps and every trial's
            # discipline invariant green
            "discipline": ({
                "trials": len(discipline_trials),
                "changes": sum(t["changes"] or 0
                               for t in discipline_trials),
                "tightens": sum(
                    n for t in discipline_trials
                    for d, n in t["by_direction"].items()
                    if d.startswith("tighten")),
                "relaxes": sum(
                    n for t in discipline_trials
                    for d, n in t["by_direction"].items()
                    if not d.startswith("tighten")),
                "flaps": sum(t["flaps"] or 0 for t in discipline_trials),
                "per_trial": discipline_trials}
                if discipline_trials else None),
            # network-mode campaigns: the transport-fault evidence per
            # trial and in aggregate — faults by kind, dedup-cache
            # hits (the exactly-once proof), retry amplification —
            # the nightly network gate asserts faults fired (incl. a
            # mid-stream reset), dropped==0, and invariant 13 green
            "net": ({
                "trials": len(net_trials),
                "fired": sum(t["fired"] or 0 for t in net_trials),
                "faults_by_kind": {
                    k: sum((t["faults"] or {}).get(k, 0)
                           for t in net_trials)
                    for t2 in net_trials for k in (t2["faults"] or {})},
                "dedup_hits": sum(t["dedup_hits"] or 0
                                  for t in net_trials),
                "conn_aborts": sum(t["conn_aborts"] or 0
                                   for t in net_trials),
                "retried": sum(t["retried"] or 0 for t in net_trials),
                "attempts_p50": max(
                    (t["attempts_p50"] for t in net_trials
                     if t["attempts_p50"] is not None), default=None),
                "attempts_p99": max(
                    (t["attempts_p99"] for t in net_trials
                     if t["attempts_p99"] is not None), default=None),
                "per_trial": net_trials}
                if net_trials else None),
            # disk-mode campaigns: the storage-fault evidence per
            # trial and in aggregate — firings by action, cadence
            # saves skipped under injected ENOSPC/EIO, fallback
            # restores past torn/power-cut artifacts — the nightly
            # disk gate asserts faults fired (incl. a retry-exhausting
            # ENOSPC) and invariant 14 green
            "disk": ({
                "trials": len(disk_trials),
                "fired": sum(t["fired"] or 0 for t in disk_trials),
                "faults_by_action": {
                    k: sum((t["faults"] or {}).get(k, 0)
                           for t in disk_trials)
                    for t2 in disk_trials for k in (t2["faults"] or {})},
                "save_failed": sum(t["save_failed"] or 0
                                   for t in disk_trials),
                "fallback_restores": sum(t["fallback_restores"] or 0
                                         for t in disk_trials),
                "per_trial": disk_trials}
                if disk_trials else None)}


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
