"""Post-run invariant checking (≙ ``distributedmnist_tpu/obsv/
invariants.py``, whole): is a *recovered* run a *correct* run? The
checkers replay a finished run's ARTIFACTS ALONE — ``train_log.jsonl``,
the command journal, the recovery and serve journals, the checkpoint
dir — so a downloaded trial directory is as checkable as a live one,
and the chaos campaign (``launch/chaos.py``) can shrink a failing
schedule by re-running and re-checking mechanically:

1. **terminal_state** (:func:`check_terminal_state`) — the run reached
   its target, or aborted only through a journaled
   ``below_quorum_abort`` within the restart budget.
2. **metrics_log** (:func:`check_metrics_log`) — the step series is
   gap-free and duplicate-free after rollback splicing
   (:func:`splice_rollbacks`), every rewind explained by a journaled
   recovery event.
3. **determinism** (:func:`determinism_verdict`) — a faulted but fully
   recovered worker's final params and optimizer state bitwise equal
   to a fault-free same-seed reference run's.
4. **causality** (:func:`check_causality`) — every restart follows a
   detect, every fallback restore a corruption or I/O event.
5. **checkpoint_integrity** (:func:`check_checkpoint_dir`) — every
   digest sidecar verifies (journaled torn targets exempt,
   :func:`corruption_exempt_targets`) and the pointer resolves.
6. **reconfigure** (:func:`check_reconfigure`) — a changed world is
   licensed by a journaled reshape, lands where the artifacts show,
   and its metrics splice across the change.
7–10. the serving invariants (:func:`check_serving`): one terminal
   outcome a request, never a torn publish, monotone served steps,
   licensed swaps mid-generation.
11. **serve_group** (:func:`check_serve_group`) — a tensor-parallel
   serving group dies and restarts as a unit.
12. **autoscale** (:func:`check_autoscale`) — every roster change of
   the resource broker is licensed by a held signal crossing.
13. **net_faults** (:func:`check_net_faults`) — exactly-once outcomes
   under retry amplification.
14. **discipline** (:func:`check_discipline`) — every change of the
   adaptive controller (``train/discipline.py``) is licensed, closed
   and observed at its epoch boundary.
15. **storage_faults** (:func:`check_storage_faults`) — every skipped
   save and every fallback past a corrupt checkpoint licensed by an
   injected disk fault.

:func:`check_run` runs every checker that applies to a trial directory
(``worker<k>/`` logdirs, ``command_journal.jsonl``, ``outcome.json``);
:func:`shrink_faults` is the greedy minimizer. The serving, group,
autoscale and network checkers read trial directories the port cannot
write yet (its chaos campaign runs the train and shell payloads), so
they hold the reference's verdicts on the reference's artifacts. The
event vocabulary is the one ``obsv/schema.py`` declares, so reader and
writer cannot drift.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Callable

from . import schema
from .report import load_jsonl

INVARIANTS = ("terminal_state", "metrics_log", "determinism",
              "causality", "checkpoint_integrity", "reconfigure",
              "serve_outcomes", "serve_digest", "serve_monotone",
              "decode_swap", "serve_group", "autoscale", "discipline",
              "net_faults", "storage_faults")


@dataclasses.dataclass(frozen=True)
class Violation:
    invariant: str          # one of INVARIANTS
    detail: str
    worker: int | None = None

    def to_dict(self) -> dict[str, Any]:
        d = {"invariant": self.invariant, "detail": self.detail}
        if self.worker is not None:
            d["worker"] = self.worker
        return d


# ---------------------------------------------------------------------------
# (2) metrics log: rollback splicing + gap/duplicate checking
# ---------------------------------------------------------------------------

def splice_rollbacks(steps: list[dict]) -> tuple[list[dict], int]:
    """Replay the append-ordered step records through rewind-supersede
    splicing: when a record's step is <= the previous one (a rollback
    or restart-resume re-ran that span), the superseded suffix is
    dropped and the re-run records take its place — the same view a
    log consumer must take after any rollback. Returns the spliced
    series (strictly increasing by construction) and the number of
    rewinds observed."""
    out: list[dict] = []
    rewinds = 0
    for rec in steps:
        s = rec.get("step")
        if not isinstance(s, int):
            continue
        if out and s <= out[-1]["step"]:
            rewinds += 1
            while out and out[-1]["step"] >= s:
                out.pop()
        out.append(rec)
    return out, rewinds


def check_metrics_log(steps: list[dict], allowed_rewinds: int | None = None,
                      worker: int | None = None,
                      expect_first_step: int | None = 1) -> list[Violation]:
    """Invariant (2) over one worker's step records.

    ``allowed_rewinds``: how many rewinds the recovery journals justify
    (restarts + NaN rollbacks + reconfigure relaunches). None skips the
    explanation check (a bare log with no journal context). A rewind
    count EXCEEDING the justified one is how a doctored/duplicated
    record — or a rollback that re-emitted a window it already wrote —
    surfaces. ``expect_first_step``: where the spliced series must
    begin; None waives it (a GROWN worker seeded from a survivor's
    checkpoint legitimately starts mid-run)."""
    out: list[Violation] = []
    if not steps:
        return [Violation("metrics_log", "no step records at all", worker)]
    spliced, rewinds = splice_rollbacks(steps)
    if allowed_rewinds is not None and rewinds > allowed_rewinds:
        out.append(Violation(
            "metrics_log",
            f"{rewinds} rewind(s) in the step series but only "
            f"{allowed_rewinds} journaled recovery cause(s) — "
            "duplicated or re-emitted step records", worker))
    if (spliced and expect_first_step is not None
            and spliced[0]["step"] != expect_first_step):
        out.append(Violation(
            "metrics_log",
            f"spliced series starts at step {spliced[0]['step']}, not "
            f"{expect_first_step} (missing leading records)", worker))
    for prev, rec in zip(spliced, spliced[1:]):
        if rec["step"] != prev["step"] + 1:
            out.append(Violation(
                "metrics_log",
                f"gap in spliced series: step {prev['step']} -> "
                f"{rec['step']}", worker))
    return out


# ---------------------------------------------------------------------------
# (1) terminal-state legality and (4) journal causality
# ---------------------------------------------------------------------------

def check_terminal_state(outcome: dict, recovery_events: list[dict]
                         ) -> list[Violation]:
    """Invariant (1): ``outcome`` is the campaign's trial record
    ({"outcome", "step", "target", "supervisor": SupervisorConfig
    fields}); legality is judged against the journaled events."""
    out: list[Violation] = []
    target = outcome.get("target", 0)
    kind = outcome.get("outcome")
    aborts = [r for r in recovery_events
              if r.get("action") == "below_quorum_abort"]
    if kind == "completed":
        if outcome.get("step", -1) < target:
            out.append(Violation(
                "terminal_state",
                f"trial reported completed at step {outcome.get('step')} "
                f"< target {target}"))
        if aborts:
            out.append(Violation(
                "terminal_state",
                "completed trial has a below_quorum_abort event"))
    elif kind == "aborted":
        if not aborts:
            out.append(Violation(
                "terminal_state",
                "aborted without a journaled below_quorum_abort — the "
                "quorum policy never sanctioned this exit"))
        else:
            quorum = (outcome.get("supervisor") or {}).get("quorum")
            rec = aborts[-1]
            if (quorum is not None and rec.get("workers_alive") is not None
                    and rec["workers_alive"] >= quorum):
                out.append(Violation(
                    "terminal_state",
                    f"abort with workers_alive={rec['workers_alive']} >= "
                    f"quorum {quorum}"))
    else:
        out.append(Violation(
            "terminal_state",
            f"illegal terminal state {kind!r}: "
            f"{outcome.get('error', 'no error recorded')}"))
    # restart budget respected regardless of the terminal kind
    budget = (outcome.get("supervisor") or {}).get("max_restarts_per_worker")
    if budget is not None:
        per_worker: dict[int, int] = {}
        for r in recovery_events:
            if r.get("action") == "restart" and "worker" in r:
                per_worker[r["worker"]] = per_worker.get(r["worker"], 0) + 1
        for k, n in sorted(per_worker.items()):
            if n > budget:
                out.append(Violation(
                    "terminal_state",
                    f"{n} restarts > budget {budget}", k))
    return out


def check_causality(recovery_events: list[dict],
                    worker_events: dict[int, list[dict]]) -> list[Violation]:
    """Invariant (4). ``recovery_events``: the supervisor's records from
    the command journal; ``worker_events``: each worker's own
    ``recovery_journal.jsonl`` records."""
    out: list[Violation] = []
    chains: dict[int, list[str]] = {}
    for r in recovery_events:
        if "worker" in r:
            chains.setdefault(r["worker"], []).append(r.get("action", "?"))
    for k, chain in sorted(chains.items()):
        detects = restarts = 0
        for action in chain:
            detects += action == "detect"
            restarts += action == "restart"
            if restarts > detects:
                out.append(Violation(
                    "causality",
                    f"restart #{restarts} not preceded by a detect "
                    f"(chain: {chain})", k))
                break
    for k, events in sorted(worker_events.items()):
        causes = restores = 0
        for r in events:
            action = r.get("action")
            causes += action in ("corrupt_checkpoint_fallback",
                                 "rollback_candidate_unusable")
            restores += action == "fallback_restore"
            if restores > causes:
                out.append(Violation(
                    "causality",
                    "fallback_restore without a preceding corruption/IO "
                    "event in the worker recovery journal", k))
                break
    return out


# ---------------------------------------------------------------------------
# (5) checkpoint-dir integrity
# ---------------------------------------------------------------------------

def check_checkpoint_dir(logdir: str | Path, exempt: set[str] = frozenset(),
                         worker: int | None = None) -> list[Violation]:
    """Invariant (5) over one worker's logdir. ``exempt``: artifact
    names the command journal records as DELIBERATELY torn by the fault
    injector — finding those corrupt is the plan working, any other
    mismatch is damage nobody injected."""
    from ..train.checkpoint import CheckpointCorruptError, verify_artifact
    logdir = Path(logdir)
    out: list[Violation] = []
    for sidecar in sorted(logdir.glob("ckpt-*.sha256")):
        data_file = sidecar.with_suffix("")  # strip the .sha256 suffix
        if data_file.name in exempt:
            continue
        if not data_file.exists():
            out.append(Violation(
                "checkpoint_integrity",
                f"digest sidecar {sidecar.name} has no data file", worker))
            continue
        try:
            # the ONE sidecar contract (train/checkpoint.py) — the
            # checker must verify what the writer actually promises
            verify_artifact(data_file)
        except CheckpointCorruptError as e:
            out.append(Violation(
                "checkpoint_integrity", str(e), worker))
    pointer = logdir / "checkpoint.json"
    if pointer.exists():
        try:
            d = json.loads(pointer.read_text())
            target = logdir / d["latest_path"]
        except (json.JSONDecodeError, KeyError, TypeError) as e:
            out.append(Violation(
                "checkpoint_integrity",
                f"checkpoint.json unreadable ({e})", worker))
        else:
            if not target.exists():
                out.append(Violation(
                    "checkpoint_integrity",
                    f"pointer names {target.name} which does not exist",
                    worker))
    return out


# ---------------------------------------------------------------------------
# (3) exact-resume determinism
# ---------------------------------------------------------------------------

def determinism_verdict(logdir: str | Path, reference_dir: str | Path,
                        worker: int | None = None,
                        reference_digest: tuple[str, int] | None = None,
                        reference_opt_digest: tuple[str, int] | None = None,
                        ) -> tuple[bool, list[Violation]]:
    """Invariant (3): the worker's final checkpoint params AND
    optimizer state must be BITWISE equal to the fault-free same-seed
    reference run's. The opt-state half compares the artifact's
    canonical-layout ``momentum`` subtree (train/checkpoint.py
    ``checkpoint_opt_state_digest``) — covered, not skipped, when the
    run sharded its weight update (ZeRO-1), because checkpoints always
    store the logical layout.

    Returns ``(checked, violations)``. The comparison only applies to a
    FULLY recovered worker — one whose latest loadable checkpoint
    reached the reference's final step; a worker left behind (exhausted
    restart budget, or a latest checkpoint the injector deliberately
    tore and nothing ever re-saved) yields ``checked=False`` rather
    than a comparison against a further-along reference."""
    from ..train.checkpoint import (CheckpointCorruptError,
                                    checkpoint_state_digests)
    try:
        if reference_digest is not None:
            ref, ref_opt = reference_digest, reference_opt_digest
        else:
            both = checkpoint_state_digests(reference_dir)
            ref, ref_opt = ((None, None) if both is None else
                            ((both[0], both[2]), (both[1], both[2])))
    except CheckpointCorruptError as e:
        return True, [Violation(
            "determinism", f"reference checkpoint unreadable: {e}", worker)]
    if ref is None:
        # the payload writes no real checkpoints (shell smoke runs):
        # there is no bitwise claim to make — skipped, not violated
        return False, []
    try:
        both = checkpoint_state_digests(logdir)  # ONE artifact read
    except CheckpointCorruptError:
        return False, []  # torn latest, never re-saved: not recovered
    if both is None or both[2] != ref[1]:
        return False, []  # never reached the reference step
    got_params, got_opt, at_step = both
    out: list[Violation] = []
    if got_params != ref[0]:
        out.append(Violation(
            "determinism",
            f"final params at step {at_step} differ bitwise from the "
            f"fault-free reference ({got_params[:12]}… != {ref[0][:12]}…)",
            worker))
    if ref_opt is not None and got_opt != ref_opt[0]:
        out.append(Violation(
            "determinism",
            f"optimizer state at step {at_step} differs bitwise from "
            f"the fault-free reference ({got_opt[:12]}… != "
            f"{ref_opt[0][:12]}…)", worker))
    return True, out


# ---------------------------------------------------------------------------
# (6) cross-world resume (elastic reconfigure)
# ---------------------------------------------------------------------------

def check_reconfigure(trial_dir: str | Path, outcome: dict,
                      journal_records: list[dict]
                      ) -> tuple[list[Violation], bool, set[int],
                                 dict[int, int]]:
    """Invariant (6) over the artifacts alone. Returns
    ``(violations, applicable, grown_workers, relaunch_counts)`` —
    ``applicable`` False when the run neither reshaped nor claims to
    have (verdict: skipped); ``grown_workers`` are ids whose logdirs
    were seeded mid-run (their metric series may start mid-run);
    ``relaunch_counts`` maps worker → number of journaled reconfigure
    relaunches that respawned it (each one licenses a log rewind).

    The causal-license rule: the launch world is ``outcome
    ["num_workers"]``; the final world is what the backend's
    ``state.json`` artifact shows. A difference with NO journaled
    ``event: "reconfigure"`` record fails — a run that silently
    changed shape must not replay green. When reconfigure events DO
    exist, the last journaled reshape must land on the world the
    artifacts show."""
    trial_dir = Path(trial_dir)
    reconf = [r for r in journal_records
              if r.get("event") == schema.RECONFIGURE]
    reshapes = [r for r in reconf if r.get("action") == "reshape"]
    relaunches = [r for r in reconf if r.get("action") == "relaunched"]
    grown = {int(k) for r in reshapes for k in (r.get("grown") or {})}
    relaunch_counts: dict[int, int] = {}
    for r in (relaunches or reshapes):
        for k in r.get("workers", []):
            relaunch_counts[k] = relaunch_counts.get(k, 0) + 1

    final_ids: list[int] | None = None
    state_path = trial_dir / "state.json"
    if state_path.exists():
        try:
            st = json.loads(state_path.read_text())
            final_ids = sorted(int(w["worker"])
                               for w in st.get("workers", []))
        except (json.JSONDecodeError, KeyError, TypeError, ValueError):
            final_ids = None
    initial = outcome.get("num_workers")

    out: list[Violation] = []
    world_changed = (final_ids is not None and initial is not None
                     and len(final_ids) != initial)
    if world_changed and not reconf:
        out.append(Violation(
            "reconfigure",
            f"world changed {initial} -> {len(final_ids)} workers "
            f"(roster {final_ids}) with no journaled reconfigure event "
            "— no causal license for the resize"))
    if reshapes and final_ids is not None:
        last = sorted(int(k) for k in reshapes[-1].get("workers", []))
        if last and last != final_ids:
            out.append(Violation(
                "reconfigure",
                f"journaled reconfigure lands on roster {last} but the "
                f"artifacts show {final_ids} — the journal and the "
                "cluster state disagree about the final world"))
    # a trial that claims a final world must match the artifact too
    claimed = outcome.get("final_world")
    if (claimed is not None and final_ids is not None
            and claimed != len(final_ids)):
        out.append(Violation(
            "reconfigure",
            f"outcome claims final_world={claimed} but state.json shows "
            f"{len(final_ids)} workers"))
    applicable = bool(reconf) or world_changed
    return out, applicable, grown, relaunch_counts


# ---------------------------------------------------------------------------
# (11) autoscale: every roster change in a brokered run is licensed
# ---------------------------------------------------------------------------

def check_autoscale(outcome: dict, journal_records: list[dict]
                    ) -> tuple[list[Violation], bool]:
    """Invariant (11), replayed from the journal alone. Returns
    ``(violations, applicable)`` — not applicable (verdict: skipped)
    for runs with no broker and no autoscale records.

    The causal-license rule, same discipline as invariant 6: a
    brokered run's roster may only change because a recorded signal
    crossed its recorded threshold. Three claims:

    * every ``autoscale begin`` carries a license that actually holds
      — ``value op threshold`` must be true of the numbers the broker
      itself journaled (a begin whose own evidence contradicts it is
      a fabricated license);
    * decisions are single-flight and closed: each begin is followed
      by its ``complete`` or ``error`` before the next begin (the
      broker's cooldown-from-settlement discipline), and no begin is
      left dangling at the end of the run;
    * every cluster ``reshape`` in a brokered run is consumed against
      a preceding unconsumed license — an ``autoscale begin`` or a
      supervisor ``reconfigure begin`` (fault-path reshapes keep
      their own license) — and a reshape consuming an autoscale
      license must land on the world that begin declared
      (``new_serve + new_train``). Silent scaling fails replay.
    """
    recs = [r for r in journal_records
            if r.get("event") == schema.AUTOSCALE]
    applicable = bool(recs) or bool(outcome.get("broker"))
    out: list[Violation] = []
    if not applicable:
        return out, False

    open_begin: dict | None = None
    for r in recs:
        action = r.get("action")
        if action == "begin":
            v, thr, op = r.get("value"), r.get("threshold"), r.get("op")
            if not (isinstance(v, (int, float))
                    and isinstance(thr, (int, float))
                    and op in (">=", "<=")):
                out.append(Violation(
                    "autoscale",
                    f"autoscale begin ({r.get('decision')}) with a "
                    f"malformed license: value={v!r} op={op!r} "
                    f"threshold={thr!r}"))
            elif not (v >= thr if op == ">=" else v <= thr):
                out.append(Violation(
                    "autoscale",
                    f"autoscale begin ({r.get('decision')}) licensed by "
                    f"{r.get('trigger')}={v} {op} {thr}, which does not "
                    "hold — the recorded signal never crossed the "
                    "recorded threshold"))
            if open_begin is not None:
                out.append(Violation(
                    "autoscale",
                    "overlapping autoscale decisions: a second begin "
                    f"({r.get('decision')}) before the previous one "
                    f"({open_begin.get('decision')}) completed — the "
                    "broker is single-flight by construction"))
            open_begin = r
        elif action in ("complete", "error"):
            open_begin = None
    if open_begin is not None:
        out.append(Violation(
            "autoscale",
            f"autoscale begin ({open_begin.get('decision')}) never "
            "closed by a complete or error record"))

    # license-consumption walk over the whole journal, in order
    licenses: list[dict | None] = []  # None = supervisor reconfigure
    for r in journal_records:
        ev, action = r.get("event"), r.get("action")
        if ev == schema.AUTOSCALE and action == "begin":
            licenses.append(r)
        elif (ev == schema.RECONFIGURE and action == "begin"
                and r.get("layer") == "supervisor"):
            licenses.append(None)
        elif ev == schema.RECONFIGURE and action == "reshape":
            if not licenses:
                out.append(Violation(
                    "autoscale",
                    f"roster reshape {r.get('old_world')} -> "
                    f"{r.get('new_world')} with no preceding autoscale "
                    "or reconfigure begin — an unlicensed roster change "
                    "in a brokered run"))
                continue
            lic = licenses.pop()
            if lic is not None:
                want = lic.get("new_serve", 0) + lic.get("new_train", 0)
                got_world = r.get("new_world")
                if isinstance(got_world, int) and got_world != want:
                    out.append(Violation(
                        "autoscale",
                        f"reshape lands on world {got_world} but its "
                        f"licensing autoscale begin declared "
                        f"{lic.get('new_serve')} serving + "
                        f"{lic.get('new_train')} train = {want}"))
    return out, True


# ---------------------------------------------------------------------------
# (12) discipline: every adaptive-controller parameter change licensed
# ---------------------------------------------------------------------------

def check_discipline(steps: list[dict], log_records: list[dict],
                     worker: int | None = None
                     ) -> tuple[list[Violation], bool]:
    """Invariant (12) over one worker's train log. Returns
    ``(violations, applicable)`` — not applicable (verdict: skipped)
    when the log carries neither discipline events nor per-step
    discipline observations (controller never armed).

    The causal-license rule, same discipline as invariants 6/11, with
    the step series itself as the observation channel: adaptive mode
    stamps every step record with the ``[k, timeout_ms]`` pair in force
    (obsv/schema.py STEP optional), so a parameter change is OBSERVED
    as two adjacent spliced step records disagreeing. Three claims:

    * every ``discipline begin`` carries a license that actually holds
      — ``value op threshold`` re-checked with the emitter's OWN
      predicate (train/discipline.py ``threshold_holds``), so a begin
      whose recorded CDF signal never crossed the recorded mark is a
      fabricated license;
    * episodes are single-flight and closed: begin → its ``complete``
      (agreeing on the new pair) before the next begin, none dangling,
      and each complete's ``effective_step`` is exactly the step after
      its begin's ``at_step`` — the epoch boundary;
    * every OBSERVED pair change in the spliced step series is consumed
      against a licensed complete naming that exact boundary and pair
      — a doctored step record (or a deleted begin) fails replay.

    Rollback tolerance: the series is spliced first (the invariant-2
    view), and a licensed change whose boundary step was superseded by
    a rewind simply goes unconsumed — licenses are permissions, not
    obligations."""
    from ..train.discipline import threshold_holds
    disc = [r for r in log_records
            if r.get("event") == schema.DISCIPLINE]
    observed = [r for r in steps if "discipline" in r]
    applicable = bool(disc) or bool(observed)
    out: list[Violation] = []
    if not applicable:
        return out, False

    # -- license validity + single-flight pairing ----------------------
    completes: list[dict] = []
    open_begin: dict | None = None
    for r in disc:
        action = r.get("action")
        if action == "begin":
            v, thr, op = r.get("value"), r.get("threshold"), r.get("op")
            if not (isinstance(v, (int, float))
                    and isinstance(thr, (int, float))
                    and op in (">=", "<=")):
                out.append(Violation(
                    "discipline",
                    f"discipline begin ({r.get('decision')}) with a "
                    f"malformed license: value={v!r} op={op!r} "
                    f"threshold={thr!r}", worker))
            elif not threshold_holds(v, op, thr):
                out.append(Violation(
                    "discipline",
                    f"discipline begin ({r.get('decision')}) licensed "
                    f"by {r.get('trigger')}={v} {op} {thr}, which does "
                    "not hold — the recorded CDF signal never crossed "
                    "the recorded percentile mark", worker))
            if open_begin is not None:
                out.append(Violation(
                    "discipline",
                    "overlapping discipline decisions: a second begin "
                    f"({r.get('decision')}) before the previous one "
                    f"({open_begin.get('decision')}) completed — the "
                    "controller is single-flight by construction",
                    worker))
            open_begin = r
        elif action == "complete":
            if open_begin is None:
                out.append(Violation(
                    "discipline",
                    f"discipline complete ({r.get('decision')}) with no "
                    "open begin — an unlicensed change record", worker))
            else:
                b = open_begin
                if (r.get("k") != b.get("new_k")
                        or r.get("timeout_ms") != b.get("new_timeout_ms")):
                    out.append(Violation(
                        "discipline",
                        f"discipline complete lands on (k={r.get('k')}, "
                        f"timeout_ms={r.get('timeout_ms')}) but its "
                        f"begin declared (k={b.get('new_k')}, "
                        f"timeout_ms={b.get('new_timeout_ms')})", worker))
                at, eff = b.get("at_step"), r.get("effective_step")
                if (isinstance(at, int) and isinstance(eff, int)
                        and eff != at + 1):
                    out.append(Violation(
                        "discipline",
                        f"discipline epoch boundary mismatch: begin at "
                        f"step {at} but complete claims effective_step "
                        f"{eff} (must be {at + 1})", worker))
            completes.append(r)
            open_begin = None
    if open_begin is not None:
        out.append(Violation(
            "discipline",
            f"discipline begin ({open_begin.get('decision')}) never "
            "closed by a complete record", worker))

    # -- observed-change consumption over the spliced series -----------
    spliced, _ = splice_rollbacks(observed)
    licenses = list(completes)  # consumed in order
    prev: dict | None = None
    for rec in spliced:
        pair = rec.get("discipline")
        if prev is not None and pair != prev.get("discipline"):
            lic = None
            while licenses:
                cand = licenses.pop(0)
                if cand.get("effective_step") == rec.get("step"):
                    lic = cand
                    break
                # boundary superseded by a rewind (or predates this
                # span): an unconsumed permission, not a violation
            want = (None if lic is None else
                    [float(lic.get("k", -1)),
                     float(lic.get("timeout_ms", -1))])
            got = ([float(x) for x in pair]
                   if isinstance(pair, (list, tuple)) else pair)
            if lic is None:
                out.append(Violation(
                    "discipline",
                    f"step {rec.get('step')} observed a discipline "
                    f"change {prev.get('discipline')} -> {pair} with no "
                    "licensing complete at that boundary — an "
                    "unlicensed parameter change", worker))
            elif got != want:
                out.append(Violation(
                    "discipline",
                    f"step {rec.get('step')} observed discipline {got} "
                    f"but the licensing complete declared {want}",
                    worker))
        prev = rec
    return out, True


# ---------------------------------------------------------------------------
# (7-9) serving invariants (the online inference tier under chaos)
# ---------------------------------------------------------------------------

_SERVE_CKPT_STEP = None  # lazy import of the checkpoint name regex


def _ckpt_name_step(name: str) -> int | None:
    global _SERVE_CKPT_STEP
    if _SERVE_CKPT_STEP is None:
        import re
        _SERVE_CKPT_STEP = re.compile(r"^ckpt-(\d+)")
    m = _SERVE_CKPT_STEP.match(name)
    return int(m.group(1)) if m else None


def check_serving(trial_dir: str | Path, outcome: dict,
                  journal_records: list[dict]
                  ) -> tuple[list[Violation], bool, set[int], bool]:
    """The serving invariants, replayed from artifacts alone.
    Returns ``(violations, applicable, serve_workers,
    decode_applicable)`` — not applicable (all verdicts: skipped) for
    trials with no serving tier; ``decode_applicable`` True only when
    some replica's journal shows the decode workload (the
    ``decode_swap`` invariant is skipped otherwise).

    * **serve_outcomes** — every request the load generator issued has
      EXACTLY one terminal outcome (response or typed reject/error; no
      silent drops), and on every serving replica the admitted-request
      count equals the admitted-terminal count — except on replicas
      the run faulted or restarted (a SIGKILLed replica's in-flight
      admissions legitimately died with it; the CLIENT side still had
      to reach a terminal outcome for those requests via failover).
    * **serve_digest** — no weight swap installed a checkpoint AFTER
      the injector journaled tearing that step's artifact: digest
      verification (plus fallback-to-previous-loadable) must have
      skipped it. Swaps predating the tear served the then-intact
      bytes and are correct. Covers the quantized ``.quant`` sidecar
      tiers too: a swap that records which artifact it read
      (``source_artifact``) is matched against the torn target by
      NAME — a replica that served the intact fp32 artifact after
      only the sidecar was torn (or vice versa) is digest
      verification working, not a violation; legacy swaps without the
      field keep the historical step-based match.
    * **serve_monotone** — each replica's journaled ``weight_swap``
      step series is monotone non-decreasing (across restarts too: the
      publisher's steps only advance).
    * **decode_swap** — swap-during-generation bookkeeping (decode
      replicas, invariant 10): a sequence that finishes on a model
      step other than the one it started on (``decode_finish``'s
      ``model_step`` vs ``started_step``) must hold a journaled
      ``seq_restart`` license for that id — the restart policy's
      re-prefill — and every ``seq_restart``'s target step must be
      licensed by an earlier journaled ``weight_swap`` to that step.
      Under the pin policy no sequence ever changes step mid-flight,
      so any unlicensed drift is a replica serving mixed weights —
      the silent-corruption mode this invariant exists to catch.
    """
    trial_dir = Path(trial_dir)
    serve_workers = {int(k) for k in (outcome.get("serve_workers") or [])}
    if not serve_workers:
        # artifact-only replay: a serving replica is a worker dir with
        # a serve journal
        serve_workers = {k for k, d in _worker_dirs(trial_dir).items()
                        if (d / "serve_log.jsonl").exists()}
    loadgen = trial_dir / "loadgen.jsonl"
    applicable = bool(serve_workers) or loadgen.exists()
    if not applicable:
        return [], False, set(), False
    out: list[Violation] = []
    decode_applicable = False

    # ---- (a) client side: issued ↔ exactly-one-terminal ----------------
    load_records = load_jsonl(loadgen, schema.LOAD)
    issued: dict[Any, int] = {}
    terminal: dict[Any, int] = {}
    for r in load_records:
        if r.get("action") == "issue":
            issued[r.get("id")] = issued.get(r.get("id"), 0) + 1
        elif r.get("action") == "outcome":
            terminal[r.get("id")] = terminal.get(r.get("id"), 0) + 1
    dropped = [i for i, n in issued.items() if terminal.get(i, 0) < n]
    doubled = [i for i, n in terminal.items() if n > issued.get(i, 0)]
    if dropped:
        out.append(Violation(
            "serve_outcomes",
            f"{len(dropped)} issued request(s) never reached a terminal "
            f"outcome (silent drop), e.g. ids {sorted(dropped)[:5]}"))
    if doubled:
        out.append(Violation(
            "serve_outcomes",
            f"request ids with more terminal outcomes than issues: "
            f"{sorted(doubled)[:5]} — the load journal lies"))

    # workers the run faulted/killed/restarted: their in-flight
    # admissions may legitimately have died server-side. Network
    # faults license too: the ``net_*`` actions (launch/netchaos.py
    # proxies) journal the PROXIED replica as ``worker``, so a replica
    # whose link was reset/partitioned/blackholed mid-request is
    # exempt from the admit↔terminal books the same way a SIGKILLed
    # one is — the client still owes every request a terminal.
    exempt: set[int] = set()
    for r in journal_records:
        if r.get("event") == schema.FAULT and isinstance(r.get("worker"), int):
            exempt.add(r["worker"])
        if (r.get("event") == schema.RECOVERY and r.get("action") == "restart"
                and isinstance(r.get("worker"), int)):
            exempt.add(r["worker"])

    corrupt_faults = [
        r for r in journal_records
        if r.get("event") == schema.FAULT
        and r.get("action") == "corrupt_latest_checkpoint"
        and r.get("target")]

    workers = _worker_dirs(trial_dir)
    for k in sorted(serve_workers):
        d = workers.get(k)
        if d is None:
            continue
        recs = load_jsonl(d / "serve_log.jsonl", schema.SERVE)
        if not recs:
            out.append(Violation(
                "serve_outcomes", "serving replica left no serve journal "
                "at all", k))
            continue
        # ---- (a) server side: admits ↔ admitted terminals ------------
        # (a classification replica's terminal is "respond", a decode
        # replica's is "decode_finish" — both close an admit)
        admits = sum(1 for r in recs if r.get("action") == "admit")
        responds = sum(1 for r in recs
                       if r.get("action") in ("respond", "decode_finish"))
        admitted_rejects = sum(1 for r in recs
                               if r.get("action") == "reject"
                               and r.get("admitted"))
        if k not in exempt and admits != responds + admitted_rejects:
            out.append(Violation(
                "serve_outcomes",
                f"{admits} admitted request(s) but "
                f"{responds + admitted_rejects} admitted-terminal "
                "outcome(s) on an unfaulted replica — admitted work "
                "vanished without a response or a typed reject", k))
        # ---- (b) never serve a torn publish --------------------------
        swaps = [r for r in recs if r.get("action") == "weight_swap"]
        for sw in swaps:
            step = sw.get("step")
            at = sw.get("time", sw.get("ts"))
            src = sw.get("source_artifact")
            for f in corrupt_faults:
                torn_name = str(f["target"])
                torn_step = _ckpt_name_step(torn_name)
                f_at = f.get("ts", f.get("time"))
                if src is not None and src != torn_name:
                    # the swap names the artifact it read and it is
                    # NOT the torn one (e.g. the intact quant sidecar
                    # while the fp32 artifact was torn) — different
                    # bytes, different digest, no claim violated
                    continue
                if not (torn_step is not None and step == torn_step
                        and isinstance(at, (int, float))
                        and isinstance(f_at, (int, float))):
                    continue
                # the flip is a batch boundary AFTER the read: judge
                # by when the READ began (time − swap_ms), not when
                # the reference flipped — bytes read intact before
                # the tear may legitimately install after it. Any
                # swap whose read STARTED after the tear had to pass
                # the digest check on torn bytes: impossible unless
                # verification failed.
                swap_ms = sw.get("swap_ms")
                read_at = (at - swap_ms / 1e3
                           if isinstance(swap_ms, (int, float)) else at)
                if read_at > f_at:
                    out.append(Violation(
                        "serve_digest",
                        f"weight_swap installed step {step} (read began "
                        f"t={read_at:.3f}) AFTER its artifact "
                        f"{f['target']} was torn at t={f_at:.3f} — "
                        "digest verification failed to refuse it", k))
        # ---- (c) served step monotone non-decreasing -----------------
        # Per INCARNATION: the journal is append-mode across restarts,
        # and a restarted replica whose newest publish was torn
        # legitimately boots on the previous loadable step (its
        # ``initial: true`` swap may land BELOW the dead incarnation's
        # last step — that is digest verification working, not a
        # regression). Within an incarnation, backwards is always a
        # violation.
        prev: int | None = None
        for sw in swaps:
            step = sw.get("step")
            if not isinstance(step, int):
                continue
            if sw.get("initial"):
                prev = step  # a fresh incarnation restarts the scan
                continue
            if prev is not None and step < prev:
                out.append(Violation(
                    "serve_monotone",
                    f"served model step went backwards across swaps: "
                    f"{prev} -> {step}", k))
                break
            prev = step
        # ---- (d) swap-during-generation (decode replicas) ------------
        # One ordered pass over the journal: the license must EXIST
        # BEFORE it is used (a seq_restart must follow the weight_swap
        # it targets; a drifted finish must follow ITS OWN sequence's
        # restart), and a license is consumed at the finish — request
        # ids recycle across sweeps in one journal, so a stale restart
        # from an earlier generation must not launder a later one's
        # mixed-weights finish.
        if any(r.get("action") in ("decode_start", "decode_finish",
                                   "seq_restart") for r in recs):
            decode_applicable = True
            seen_swap_steps: set = set()
            licensed_to: dict = {}  # id -> to_step of its live restart
            for r in recs:
                action = r.get("action")
                if action == "weight_swap":
                    seen_swap_steps.add(r.get("step"))
                elif action == "seq_restart":
                    if r.get("to_step") not in seen_swap_steps:
                        out.append(Violation(
                            "decode_swap",
                            f"seq_restart of {r.get('id')!r} targets "
                            f"step {r.get('to_step')} before any "
                            "journaled weight_swap to that step — a "
                            "restart without its causal swap", k))
                    licensed_to[r.get("id")] = r.get("to_step")
                elif action == "decode_finish":
                    st, ms = r.get("started_step"), r.get("model_step")
                    if (isinstance(st, int) and isinstance(ms, int)
                            and st != ms
                            and licensed_to.get(r.get("id")) != ms):
                        out.append(Violation(
                            "decode_swap",
                            f"sequence {r.get('id')!r} finished on "
                            f"model step {ms} but started on {st} with "
                            "no live seq_restart license to that step "
                            "— the replica served mixed weights "
                            "mid-generation", k))
                    licensed_to.pop(r.get("id"), None)
    return out, True, serve_workers, decode_applicable


def check_serve_group(trial_dir: str | Path
                      ) -> tuple[list[Violation], bool]:
    """**serve_group** — die-as-a-unit for tensor-parallel serving
    groups (servesvc/tp_group.py), replayed from ``group_log.jsonl``.

    A TP replica is one process group; a group missing a rank holds
    only part of every sharded weight, so it must NEVER keep (or
    resume) serving half-dead.  The supervisor's journal chain makes
    that checkable: every ``rank_exit`` must be answered by a
    ``group_down`` (all surviving ranks killed) before any later
    ``group_start`` (the unit restart), and restart ``attempt``
    numbers only move forward — a supervisor looping without
    acknowledging teardown is exactly the bug this invariant exists
    to catch.  Applicable only to workers that left a group journal;
    returns ``(violations, applicable)``."""
    trial_dir = Path(trial_dir)
    out: list[Violation] = []
    applicable = False
    for k, d in sorted(_worker_dirs(trial_dir).items()):
        glog = d / "group_log.jsonl"
        if not glog.exists():
            continue
        applicable = True
        recs = load_jsonl(glog, schema.SERVE)
        pending_exit: Any = None   # rank of an unanswered rank_exit
        started = False
        last_attempt = -1
        for r in recs:
            a = r.get("action")
            if a == "group_start":
                if pending_exit is not None:
                    out.append(Violation(
                        "serve_group",
                        f"group restarted after rank {pending_exit} "
                        "exited with no group_down in between — a "
                        "half-dead TP group was never torn down as a "
                        "unit", k))
                    pending_exit = None
                att = r.get("attempt")
                if isinstance(att, int):
                    if started and att <= last_attempt:
                        out.append(Violation(
                            "serve_group",
                            f"group_start attempt went backwards "
                            f"({last_attempt} -> {att}) — the restart "
                            "budget scan is meaningless", k))
                    last_attempt = att
                started = True
            elif a == "rank_exit":
                pending_exit = r.get("rank")
            elif a == "group_down":
                pending_exit = None
        if pending_exit is not None:
            out.append(Violation(
                "serve_group",
                f"rank {pending_exit} exited and no group_down ever "
                "followed — the group may have kept serving with a "
                "missing shard", k))
    return out, applicable


# ---------------------------------------------------------------------------
# (13) net_faults: exactly-once outcomes under retry amplification
# ---------------------------------------------------------------------------

def check_net_faults(trial_dir: str | Path, outcome: dict,
                     journal_records: list[dict]
                     ) -> tuple[list[Violation], bool]:
    """Invariant (13), replayed from artifacts alone. Returns
    ``(violations, applicable)`` — not applicable (verdict: skipped)
    when the trial shows no network-fault evidence at all: no
    journaled ``net_*`` fault, no ``dedup_hit`` in any serve journal,
    and no retried client terminal.

    Network faults (launch/netchaos.py) make requests ARRIVE more
    than once — a mid-stream reset or partition forces the client to
    retry an id on a sibling, or on the same replica after its
    connection died. The hardened protocol's claim is exactly-once
    OUTCOMES, not exactly-once arrivals, and this invariant holds the
    books to it:

    * **exactly one client terminal per issue, globally** — retry
      amplification (``attempts`` > 1) must never surface as a second
      terminal outcome for one id; the failover loop returns one.
    * **duplicate admits are licensed** — a request id admitted more
      than once across the roster (double execution) is legal only
      when the client journaled a retry for that id or a ``net_*``
      fault was journaled against one of the replicas involved;
      an unlicensed duplicate admit is the server double-executing a
      request nobody resent.
    * **dedup hits are honest** — a ``dedup_hit`` record must FOLLOW
      a completed terminal (``respond``/``decode_finish``) for that
      id on the same replica, in journal order: both server paths
      journal the terminal before populating the cache (the journal
      lock serializes the writes), so a hit with no prior terminal is
      a cache returning an outcome it never computed.
    """
    trial_dir = Path(trial_dir)
    net_faults = [r for r in journal_records
                  if r.get("event") == schema.FAULT
                  and str(r.get("action", "")).startswith("net_")]
    net_faulted = {r["worker"] for r in net_faults
                   if isinstance(r.get("worker"), int)}

    # client side: per-id issue/terminal books + retry licenses
    load_records = load_jsonl(trial_dir / "loadgen.jsonl", schema.LOAD)
    issued: dict[Any, int] = {}
    terminal: dict[Any, int] = {}
    retried_ids: set = set()
    for r in load_records:
        if r.get("action") == "issue":
            issued[r.get("id")] = issued.get(r.get("id"), 0) + 1
        elif r.get("action") == "outcome":
            terminal[r.get("id")] = terminal.get(r.get("id"), 0) + 1
            attempts = r.get("attempts")
            if r.get("retried") or (isinstance(attempts, int)
                                    and attempts > 1):
                retried_ids.add(r.get("id"))

    # server side: admits per id across the roster + dedup honesty
    out: list[Violation] = []
    admits_by_id: dict[Any, list[int]] = {}
    dedup_hits = 0
    for k, d in sorted(_worker_dirs(trial_dir).items()):
        recs = load_jsonl(d / "serve_log.jsonl", schema.SERVE)
        completed: set = set()  # ids with a terminal SO FAR, in order
        for r in recs:
            action = r.get("action")
            if action == "admit":
                admits_by_id.setdefault(r.get("id"), []).append(k)
            elif action in ("respond", "decode_finish"):
                completed.add(r.get("id"))
            elif action == "dedup_hit":
                dedup_hits += 1
                if r.get("id") not in completed:
                    out.append(Violation(
                        "net_faults",
                        f"dedup_hit for id {r.get('id')!r} with no "
                        "earlier completed terminal for that id on this "
                        "replica — the cache returned an outcome it "
                        "never computed", k))

    applicable = bool(net_faults) or dedup_hits > 0 or bool(retried_ids)
    if not applicable:
        return [], False

    for i in sorted(issued, key=str):
        if terminal.get(i, 0) > issued[i]:
            out.append(Violation(
                "net_faults",
                f"request id {i!r} issued {issued[i]}x but reached "
                f"{terminal[i]} terminal outcomes — retry amplification "
                "leaked a duplicate terminal to the client"))
    for i, ks in sorted(admits_by_id.items(), key=str):
        if len(ks) <= 1 or i in retried_ids:
            continue
        if any(k in net_faulted for k in ks):
            continue
        out.append(Violation(
            "net_faults",
            f"request id {i!r} admitted {len(ks)}x (replicas "
            f"{sorted(set(ks))}) with no journaled retry or net fault "
            "licensing the duplicate — an unlicensed double execution"))
    return out, True


# ---------------------------------------------------------------------------
# (14) storage-fault licensing + atomic-save protocol ordering
# ---------------------------------------------------------------------------

# injector actions that surface to the writer as an OSError — the only
# firings that can license a skipped cadence save (train/storage.py)
_DISK_ERROR_ACTIONS = ("disk_enospc", "disk_eio", "disk_torn_write")
# injector actions that leave CORRUPT bytes behind (a torn prefix, a
# power-cut rename) — the only firings that can license a restore
# walking past a checkpoint, and the targets invariant (5) must exempt
_DISK_CORRUPT_ACTIONS = ("disk_torn_write", "disk_crash_rename")


def load_storage_faults(trial_dir: str | Path) -> dict[int, list[dict]]:
    """{worker: [fault records]} from each worker's own
    ``storage_faults.jsonl`` — the disk injector journals from INSIDE
    the faulted process (train/storage.py), so its evidence lives next
    to the worker's checkpoints, not in the supervisor's command
    journal. Keyed by the logdir's worker id (the injector stamps the
    same id on every record)."""
    out: dict[int, list[dict]] = {}
    for k, d in _worker_dirs(Path(trial_dir)).items():
        recs = load_jsonl(d / "storage_faults.jsonl", schema.FAULT)
        if recs:
            out[k] = recs
    return out


def storage_exempt_targets(storage_faults: dict[int, list[dict]]
                           ) -> dict[int, set[str]]:
    """{worker: {artifact names}} the disk injector journaled as
    deliberately corrupted (torn prefix / power-cut rename) — exempt
    from invariant (5), same standing as the supervisor's
    ``corrupt_latest_checkpoint`` targets."""
    out: dict[int, set[str]] = {}
    for k, recs in storage_faults.items():
        for r in recs:
            if (r.get("action") in _DISK_CORRUPT_ACTIONS
                    and r.get("path")):
                out.setdefault(k, set()).add(r["path"])
    return out


def check_storage_faults(trial_dir: str | Path,
                         journal_records: list[dict],
                         worker_events: dict[int, list[dict]] | None = None,
                         storage_faults: dict[int, list[dict]] | None = None
                         ) -> tuple[list[Violation], bool]:
    """Invariant (14), replayed from artifacts alone. Returns
    ``(violations, applicable)`` — not applicable (verdict: skipped)
    when the trial shows no storage-fault evidence at all: no
    journaled ``disk_*`` firing in any worker's storage_faults.jsonl
    and no ``save_failed`` in any recovery journal.

    Disk faults (train/storage.py) make durable writes FAIL or LIE —
    a full disk mid-checkpoint, a write that lands only a prefix, a
    rename whose data never hit the platter. The storage shim's claim
    is graceful degradation plus crash consistency, and this invariant
    holds the books to it:

    * **every skipped save is licensed** — a ``save_failed`` record
      (the trainer journaling that it SKIPPED a cadence save and kept
      training) is legal only when that worker's injector journaled an
      error-surfacing firing (ENOSPC / EIO / torn write); an
      unlicensed save_failed is real storage damage nobody injected.
    * **every fallback is licensed** — a worker whose restore walked
      past a corrupt checkpoint (``corrupt_checkpoint_fallback`` /
      ``fallback_restore``) must show an injected corruption for that
      worker: a supervisor ``corrupt_latest_checkpoint`` firing or an
      injector torn-write/crash-rename firing. Unlicensed corruption
      at restore time means bytes rotted with no fault scripted.
    * **no resumable bytes without a landed digest** — the atomic-save
      protocol orders data → digest → pointer, so the pointer must
      never name a single-file artifact whose digest sidecar is
      missing, UNLESS a journaled process kill or disk firing explains
      the gap (a crash between the digest unlink and rewrite of a
      re-saved step is the one legal path to a pointed digest-less
      file). A clean-run pointer past a missing digest is the
      protocol writing the pointer early.
    """
    trial_dir = Path(trial_dir)
    workers = _worker_dirs(trial_dir)
    if storage_faults is None:
        storage_faults = load_storage_faults(trial_dir)
    if worker_events is None:
        worker_events = {k: load_jsonl(d / "recovery_journal.jsonl",
                                       schema.RECOVERY)
                         for k, d in workers.items()}

    fired_actions: dict[int, set[str]] = {
        k: {str(r.get("action", "")) for r in recs}
        for k, recs in storage_faults.items()}
    save_failures: dict[int, int] = {}
    for k, events in worker_events.items():
        n = sum(1 for r in events if r.get("action") == "save_failed")
        if n:
            save_failures[k] = n

    applicable = bool(storage_faults) or bool(save_failures)
    if not applicable:
        return [], False

    out: list[Violation] = []
    # supervisor-injected corruption and process kills also license
    # what a restore finds (the training arm's corrupt+kill pairing)
    sup_corrupted: set[int] = set()
    killed: set[int] = set()
    for r in journal_records:
        if r.get("event") != schema.FAULT:
            continue
        if (r.get("action") == "corrupt_latest_checkpoint"
                and isinstance(r.get("worker"), int)):
            sup_corrupted.add(r["worker"])
        elif (r.get("action") == "kill_worker"
                and isinstance(r.get("worker"), int)):
            killed.add(r["worker"])

    for k, n in sorted(save_failures.items()):
        errors = fired_actions.get(k, set()) & set(_DISK_ERROR_ACTIONS)
        if not errors:
            out.append(Violation(
                "storage_faults",
                f"{n} save_failed record(s) with no error-surfacing "
                "disk firing journaled by this worker's injector — a "
                "skipped cadence save nobody's fault plan licensed", k))

    for k, events in sorted(worker_events.items()):
        hit_corruption = any(
            r.get("action") in ("corrupt_checkpoint_fallback",
                                "fallback_restore")
            for r in events)
        if not hit_corruption:
            continue
        licensed = (k in sup_corrupted
                    or bool(fired_actions.get(k, set())
                            & set(_DISK_CORRUPT_ACTIONS)))
        if not licensed:
            out.append(Violation(
                "storage_faults",
                "restore fell back past a corrupt checkpoint with no "
                "injected corruption (supervisor corrupt fault or "
                "injector torn-write/crash-rename) journaled for this "
                "worker", k))

    for k, d in sorted(workers.items()):
        pointer = d / "checkpoint.json"
        if not pointer.exists():
            continue
        try:
            latest = json.loads(pointer.read_text()).get("latest_path", "")
        except (json.JSONDecodeError, AttributeError):
            continue  # unreadable pointers are invariant (5)'s problem
        if not str(latest).endswith(".msgpack"):
            continue  # sharded saves point at a manifest (embedded
            # checksum), not a digest-sidecar'd single file
        target = d / str(latest)
        sidecar = target.with_suffix(target.suffix + ".sha256")
        if target.exists() and not sidecar.exists():
            if k in killed or k in fired_actions:
                continue  # a crash/fault can legally land between the
                # digest unlink and rewrite of a re-saved step
            out.append(Violation(
                "storage_faults",
                f"pointer names {target.name} whose digest sidecar "
                "never landed, with no journaled kill or disk firing "
                "to explain it — the save protocol published the "
                "pointer before the digest", k))
    return out, True


# ---------------------------------------------------------------------------
# whole-run replay
# ---------------------------------------------------------------------------

def _worker_dirs(trial_dir: Path) -> dict[int, Path]:
    out = {}
    for d in sorted(trial_dir.glob("worker*")):
        if d.is_dir() and d.name[len("worker"):].isdigit():
            out[int(d.name[len("worker"):])] = d
    return out


def corruption_exempt_targets(journal_records: list[dict]
                              ) -> dict[int, set[str]]:
    """{worker: {artifact names}} the fault injector journaled as
    deliberately torn — exempt from invariant (5)."""
    out: dict[int, set[str]] = {}
    for r in journal_records:
        if (r.get("event") == schema.FAULT
                and r.get("action") == "corrupt_latest_checkpoint"
                and r.get("target")):
            out.setdefault(r.get("worker", -1), set()).add(r["target"])
    return out


def check_run(trial_dir: str | Path, outcome: dict | None = None,
              reference_dir: str | Path | None = None) -> dict[str, Any]:
    """Replay one trial's artifact set and verify all five invariants.

    ``trial_dir`` is a LocalProcessCluster root: ``worker<k>/`` logdirs
    plus ``command_journal.jsonl``; the campaign also leaves
    ``outcome.json`` (trial metadata) there, or the caller passes
    ``outcome`` directly. Returns ``{"verdicts": {invariant:
    pass|fail|skipped}, "violations": [...], "workers": [...]}``.
    """
    trial_dir = Path(trial_dir)
    if outcome is None:
        opath = trial_dir / "outcome.json"
        outcome = (json.loads(opath.read_text()) if opath.exists() else {})
    if reference_dir is None and outcome.get("reference_dir"):
        reference_dir = outcome["reference_dir"]

    journal_all = load_jsonl(trial_dir / "command_journal.jsonl")
    recovery = [r for r in journal_all if r.get("event") == schema.RECOVERY]
    workers = _worker_dirs(trial_dir)
    worker_events = {k: load_jsonl(d / "recovery_journal.jsonl",
                                   schema.RECOVERY)
                     for k, d in workers.items()}
    exempt = corruption_exempt_targets(journal_all)
    # artifacts the workers' own disk injectors journaled as torn
    # (train/storage.py) carry the same exemption standing as the
    # supervisor's corrupt_latest_checkpoint targets
    storage_faults = load_storage_faults(trial_dir)
    for k, names in storage_exempt_targets(storage_faults).items():
        exempt.setdefault(k, set()).update(names)

    violations: list[Violation] = []
    skipped: set[str] = set()

    # the reference checkpoint is immutable once its run completed:
    # digest it ONCE per check, not once per worker
    ref_digest: tuple[str, int] | None = None
    ref_opt_digest: tuple[str, int] | None = None
    if reference_dir is not None:
        from ..train.checkpoint import (CheckpointCorruptError,
                                        checkpoint_state_digests)
        try:
            both = checkpoint_state_digests(reference_dir)
            if both is not None:
                ref_digest = (both[0], both[2])
                ref_opt_digest = (both[1], both[2])
        except CheckpointCorruptError as e:
            violations.append(Violation(
                "determinism", f"reference checkpoint unreadable: {e}"))
        if ref_digest is None:
            reference_dir = None  # nothing to compare against → skip

    violations += check_terminal_state(outcome, recovery)
    violations += check_causality(recovery, worker_events)
    reconf_violations, reconf_applicable, grown, relaunch_counts = \
        check_reconfigure(trial_dir, outcome, journal_all)
    violations += reconf_violations
    if not reconf_applicable:
        skipped.add("reconfigure")
    serve_violations, serving_applicable, serve_workers, \
        decode_applicable = check_serving(trial_dir, outcome, journal_all)
    violations += serve_violations
    if not serving_applicable:
        skipped.update(("serve_outcomes", "serve_digest",
                        "serve_monotone"))
    if not decode_applicable:
        # only trials whose replicas ran the decode workload make the
        # swap-during-generation claim
        skipped.add("decode_swap")
    group_violations, group_applicable = check_serve_group(trial_dir)
    violations += group_violations
    if not group_applicable:
        # only trials that booted a TP serving process group (a worker
        # left a group_log.jsonl) make the die-as-a-unit claim
        skipped.add("serve_group")
    autoscale_violations, autoscale_applicable = check_autoscale(
        outcome, journal_all)
    violations += autoscale_violations
    if not autoscale_applicable:
        skipped.add("autoscale")
    net_violations, net_applicable = check_net_faults(
        trial_dir, outcome, journal_all)
    violations += net_violations
    if not net_applicable:
        # only trials with network-fault evidence (a journaled net_*
        # fault, a dedup hit, or a retried terminal) make the
        # exactly-once-under-retry claim
        skipped.add("net_faults")
    storage_violations, storage_applicable = check_storage_faults(
        trial_dir, journal_all, worker_events=worker_events,
        storage_faults=storage_faults)
    violations += storage_violations
    if not storage_applicable:
        # only trials with storage-fault evidence (a journaled disk_*
        # firing or a save_failed) make the crash-consistency claim
        skipped.add("storage_faults")

    restarts_by_worker: dict[int, int] = {}
    for r in recovery:
        if r.get("action") == "restart" and "worker" in r:
            restarts_by_worker[r["worker"]] = (
                restarts_by_worker.get(r["worker"], 0) + 1)

    # invariant (3) under the adaptive controller is epoch-spliced:
    # bitwise WITHIN a discipline epoch, causal ACROSS them. With only
    # terminal digests as artifacts, the comparable case is identical
    # epoch histories (the seeded-synthetic contract: same decisions →
    # same series → bitwise must hold end-to-end); a trial whose
    # licensed trace diverged from the reference's has no common final
    # epoch to compare, so its digest check is spliced out — the
    # discipline invariant still holds every change to account.
    from ..train.discipline import discipline_trace
    ref_trace: list = []
    if reference_dir is not None:
        ref_trace = discipline_trace(
            load_jsonl(Path(reference_dir) / "train_log.jsonl"))

    det_checked = 0
    det_spliced = 0
    disc_applicable = False
    for k, d in sorted(workers.items()):
        if k in serve_workers:
            # serving replicas have no train series or checkpoints —
            # their artifacts are replayed by check_serving above
            continue
        full_log = load_jsonl(d / "train_log.jsonl")
        # the trainer stamps event:"step"; minimal payloads (chaos
        # shell smoke, the reference's own tools) may write bare
        # {"step": N, ...} records — both are the metrics series
        steps = [r for r in full_log
                 if isinstance(r.get("step"), int)
                 and r.get("event", schema.STEP) == schema.STEP]
        disc_violations, disc_app = check_discipline(
            steps, full_log, worker=k)
        violations += disc_violations
        disc_applicable = disc_applicable or disc_app
        if k in grown and not steps:
            # a grown worker that never produced a step before
            # teardown has nothing to splice — its resume evidence is
            # the reconfigure journal, not a log. Its SEEDED checkpoint
            # dir still gets the integrity check: a source file copied
            # while torn is exactly what invariant 5 exists to catch.
            violations += check_checkpoint_dir(d, exempt.get(k, set()),
                                               worker=k)
            continue
        allowed = (restarts_by_worker.get(k, 0)
                   + relaunch_counts.get(k, 0)
                   + sum(1 for r in worker_events.get(k, [])
                         if r.get("action") in ("nan_rollback",
                                                "fallback_restore")))
        violations += check_metrics_log(
            steps, allowed_rewinds=allowed, worker=k,
            # a grown worker's logdir was seeded mid-run: its series
            # legitimately starts at the seed checkpoint's step
            expect_first_step=None if k in grown else 1)
        violations += check_checkpoint_dir(d, exempt.get(k, set()), worker=k)
        if reference_dir is not None:
            if discipline_trace(full_log) != ref_trace:
                # divergent epoch history: the bitwise claim stops at
                # the first differing boundary, before the terminal
                # digest — splice this worker out, causality above
                # remains the binding check
                det_spliced += 1
                continue
            checked, det_violations = determinism_verdict(
                d, reference_dir, worker=k, reference_digest=ref_digest,
                reference_opt_digest=ref_opt_digest)
            violations += det_violations
            det_checked += checked
    if reference_dir is None:
        skipped.add("determinism")
    elif det_checked == 0:
        # every worker was left short of the reference step — nothing
        # was "fully recovered", so the bitwise claim has no subject
        # (or every worker was epoch-spliced out)
        skipped.add("determinism")
    if not disc_applicable:
        skipped.add("discipline")

    failed = {v.invariant for v in violations}
    verdicts = {inv: ("fail" if inv in failed
                      else "skipped" if inv in skipped else "pass")
                for inv in INVARIANTS}
    return {"verdicts": verdicts,
            "violations": [v.to_dict() for v in violations],
            "workers": sorted(workers),
            "determinism_workers_checked": det_checked,
            "determinism_workers_spliced": det_spliced}


# ---------------------------------------------------------------------------
# schedule shrinking (used by launch/chaos.py; lives here so the
# reduction is defined next to the predicate it minimizes against)
# ---------------------------------------------------------------------------

def shrink_faults(faults: tuple, still_fails: Callable[[tuple], bool],
                  max_probes: int = 32) -> tuple[tuple, int]:
    """Greedy one-at-a-time reduction: repeatedly try dropping each
    fault; keep any drop under which the violation persists
    (``still_fails(candidate)`` True). Returns (minimal fault tuple,
    probes spent). The classic ddmin endgame without the partitioning
    prelude — chaos schedules are small (a handful of faults), so the
    linear pass converges in O(n²) probes worst-case, bounded by
    ``max_probes``."""
    current = tuple(faults)
    probes = 0
    changed = True
    while changed and len(current) > 1 and probes < max_probes:
        changed = False
        for i in range(len(current)):
            cand = current[:i] + current[i + 1:]
            probes += 1
            if still_fails(cand):
                current = cand
                changed = True
                break
            if probes >= max_probes:
                break
    return current, probes
