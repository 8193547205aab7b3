"""Post-run invariant checking (≙ ``distributedmnist_tpu/obsv/
invariants.py``): is a run, replayed from its ARTIFACTS ALONE — the
train log, the recovery and serve journals, the checkpoint dir — a
correct run? This module holds the checkers a single run gives input
for:

* **metrics_log** (:func:`check_metrics_log`) — the step series is
  gap-free and duplicate-free after rollback splicing
  (:func:`splice_rollbacks`), and every rewind is explained by a
  journaled recovery event;
* **checkpoint_integrity** (:func:`check_checkpoint_dir`) — every
  digest sidecar verifies (``train/checkpoint.py verify_artifact``) and
  the pointer resolves;
* **determinism** (:func:`determinism_verdict`) — a run's final params
  and optimizer state bitwise equal to a same-seed reference run's;
* **discipline** (:func:`check_discipline`) — every change of the
  adaptive controller (``train/discipline.py``) is licensed, closed,
  and observed at its epoch boundary;
* the serving invariants (:func:`check_serving`): one terminal outcome
  a request, never a torn publish, monotone served steps, licensed
  swaps mid-generation;
* **storage_faults** (:func:`check_storage_faults`) — every skipped
  save and every fallback past a corrupt checkpoint licensed by an
  injected disk fault, no pointer past a missing digest.

A trial directory holds ``worker<k>/`` logdirs (a run's ``train_dir``
under ``worker0``). The cluster checkers (terminal state, causality,
reconfigure, autoscale, network faults, serve groups) and the whole-run
``check_run`` are not ported yet: the port writes no cluster trial
directories. The event vocabulary is the one ``obsv/schema.py``
declares, so reader and writer cannot drift.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any

from . import schema
from .report import load_jsonl

INVARIANTS = ("metrics_log", "determinism", "checkpoint_integrity",
              "serve_outcomes", "serve_digest", "serve_monotone",
              "decode_swap", "discipline", "storage_faults")


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


def _worker_dirs(trial_dir: Path) -> dict[int, Path]:
    out = {}
    for d in sorted(trial_dir.glob("worker*")):
        if d.is_dir() and d.name[len("worker"):].isdigit():
            out[int(d.name[len("worker"):])] = d
    return out
