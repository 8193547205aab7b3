"""Journal-event schema registry (≙ ``distributedmnist_tpu/obsv/
schema.py``, copied whole: the port writes the reference's journals, so
it is held to the same contract).

Every journaled event KIND is declared once, with its required fields
(present at every emit site) and optional fields (present at some);
kinds with an ``action`` axis (recovery, serve, …) declare the
per-action payload the same way. :mod:`.journal` and :mod:`.invariants`
project records through :func:`required_fields` and the kind constants
below instead of re-listing field names. :func:`validate_event` checks
a record about to be written; :class:`..core.log.JsonlSink` calls it
behind the ``DMT_VALIDATE_EVENTS`` gate (on in tests, off in production
hot paths).

Readers stay tolerant of LEGACY journals (replaying old artifacts must
never crash); the registry governs what the CURRENT tree is allowed to
WRITE.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping

# -- canonical event-kind names (import these, don't re-spell them) ------
COMMAND = "command"
RECOVERY = "recovery"
RECONFIGURE = "reconfigure"
SERVE = "serve"
STEP = "step"
SAVE = "save"
COMPILE = "compile"
HEARTBEAT = "heartbeat"
LOAD = "load"
FAULT = "fault"
LIFECYCLE = "lifecycle"
SPAWN = "spawn"
CHAOS_TRIAL = "chaos_trial"
EVAL = "eval"
AUTOSCALE = "autoscale"
DISCIPLINE = "discipline"

# Fields any journaled record may carry regardless of kind: the sink
# stamps ``ts``, emitters stamp ``time``, the supervisor stamps ``seed``
# on everything it records, and multi-layer emitters tag ``layer``.
ENVELOPE_FIELDS = ("event", "ts", "time", "seed", "layer")


class EventSchemaError(ValueError):
    """A journaled record violates its declared event schema."""


@dataclasses.dataclass(frozen=True)
class ActionSchema:
    """Payload contract for one ``action`` of an event kind."""

    required: tuple[str, ...] = ()
    optional: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class EventSchema:
    """Payload contract for one event kind.

    ``required``/``optional`` apply to every record of the kind;
    ``actions`` (when the kind has an action axis) adds per-action
    fields on top.  ``open_payload`` marks kinds whose payload is
    legitimately dynamic (e.g. ``compile`` carries whatever the AOT
    cache measured) — unknown keys are allowed, required keys still
    checked."""

    kind: str
    required: tuple[str, ...] = ()
    optional: tuple[str, ...] = ()
    actions: Mapping[str, ActionSchema] | None = None
    open_payload: bool = False


def _act(required: tuple[str, ...] = (),
         optional: tuple[str, ...] = ()) -> ActionSchema:
    return ActionSchema(required=required, optional=optional)


EVENT_SCHEMAS: dict[str, EventSchema] = {}


def _declare(schema: EventSchema) -> None:
    EVENT_SCHEMAS[schema.kind] = schema


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

# launch/exec.py Executor.run / journal: one record per command attempt.
_declare(EventSchema(
    COMMAND,
    required=("verb", "argv"),
    optional=("rc", "duration_ms", "attempt", "check", "timed_out",
              "injected", "injected_delay_ms", "stdout_tail",
              "stderr_tail", "will_retry", "dry_run", "error"),
))

# Recovery episodes: supervisor detect/restart/resume chain
# (launch/supervisor.py), trainer self-healing (train/loop.py), and the
# checkpoint layer's fallback events (train/checkpoint.py,
# parallel/api.py) — all land as ``event: "recovery"`` records in the
# command journal and/or ``recovery_journal.jsonl``.
_declare(EventSchema(
    RECOVERY,
    required=("action",),
    optional=("worker",),
    actions={
        "detect": _act(("worker", "kind"), ("at_step", "stalled_at")),
        "restart_scheduled": _act(("worker", "attempt", "backoff_s")),
        "restart": _act(("worker", "attempt", "at_step", "via"),
                        ("detected_at", "respawn_s")),
        "restart_budget_exhausted": _act(("worker", "restarts"),
                                         ("reason",)),
        "resume": _act(("worker",),
                       ("step", "detected_at", "mttr_s", "respawned_at",
                        "resume_after_respawn_s")),
        "episode_superseded": _act(("worker", "by", "trigger")),
        "target_reached": _act(("step",)),
        "quorum_transition": _act(("workers_alive", "num_workers",
                                   "quorum", "degraded")),
        "below_quorum_abort": _act(("workers_alive", "quorum")),
        "standbys_requested": _act(("count",)),
        "standbys_unavailable": _act(("error",)),
        # trainer self-healing (train/loop.py)
        "nonfinite_loss_detected": _act(("step", "loss")),
        "nan_rollback": _act(("from_step", "to_step", "loss")),
        "rollback_candidate_unusable": _act(("step", "error")),
        "rollback_candidate_poisoned": _act(("step",)),
        "preempt_flush": _act(("signal", "step")),
        # checkpoint layer (train/checkpoint.py, parallel/api.py).
        # ``save_failed`` is the graceful ENOSPC/EIO degradation: a
        # cadence save that still failed after the bounded I/O retries
        # was journaled and SKIPPED (train/loop.py) — the
        # ``storage_faults`` invariant licenses every one against an
        # injected disk fault.
        "save_failed": _act(("step", "error"), ("errno", "where")),
        "follow_skip": _act(("step", "error")),
        "corrupt_checkpoint_fallback": _act(("bad_step", "error")),
        "fallback_restore": _act(("step",)),
        "cross_world_restore": _act(("step", "saved_world",
                                     "new_world")),
    },
))

# Elastic world reshapes — the causal LICENSE the cross-world resume
# invariant requires (launch/supervisor.py begin/relaunched/resume,
# launch/cluster.py reshape).
_declare(EventSchema(
    RECONFIGURE,
    required=("action",),
    actions={
        "begin": _act(("old_world", "new_world", "trigger", "quorum",
                       "effective_quorum", "survivors")),
        "reshape": _act(("old_world", "new_world", "old_workers",
                         "workers", "dropped", "grown")),
        "relaunched": _act(("old_world", "new_world", "trigger",
                            "drain_s", "workers", "via", "grown")),
        "resume": _act(("worker", "step", "old_world", "new_world",
                        "trigger", "reconfigure_s")),
    },
))

# Serving-replica journal (servesvc/server.py serve_log.jsonl).  The
# ``follow_*`` actions are the checkpoint follower's restore events
# re-journaled with their serve-side prefix.  The group lifecycle
# actions (``group_*`` / ``rank_*`` / ``shard_verify``) are the TP
# serving group's journal (servesvc/tp_group.py): the supervisor
# writes them to ``group_log.jsonl`` and follower ranks stamp every
# record with their ``rank`` — hence the top-level optional.
_declare(EventSchema(
    SERVE,
    required=("action",),
    optional=("rank",),
    actions={
        "serve_start": _act(("port", "model_step", "precision_tier",
                             "active_tier", "queue_depth", "max_batch")),
        "serve_stop": _act(("terminals", "model_step", "swaps")),
        "admit": _act(("id", "deadline_ms")),
        "respond": _act(("id", "model_step", "tier", "batch", "bucket",
                         "latency_ms")),
        "reject": _act(("id", "reason", "admitted")),
        # a retried request whose terminal is already cached: the
        # server returns the cached payload WITHOUT re-executing — the
        # exactly-once evidence invariant 13 (net_faults) requires
        "dedup_hit": _act(("id", "status"), ("age_s",)),
        # a connection closed by the read/write deadline or half-open
        # detection BEFORE any admit — no terminal is owed for it
        "conn_abort": _act(("reason",), ("bytes_read", "id")),
        "weight_swap": _act(("step", "from_step", "digest", "tier",
                             "source_artifact", "source_digest",
                             "swap_ms"),
                            ("initial", "sequences_pinned",
                             "sequences_restarted")),
        # -- decode service (servesvc/decode.py) ----------------------
        "decode_start": _act(("slots", "block_size", "num_blocks",
                              "max_prompt_len", "max_new_tokens",
                              "swap_policy", "model_step")),
        "prefill": _act(("id", "prompt_len", "bucket", "blocks",
                         "model_step", "ttft_ms"),
                        ("restart",)),
        "decode_finish": _act(("id", "reason", "tokens_streamed",
                               "model_step", "started_step",
                               "latency_ms"),
                              ("ttft_ms", "restarts")),
        "seq_restart": _act(("id", "from_step", "to_step",
                             "tokens_discarded")),
        "follow_quant_sidecar_fallback": _act(("step", "tier",
                                               "reason")),
        "follow_skip": _act(("step", "error")),
        "follow_corrupt_checkpoint_fallback": _act(("bad_step",
                                                    "error")),
        "follow_fallback_restore": _act(("step",)),
        "follow_cross_world_restore": _act(("step", "saved_world",
                                            "new_world")),
        # -- TP serving group lifecycle (servesvc/tp_group.py) ---------
        # die-as-a-unit is a CHECKED chain: every unexpected
        # ``rank_exit`` must be followed by a ``group_down`` before the
        # next ``group_start`` (the ``serve_group`` invariant) — a TP
        # replica missing a shard must never keep serving.
        "group_start": _act(("ranks", "attempt")),
        "rank_spawn": _act(("rank", "pid")),
        "rank_exit": _act(("rank", "pid", "rc")),
        "group_down": _act(("reason", "ranks"), ("rank",)),
        "group_restart": _act(("attempt", "backoff_s")),
        "group_stop": _act(("ranks",)),
        # follower ranks: sha256 of THIS rank's model-axis param shard
        # per verified publish — the shard-wise hot-swap evidence
        "shard_verify": _act(("rank", "step", "digest"),
                             ("source_digest",)),
    },
))

# Trainer metrics series (train/loop.py train_log.jsonl).  The
# optional ``discipline`` field is the [k, timeout_ms] pair in force
# when the step ran — written only when the adaptive controller is
# armed, and the per-step observation the ``discipline`` replay
# invariant matches licensed changes against.
_declare(EventSchema(
    STEP,
    required=("step", "time", "loss", "train_acc", "lr",
              "updates_applied", "num_contributors", "examples_per_sec",
              "flags"),
    optional=("discipline",),
))

# Checkpoint-save marker.  Deliberately ``at_step``, NOT ``step``: the
# resume watch (launch/cluster.py parse_poll_output) treats any record
# carrying ``step`` as training progress — a save record naming
# ``step`` would fake progress on a stalled worker.  This registry
# entry is what makes that a checked contract instead of lore.
_declare(EventSchema(
    SAVE,
    required=("at_step", "save_stall_ms", "async_snapshot"),
    optional=("quant_tiers",),
))

# Compile record: ``compile_s``/``source`` plus whatever the AOT
# executable cache measured — dynamic by design.
_declare(EventSchema(
    COMPILE,
    optional=("compile_s", "source", "persistent_cache", "error"),
    open_payload=True,
))

# Serving liveness counter (servesvc/server.py, the replica's
# train_log.jsonl — the supervisor's progress probe reads ``step``).
# The optional fields are the replica's live PRESSURE snapshot — queue
# depth at the admission bound, and (decode replicas) KV block-pool
# occupancy — so ``parse_poll_output`` surfaces per-replica pressure to
# the resource broker without a second channel.
_declare(EventSchema(
    HEARTBEAT,
    required=("step",),
    optional=("tp_rank", "queue_depth", "queue_limit", "kv_blocks_free",
              "kv_blocks_total", "kv_blocks_reserved",
              "decode_waiting"),
))

# Load-generator journal (servesvc/loadgen.py loadgen.jsonl): every
# issued request and its exactly-one terminal outcome, plus periodic
# rolling-window pressure snapshots (``window``) — the live signal the
# resource broker (launch/broker.py) scales the roster on.
_declare(EventSchema(
    LOAD,
    required=("action",),
    actions={
        "issue": _act(("id",)),
        "outcome": _act(("id", "status"),
                        ("reason", "model_step", "tier", "attempts",
                         "retried", "endpoint", "latency_ms",
                         # decode sweeps: the two-number latency split
                         "ttft_ms", "itl_ms", "tokens")),
        # rolling-window snapshot over the last ``window_s`` seconds:
        # latency percentiles only when the window saw ok responses
        "window": _act(("window_s", "terminal", "responses",
                        "rejected", "errors", "reject_rate"),
                       ("issued", "p50_ms", "p99_ms", "ttft_p50_ms",
                        "ttft_p99_ms", "throughput_rps", "retried",
                        "retry_rate")),
    },
))

# Fault-injector firings (launch/cluster.py process/disk faults,
# launch/netchaos.py transport faults) — the exemption evidence the
# replay invariants match violations against.  The ``net_*`` actions
# are the chaos proxy's journal: ``worker`` is the PROXIED replica (so
# the serve_outcomes faulted-replica exemption auto-covers it) and
# ``conn`` its per-proxy connection ordinal.
_declare(EventSchema(
    FAULT,
    required=("action", "worker"),
    actions={
        "kill_worker": _act(("pid", "at_step", "planned_step")),
        "hang_worker": _act(("pid", "at_step", "planned_step")),
        "stall_worker": _act(("pid", "stall_ms", "at_step",
                              "planned_step")),
        "corrupt_latest_checkpoint": _act(("at_step", "planned_step"),
                                          ("target", "truncated_to")),
        # -- transport faults (launch/netchaos.py ChaosProxy) ----------
        "net_latency": _act(("delay_ms", "jitter_ms"), ("conn",)),
        "net_bandwidth": _act(("bytes_per_s",), ("conn",)),
        "net_reset": _act(("after_bytes",),
                          ("conn", "bytes_passed", "mid_stream")),
        "net_blackhole": _act(("hold_s",), ("conn",)),
        "net_partition": _act(("start_s", "duration_s"),
                              ("conns_dropped",)),
        # -- storage faults (train/storage.py DiskFaultInjector) -------
        # journaled by the WORKER process into its own
        # storage_faults.jsonl (a worker cannot reach the supervisor's
        # command journal); ``path`` is the durable artifact the op
        # targeted, ``at_step`` the trainer step the injector last saw,
        # ``planned_step`` the script's arming step.
        "disk_enospc": _act(("path", "op"),
                            ("at_step", "planned_step", "budget_bytes")),
        "disk_eio": _act(("path", "op", "nth"),
                         ("at_step", "planned_step")),
        "disk_slow_io": _act(("path", "op", "ms"),
                             ("at_step", "planned_step")),
        "disk_torn_write": _act(("path", "at_byte"),
                                ("at_step", "planned_step", "op")),
        "disk_crash_rename": _act(("path", "kept_bytes"),
                                  ("at_step", "planned_step")),
    },
))

# Cluster-backend bookkeeping markers (launch/cluster.py).
_declare(EventSchema(
    LIFECYCLE,
    required=("action",),
    actions={
        "stale_state": _act(("cluster", "error")),
        "delete": _act(("cluster",)),
        "stale_worker_reaped": _act(("worker", "pid")),
        "standby_reaped": _act(("standby", "pid")),
        "promote_standby": _act(("worker", "standby", "pid")),
        "standby_backfill_failed": _act(("error",)),
    },
))

# Process spawns: a worker slot or a warm standby.
_declare(EventSchema(
    SPAWN,
    required=("pid", "command"),
    optional=("worker", "standby"),
))

# One record per chaos trial (launch/chaos.py chaos_report.jsonl).
_declare(EventSchema(
    CHAOS_TRIAL,
    required=("trial", "seed", "schedule", "described", "outcome",
              "step", "target", "duration_s", "verdicts", "violations"),
    optional=("mttr", "boot_s", "stall_timeout_s", "faults",
              "reconfigures", "final_world", "serving", "serve_swaps",
              "shrunk", "broker", "autoscale", "discipline", "net",
              "disk"),
))

# Continuous evaluator (evalsvc/evaluator.py eval_log.jsonl).
_declare(EventSchema(
    EVAL,
    required=("step", "num_examples", "precision_at_1", "loss",
              "seconds"),
))

# Resource-broker decisions (launch/broker.py) — the causal LICENSE the
# ``autoscale`` replay invariant requires for every roster change in a
# brokered run.  ``begin`` names the signal that crossed its threshold
# (``value op threshold`` must hold, checked at replay), ``complete``
# closes the episode once the new capacity is LIVE and carries the
# detect→capacity-live reaction time.
_declare(EventSchema(
    AUTOSCALE,
    required=("action",),
    actions={
        "begin": _act(("decision", "trigger", "value", "threshold",
                       "op", "old_serve", "new_serve", "old_train",
                       "new_train"),
                      ("window_s", "cooldown_s")),
        "complete": _act(("decision", "trigger", "reaction_s", "serve",
                          "train"),
                         ("worker", "grown", "dropped")),
        "error": _act(("decision", "error")),
    },
))

# Adaptive straggler-discipline changes (train/discipline.py, written
# to the trainer's train_log.jsonl) — the causal LICENSE the
# ``discipline`` replay invariant requires for every runtime change of
# the aggregation parameters.  ``begin`` names the CDF-percentile
# crossing that licensed the change (``value op threshold`` must hold,
# re-checked at replay); ``complete`` closes the episode once the new
# [k, timeout_ms] vector is staged and names the first step it governs
# (``effective_step`` — the discipline-epoch boundary the determinism
# invariant splices at).
_declare(EventSchema(
    DISCIPLINE,
    required=("action",),
    actions={
        "begin": _act(("decision", "trigger", "value", "threshold",
                       "op", "old_k", "new_k", "old_timeout_ms",
                       "new_timeout_ms", "at_step"),
                      ("window_steps", "cooldown_steps", "p50_ms",
                       "p99_ms", "num_replicas")),
        "complete": _act(("decision", "trigger", "reaction_s", "k",
                          "timeout_ms", "effective_step")),
    },
))


# ---------------------------------------------------------------------------
# accessors — what journal.py / invariants.py / the AST pass consume
# ---------------------------------------------------------------------------

def event_kinds() -> tuple[str, ...]:
    return tuple(sorted(EVENT_SCHEMAS))


def schema_for(kind: str) -> EventSchema | None:
    return EVENT_SCHEMAS.get(kind)


def action_schema(kind: str, action: str) -> ActionSchema | None:
    s = EVENT_SCHEMAS.get(kind)
    if s is None or s.actions is None:
        return None
    return s.actions.get(action)


def required_fields(kind: str, action: str | None = None
                    ) -> tuple[str, ...]:
    """The fields every record of ``kind`` (and ``action``, when given)
    is required to carry — payload fields only, envelope excluded.
    Summarizers project records through this instead of keeping their
    own lists."""
    s = EVENT_SCHEMAS.get(kind)
    if s is None:
        raise KeyError(f"unknown journal event kind {kind!r}")
    out = [f for f in s.required if f != "action"]
    if action is not None:
        a = action_schema(kind, action)
        if a is None:
            raise KeyError(f"unknown action {action!r} for journal "
                           f"event kind {kind!r}")
        out += [f for f in a.required if f not in out]
    return tuple(out)


def payload_fields(kind: str, action: str | None = None
                   ) -> tuple[str, ...]:
    """Required + optional payload fields, in declaration order."""
    s = EVENT_SCHEMAS.get(kind)
    if s is None:
        raise KeyError(f"unknown journal event kind {kind!r}")
    out = list(required_fields(kind, action))
    out += [f for f in s.optional if f not in out]
    if action is not None:
        a = action_schema(kind, action)
        if a is not None:
            out += [f for f in a.optional if f not in out]
    return tuple(out)


# ---------------------------------------------------------------------------
# runtime validation
# ---------------------------------------------------------------------------

def validate_event(record: Mapping[str, Any],
                   source: str | None = None) -> list[str]:
    """Check one about-to-be-written record against the registry.

    Returns a list of problem strings (empty = conforming).  Records
    without an ``event`` key are not journal events (sweep-result rows
    share the JSONL sink) and pass vacuously."""
    kind = record.get("event")
    if kind is None:
        return []
    where = f" ({source})" if source else ""
    if not isinstance(kind, str) or kind not in EVENT_SCHEMAS:
        return [f"unknown journal event kind {kind!r}{where} — declare "
                "it in obsv/schema.py"]
    s = EVENT_SCHEMAS[kind]
    problems: list[str] = []
    keys = set(record) - set(ENVELOPE_FIELDS)
    allowed = set(s.required) | set(s.optional)
    for f in s.required:
        if f not in record:
            problems.append(f"event {kind!r}{where} missing required "
                            f"field {f!r}")
    action = record.get("action")
    a: ActionSchema | None = None
    if (s.actions is not None and "action" in record
            and not isinstance(action, str)):
        # a non-string action is exactly the dynamically-built-payload
        # bug this validator exists to catch — never let it pass as
        # "no action to check"
        problems.append(f"event {kind!r}{where} has non-string action "
                        f"{action!r} — actions are declared string "
                        "names (obsv/schema.py)")
    if s.actions is not None and isinstance(action, str):
        a = s.actions.get(action)
        if a is None:
            problems.append(f"event {kind!r}{where} has undeclared "
                            f"action {action!r} — declare it in "
                            "obsv/schema.py")
        else:
            allowed |= set(a.required) | set(a.optional)
            for f in a.required:
                if f not in record:
                    problems.append(
                        f"event {kind!r} action {action!r}{where} "
                        f"missing required field {f!r}")
    # unknown-key check only when the payload is closed AND the allowed
    # set is fully known (no action axis, or the action resolved)
    if not s.open_payload and (s.actions is None or a is not None):
        unknown = sorted(keys - allowed)
        if unknown:
            problems.append(
                f"event {kind!r}"
                + (f" action {action!r}" if action else "")
                + f"{where} carries undeclared field(s) "
                + ", ".join(repr(u) for u in unknown)
                + " — add them to obsv/schema.py or stop writing them")
    return problems


def check_event(record: Mapping[str, Any],
                source: str | None = None) -> None:
    """Raise :class:`EventSchemaError` on a non-conforming record."""
    problems = validate_event(record, source=source)
    if problems:
        raise EventSchemaError("; ".join(problems))


def validation_enabled() -> bool:
    """Debug-mode gate: ``DMT_VALIDATE_EVENTS`` truthy (tests set it;
    production writers skip the per-record check entirely)."""
    return os.environ.get("DMT_VALIDATE_EVENTS", "").lower() in (
        "1", "true", "yes", "on")


def maybe_check_event(record: Mapping[str, Any],
                      source: str | None = None) -> None:
    """The env-gated hook the shared journal-write helpers call."""
    if validation_enabled():
        check_event(record, source=source)
