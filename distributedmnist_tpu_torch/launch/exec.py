"""Command execution engine beneath the cluster backends (≙
``distributedmnist_tpu/launch/exec.py``, copied whole). ONE executor
owns the subprocess boundary for the whole launch layer and gives every
command:

* a per-command **timeout** (a hung command must not hang the driver),
* bounded **retry with exponential backoff + jitter** on transient
  failures (nonzero rc / timeout),
* a structured **JSONL command journal** (argv, rc, duration_ms,
  attempt, stdout/stderr tails) so a run leaves auditable evidence of
  exactly what executed — the artifact ``obsv.journal`` summarizes,
* a **fault-injection seam** (:class:`FaultPlan`) so the failure
  handling above is *testable* with real subprocesses: fail the first
  n attempts of a verb, delay a command class, kill, hang, stall or
  corrupt a worker mid-run, script disk faults into a worker's durable
  writes (the backup-workers regime of arXiv:1604.00981, applied to
  the control plane).

Dry-run records argv without executing.
"""

from __future__ import annotations

import dataclasses
import json
import random
import shlex
import subprocess
import time
from pathlib import Path
from typing import Sequence

from ..core.log import JsonlSink, get_logger, text_tail

logger = get_logger("exec")


class ExecError(RuntimeError):
    """A command could not be executed or exhausted its attempt budget."""


class BinaryNotFoundError(ExecError):
    """argv[0] is not on PATH — permanent, never retried. A distinct
    type so callers can tell a missing CLI from a command whose stderr
    merely contains the words "not found" (e.g. a gcloud NOT_FOUND
    resource error)."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with jitter.

    Delay before retry ``k`` (1-based count of failures so far) is
    ``min(max_backoff_s, backoff_s * multiplier**(k-1))`` scaled by a
    uniform jitter in ``[1-jitter_frac, 1+jitter_frac]`` — jitter so N
    workers retrying the same flaked control-plane verb do not
    re-stampede it in lockstep.
    """

    max_attempts: int = 3
    backoff_s: float = 0.25
    multiplier: float = 2.0
    max_backoff_s: float = 8.0
    jitter_frac: float = 0.25
    seed: int | None = None  # deterministic jitter for tests

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")

    def delay_s(self, failures: int, rng: random.Random) -> float:
        base = min(self.max_backoff_s,
                   self.backoff_s * self.multiplier ** (failures - 1))
        if self.jitter_frac <= 0:
            return base
        return base * (1.0 + self.jitter_frac * (2.0 * rng.random() - 1.0))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative fault injection, wired through the executor and the
    local backend (≙ the failure regime of arXiv:1604.00981 — dead and
    slow workers — applied to the execution layer).

    ``fail_first``         {verb: n}   — synthesize a failure for the
                                         first n attempts of ``verb``
                                         (tests retry/backoff recovery)
    ``delay_ms``           {verb: ms}  — sleep before every execution
                                         of ``verb`` (straggler class)
    ``kill_worker_at_step`` {k: s}     — LocalProcessCluster kills
                                         worker ``k`` once a poll
                                         observes ITS OWN log at step
                                         >= ``s`` (mid-run worker loss;
                                         per-worker logs skew by whole
                                         boot times, so triggers key on
                                         the target worker)
    ``hang_worker_at_step`` {k: s}     — SIGSTOP worker ``k`` once its
                                         log reaches step >= ``s``: the
                                         pid stays alive but the run
                                         stalls (the hung-worker half
                                         of the failure regime —
                                         liveness probes alone cannot
                                         see it)
    ``corrupt_latest_checkpoint_at_step`` {k: s} — once worker ``k``'s
                                         log reaches step >= ``s``,
                                         truncate the latest checkpoint
                                         artifact in its logdir (a torn
                                         write at the worst moment: a
                                         restarted worker must fall
                                         back to the previous loadable
                                         step)
    ``stall_worker_for_ms_at_step`` {k: [s, ms]} — SIGSTOP worker ``k``
                                         at its step >= ``s`` and
                                         SIGCONT it ``ms`` later: a
                                         TRANSIENT straggler that
                                         recovers on its own, unlike
                                         the permanent hang — the
                                         restart-vs-wait race against a
                                         supervisor's stall timeout is
                                         only testable with this one
    ``resize_world_at_step`` [s, m]    — once the SUPERVISED run
                                         observes step >= ``s``, the
                                         supervisor reconfigures the
                                         cluster to ``m`` workers (the
                                         elastic shrink/grow fault —
                                         cluster-level, executed by
                                         ``ClusterSupervisor``, not the
                                         backend's poll hook)
    ``net_faults`` {k: [script, …]}    — transport faults against the
                                         serving replica on worker
                                         ``k``, executed by the chaos
                                         proxy (``launch/netchaos.py``)
                                         interposed on its endpoint:
                                         each script is a dict with a
                                         ``kind`` in {latency,
                                         bandwidth, reset, blackhole,
                                         partition} plus kind-specific
                                         knobs (see ``ChaosProxy``)
    ``disk_faults`` {k: [script, …]}   — storage faults inside worker
                                         ``k``'s own durable-write path
                                         (``train/storage.py``, armed
                                         via the ``DMT_DISK_FAULTS``
                                         env the backend threads into
                                         the worker): each script is a
                                         dict with a ``kind`` in
                                         {enospc_after_bytes, eio,
                                         slow_io_ms,
                                         torn_write_at_byte,
                                         crash_rename} plus
                                         kind-specific knobs (see
                                         ``DiskFaultInjector``);
                                         firings land in the worker's
                                         ``storage_faults.jsonl``

    Every action fires at most once per worker per run.
    """

    fail_first: dict[str, int] = dataclasses.field(default_factory=dict)
    delay_ms: dict[str, float] = dataclasses.field(default_factory=dict)
    kill_worker_at_step: dict[int, int] = dataclasses.field(
        default_factory=dict)
    hang_worker_at_step: dict[int, int] = dataclasses.field(
        default_factory=dict)
    corrupt_latest_checkpoint_at_step: dict[int, int] = dataclasses.field(
        default_factory=dict)
    # {worker: (trigger_step, stall_duration_ms)}
    stall_worker_for_ms_at_step: dict[int, tuple[int, float]] = \
        dataclasses.field(default_factory=dict)
    # (trigger_step, new_world) — None = no resize fault armed
    resize_world_at_step: tuple[int, int] | None = None
    # {worker: [net fault scripts]} — consumed by netchaos.ChaosProxy
    net_faults: dict[int, list[dict]] = dataclasses.field(
        default_factory=dict)
    # {worker: [disk fault scripts]} — armed inside the worker process
    # by train/storage.py (the backend serializes each worker's list
    # into its DMT_DISK_FAULTS environment)
    disk_faults: dict[int, list[dict]] = dataclasses.field(
        default_factory=dict)

    _WORKER_KEYED = ("kill_worker_at_step", "hang_worker_at_step",
                     "corrupt_latest_checkpoint_at_step")

    @classmethod
    def from_file(cls, path: str | Path) -> "FaultPlan":
        return cls.from_json_dict(json.loads(Path(path).read_text()))

    @classmethod
    def from_json_dict(cls, d: dict) -> "FaultPlan":
        d = dict(d)
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ExecError(f"unknown fault plan keys: {sorted(unknown)}")
        # JSON object keys are strings; worker indices are ints
        for key in cls._WORKER_KEYED:
            if key in d:
                d[key] = {int(k): int(v) for k, v in d[key].items()}
        if "stall_worker_for_ms_at_step" in d:
            d["stall_worker_for_ms_at_step"] = {
                int(k): (int(v[0]), float(v[1]))
                for k, v in d["stall_worker_for_ms_at_step"].items()}
        if d.get("resize_world_at_step") is not None:
            v = d["resize_world_at_step"]
            d["resize_world_at_step"] = (int(v[0]), int(v[1]))
        if "net_faults" in d:
            d["net_faults"] = {int(k): [dict(s) for s in v]
                               for k, v in d["net_faults"].items()}
        if "disk_faults" in d:
            d["disk_faults"] = {int(k): [dict(s) for s in v]
                                for k, v in d["disk_faults"].items()}
        return cls(**d)

    def to_json_dict(self) -> dict:
        """The file-format view (string keys, lists for tuples) — what
        ``from_file`` reads back; empty actions omitted. The chaos
        engine emits shrunk reproducers through this."""
        out: dict = {}
        for f in dataclasses.fields(self):
            val = getattr(self, f.name)
            if not val:
                continue
            if isinstance(val, dict):
                out[f.name] = {str(k): (list(v) if isinstance(v, tuple)
                                        else v) for k, v in val.items()}
            else:
                out[f.name] = list(val) if isinstance(val, tuple) else val
        return out

    def should_fail(self, verb: str, attempt: int) -> bool:
        return attempt <= self.fail_first.get(verb, 0)

    def command_delay_s(self, verb: str) -> float:
        return self.delay_ms.get(verb, 0.0) / 1e3


@dataclasses.dataclass
class ExecResult:
    """Outcome of one :meth:`CommandExecutor.run` call (final attempt)."""

    argv: list[str]
    returncode: int | None       # None ⇔ the attempt timed out
    duration_ms: float
    attempts: int
    stdout: str | None
    stderr: str | None
    timed_out: bool = False
    injected: bool = False       # failure synthesized by the FaultPlan

    @property
    def ok(self) -> bool:
        return self.returncode == 0 and not self.timed_out


class CommandExecutor:
    """Runs argv lists with timeout / retry / journal / fault seams.

    One instance per cluster action sequence; every attempt of every
    command appends one JSONL record to ``journal`` (a path or an open
    :class:`JsonlSink`), so the artifact alone reconstructs what ran.
    """

    def __init__(self, journal: str | Path | JsonlSink | None = None,
                 retry: RetryPolicy | None = None,
                 timeout_s: float | None = None,
                 fault_plan: FaultPlan | None = None,
                 dry_run: bool = False,
                 sleep=time.sleep):
        self.retry = retry or RetryPolicy()
        self.timeout_s = timeout_s
        self.fault_plan = fault_plan or FaultPlan()
        self.dry_run = dry_run
        self.recorded: list[list[str]] = []
        self._sleep = sleep
        self._rng = random.Random(self.retry.seed)
        self._own_journal = not isinstance(journal, JsonlSink)
        self._journal: JsonlSink | None = (
            journal if isinstance(journal, JsonlSink)
            else JsonlSink(journal) if journal is not None else None)

    @property
    def journal_path(self) -> Path | None:
        return self._journal.path if self._journal else None

    def close(self) -> None:
        if self._journal is not None and self._own_journal:
            self._journal.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def journal(self, record: dict) -> None:
        """Append a non-command record (spawn, fault, lifecycle marker)
        to the same journal the commands land in."""
        if self._journal is not None:
            self._journal.write(record)

    _log = journal

    # ------------------------------------------------------------------

    def run(self, argv: Sequence[str], *, verb: str | None = None,
            check: bool = True, capture: bool = True,
            timeout_s: float | None = None,
            max_attempts: int | None = None,
            cwd: str | Path | None = None,
            env: dict[str, str] | None = None) -> ExecResult | None:
        """Execute ``argv``; retry transient failures within the budget.

        ``verb`` names the command class for the journal and the fault
        plan (defaults to ``argv[0]``). Transient = nonzero rc or
        timeout; a missing binary is permanent and raises immediately.
        Returns the final :class:`ExecResult`, or None under dry-run
        (argv recorded + journaled). ``check=True`` raises
        :class:`ExecError` when the final attempt still failed.
        """
        argv = [str(a) for a in argv]
        verb = verb or argv[0]
        timeout_s = self.timeout_s if timeout_s is None else timeout_s
        budget = max_attempts or self.retry.max_attempts
        self.recorded.append(argv)
        if self.dry_run:
            logger.info("DRY-RUN: %s", shlex.join(argv))
            self._log({"event": "command", "verb": verb, "argv": argv,
                       "dry_run": True})
            return None

        last: ExecResult | None = None
        for attempt in range(1, budget + 1):
            delay_s = self.fault_plan.command_delay_s(verb)
            if delay_s > 0:
                self._sleep(delay_s)
            t0 = time.perf_counter()
            if self.fault_plan.should_fail(verb, attempt):
                res = ExecResult(argv=argv, returncode=1,
                                 duration_ms=0.0, attempts=attempt,
                                 stdout="", injected=True,
                                 stderr=f"fault-injected failure "
                                        f"(verb={verb!r} attempt={attempt})")
            else:
                try:
                    cp = subprocess.run(argv, text=True,
                                        capture_output=capture,
                                        timeout=timeout_s,
                                        cwd=cwd, env=env)
                    res = ExecResult(
                        argv=argv, returncode=cp.returncode,
                        duration_ms=(time.perf_counter() - t0) * 1e3,
                        attempts=attempt, stdout=cp.stdout,
                        stderr=cp.stderr)
                except subprocess.TimeoutExpired as e:
                    res = ExecResult(
                        argv=argv, returncode=None,
                        duration_ms=(time.perf_counter() - t0) * 1e3,
                        attempts=attempt, timed_out=True,
                        stdout=e.stdout if isinstance(e.stdout, str) else None,
                        stderr=e.stderr if isinstance(e.stderr, str) else None)
                except FileNotFoundError as e:
                    self._log({"event": "command", "verb": verb,
                               "argv": argv, "rc": None, "attempt": attempt,
                               "error": "binary not found"})
                    raise BinaryNotFoundError(
                        f"{argv[0]!r} not found on PATH") from e
            will_retry = (not res.ok) and attempt < budget
            self._log({"event": "command", "verb": verb, "argv": argv,
                       "rc": res.returncode,
                       "duration_ms": round(res.duration_ms, 3),
                       "attempt": attempt, "check": check,
                       "timed_out": res.timed_out,
                       "injected": res.injected,
                       "injected_delay_ms": delay_s * 1e3 or None,
                       "stdout_tail": text_tail(res.stdout),
                       "stderr_tail": text_tail(res.stderr),
                       "will_retry": will_retry})
            if res.ok:
                return res
            last = res
            if will_retry:
                backoff = self.retry.delay_s(attempt, self._rng)
                logger.warning(
                    "command failed (verb=%s rc=%s timed_out=%s) — "
                    "attempt %d/%d, retrying in %.3fs", verb,
                    res.returncode, res.timed_out, attempt, budget, backoff)
                self._sleep(backoff)
        assert last is not None
        if check:
            why = "timed out" if last.timed_out else f"rc={last.returncode}"
            raise ExecError(
                f"command failed after {last.attempts} attempt(s) "
                f"({why}): {shlex.join(argv)}"
                + (f"\nstderr tail: {text_tail(last.stderr, 500)}"
                   if last.stderr else ""))
        return last
