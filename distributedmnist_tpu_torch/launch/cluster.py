"""Pluggable cluster backends beneath one launcher (≙
``distributedmnist_tpu/launch/cluster.py``).

:class:`ClusterBackend` is the lifecycle contract — create / delete /
status / run_train / kill_all / exec_all / download / poll, plus the
recovery verbs restart_worker and reconfigure — and
:class:`LocalProcessCluster` realizes it as REAL local subprocesses: N
worker processes running the port's ``launch train`` (or, per
worker, another payload: a serving roster's ``launch serve``
replicas), per-worker logdirs, a pgrep-equivalent ``status()`` probe,
file-copy ``download``, warm standbys parked after their
``precompile``. Every
verb executes as an actual subprocess through
:class:`~.exec.CommandExecutor`, so ``create → run → poll --until-step
→ download → delete`` runs end-to-end and leaves a JSONL command
journal.

The workers inherit the card: a worker runs on ``cuda:0`` unless the
config's ``device`` names another (``launch cluster --device cpu``
appends ``--device cpu`` to every payload that runs a port verb), and a
worker that cannot get the card fails — it never trains on the CPU.
The reference's gcloud TPU-VM backend has no counterpart:
``--backend gcloud`` raises.

The module-level :func:`wait_until_step` / :func:`run_until_step`
drivers (launch → poll the log → stop at step N) are generic over
backends.
"""

from __future__ import annotations

import abc
import dataclasses
import json
import os
import shlex
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Any

from ..core.log import get_logger
from ..obsv.journal import tail_records
from .exec import CommandExecutor, FaultPlan, RetryPolicy

logger = get_logger("cluster")

#: what a payload that runs one of the port's verbs names
_PORT_VERB = "distributedmnist_tpu_torch.launch"


class ClusterError(RuntimeError):
    pass


def parse_poll_output(text: str | None) -> dict[str, Any]:
    """Parse the tail of a ``train_log.jsonl`` into {"step", "record"}.

    Scans BACKWARDS (obsv/journal.py ``tail_records``) past a torn/
    non-JSON final line to the last intact STEP record: reporting step
    -1 for a whole poll tick makes live progress look stalled — which
    a supervisor's ``stall_timeout_s`` could misread as a hang. Intact
    non-step records (the ``event: "compile"`` line a precompiling
    worker appends before its first step) are skipped the same way:
    they are liveness, not regression to -1. step is -1 only when no
    step record exists at all (run still booting, or the tail window
    held nothing usable — the next poll resolves it).
    """
    for record in tail_records(text=text or ""):
        if "step" not in record:
            continue  # compile/other event record — not a step reading
        return {"step": int(record["step"]), "record": record}
    return {"step": -1, "record": None}


def worker_logged_since_spawn(worker: dict) -> bool:
    """Has this worker appended to its own train_log.jsonl since its
    CURRENT incarnation spawned? False means it is still booting (a
    restarted worker spends seconds in its boot before its first log
    line).
    ``worker`` is a status()/state entry carrying ``logdir`` and
    ``spawned_at``; an unknown spawn time (pre-``spawned_at`` state
    files) reads as True — the legacy behavior. Shared by the chaos
    drain and the supervisor's reconfigure-resume watch."""
    spawned = worker.get("spawned_at")
    if spawned is None:
        return True
    log = Path(worker["logdir"]) / "train_log.jsonl"
    try:
        return log.stat().st_mtime >= spawned
    except OSError:
        return False  # no log at all yet: definitely still booting


def worker_resumed_step_since_spawn(worker: dict,
                                    events: tuple[str, ...] = ("step",)
                                    ) -> tuple[int, float | None] | None:
    """``(step, record_time)`` proving this worker's CURRENT
    incarnation produced a training step, or None if it has not
    provably resumed. Log mtime moving since the worker's own
    (re)spawn is necessary but NOT sufficient: a restarted trainer
    journals its ``event: "compile"`` record before its first step,
    and an adopted logdir still carries the previous incarnation's
    step records — closing on either would journal a resume with a
    stale step and count a worker that wedged right after boot as
    recovered. Only the newest intact record being a STEP record
    (appended since spawn, so it is this incarnation's) is a
    first-moved-step; its own ``time`` stamp (when the step happened,
    vs when this sweep observed it) is what MTTR-style latencies close
    on. A torn newest line returns None — the next-intact record
    behind it may belong to the previous incarnation; wait a tick.

    ``events``: the record types that count as this payload's progress
    — ``("step",)`` for trainers; a serving payload's progress records
    are ``event: "heartbeat"`` (terminal-outcome count), so its
    callers pass ``("step", "heartbeat")``."""
    if not worker_logged_since_spawn(worker):
        return None
    log = Path(worker["logdir"]) / "train_log.jsonl"
    try:
        with open(log, "rb") as fh:
            fh.seek(0, 2)
            fh.seek(max(0, fh.tell() - 8192))
            lines = fh.read().decode("utf-8", "replace").splitlines()
    except OSError:
        return None
    for ln in reversed(lines):
        if not ln.strip():
            continue
        try:
            rec = json.loads(ln)
        except ValueError:
            return None  # torn newest write — cannot prove resume yet
        if not isinstance(rec, dict):
            return None
        if rec.get("event", "step") not in events:
            return None  # newest intact record: compile, not progress
        step = rec.get("step")
        if not isinstance(step, int):
            return None
        t = rec.get("time")
        return step, (t if isinstance(t, (int, float)) else None)
    return None


class ClusterBackend(abc.ABC):
    """The lifecycle contract every backend realizes (≙ the reference's
    11-subcommand dispatch, tools/tf_ec2.py:828-856, as an interface)."""

    @abc.abstractmethod
    def create(self) -> None: ...

    @abc.abstractmethod
    def delete(self, ignore_missing: bool = False) -> None:
        """Tear the cluster down. ``ignore_missing``: deleting a
        cluster that does not exist is not an error (the
        delete-if-exists step of clean-launch-run)."""

    @abc.abstractmethod
    def status(self) -> dict[str, Any] | None: ...

    @abc.abstractmethod
    def run_train(self) -> None: ...

    @abc.abstractmethod
    def kill_all(self, worker: str = "all") -> None: ...

    @abc.abstractmethod
    def exec_all(self, command: str, worker: str = "all") -> None: ...

    @abc.abstractmethod
    def download(self, local_dir: str | Path,
                 remote_path: str | None = None,
                 worker: str = "0") -> None: ...

    @abc.abstractmethod
    def poll(self) -> dict[str, Any] | None: ...

    # recovery verb (non-abstract so pre-existing backends stay valid):
    # respawn ONE worker's training process in place; the worker's own
    # resume-from-checkpoint logic decides where it continues
    def restart_worker(self, k: int) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} cannot restart individual workers")

    # elastic verb: reshape the cluster's world
    # WITHOUT spawning — the supervisor drains before and relaunches
    # after. Non-abstract: backends without it simply aren't elastic.
    def reconfigure(self, new_num_workers: int,
                    survivors: list[int] | None = None) -> dict[str, Any]:
        raise NotImplementedError(
            f"{type(self).__name__} cannot reconfigure its world size")


# ---------------------------------------------------------------------------
# generic lifecycle drivers (backend-agnostic)
# ---------------------------------------------------------------------------

def wait_until_step(backend: ClusterBackend, target: int,
                    poll_secs: float = 30.0,
                    timeout_secs: float = 24 * 3600.0) -> dict[str, Any]:
    """Block until the cluster's run reaches ``target`` steps
    (≙ benchmark.py's run-until-step-N loop :24-34). Dry-run backends
    record exactly one poll argv and return immediately."""
    deadline = time.monotonic() + timeout_secs
    while True:
        got = backend.poll()
        if got is None:  # dry-run
            return {"step": target, "record": None, "dry_run": True}
        if got["step"] >= target:
            return got
        if got.get("workers_alive") == 0:
            # every worker is gone and the log never reached the target
            # — a crashed cluster must fail now, not at the poll timeout
            # (backends that can't count workers omit the key)
            raise ClusterError(
                f"no live workers and the run stopped at step "
                f"{got['step']} < {target}")
        if time.monotonic() >= deadline:
            raise ClusterError(
                f"run did not reach step {target} within "
                f"{timeout_secs:.0f}s (last seen: {got['step']})")
        logger.info("step %d/%d — next poll in %.0fs",
                    got["step"], target, poll_secs)
        time.sleep(poll_secs)


def run_until_step(backend: ClusterBackend, target: int,
                   poll_secs: float = 30.0,
                   timeout_secs: float = 24 * 3600.0) -> dict[str, Any]:
    """Launch training, follow the log to step ``target``, then stop
    the run — on EVERY exit path: a poll timeout or a Ctrl-C must not
    leave the cluster training (and, on cloud backends, billing)."""
    backend.run_train()
    try:
        return wait_until_step(backend, target, poll_secs, timeout_secs)
    finally:
        backend.kill_all()


# ---------------------------------------------------------------------------
# local process-cluster backend
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LocalClusterConfig:
    """Declarative local cluster description (safe JSON, the
    reference's keys plus ``device``)."""

    name: str = "dmt-local"
    num_workers: int = 2
    workdir: str = "/tmp/dmt_local_cluster"
    setup_command: str = ""
    # runs with cwd = the worker's logdir; `train.train_dir=.` makes the
    # structured log land where status/poll/download expect it
    train_command: str = (
        "python -m distributedmnist_tpu_torch.launch train "
        "train.train_dir=. data.dataset=synthetic data.batch_size=32 "
        "data.synthetic_train_size=256 data.synthetic_test_size=64 "
        "model.compute_dtype=float32 train.max_steps=50 "
        "train.log_every_steps=5 train.save_interval_steps=0")
    # Per-worker payload overrides keyed by STRING worker index (JSON
    # object keys): a mixed cluster — e.g. the serving topology, where
    # worker 0 is the checkpoint PUBLISHER (`launch train`) and
    # workers 1..N are serving replicas (`launch serve` following
    # ../worker0) — under one roster, one supervisor, one fault plan.
    # Workers not named here run train_command. Restarts respawn the
    # worker's OWN command; grown (reconfigure) workers get the
    # default.
    worker_commands: dict[str, str] = dataclasses.field(
        default_factory=dict)
    # Warm standbys: the command a PRE-BOOTED spare process runs — it
    # must honor the DMT_STANDBY_ACTIVATION protocol (boot, precompile,
    # touch <activation>.ready, park until the activation file
    # appears, then adopt the assigned logdir). "" = train_command,
    # which `launch train` realizes natively.
    standby_command: str = ""
    # One SHARED kernel build cache threaded into every worker's env
    # (DMT_COMPILE_CACHE_DIR; the libraries land in <dir>/kernels): a
    # restarted worker loads its predecessor's kernel libraries instead
    # of paying nvcc again. "" = <root>/compile_cache. With
    # compile_cache=false every spawn gets a fresh, EMPTY directory of
    # its own (<root>/cold_compile/...): no directory at all would mean
    # the package's own _build/, which persists across processes and
    # is warm. An explicit DMT_COMPILE_CACHE_DIR in cfg.env still wins.
    compile_cache: bool = True
    compile_cache_dir: str = ""
    env: dict[str, str] = dataclasses.field(default_factory=dict)
    # The torch device every payload that runs a port verb is asked
    # for: "" = the verb's own default (cuda:0, an error without CUDA);
    # "cpu" appends `--device cpu` to each such command.
    device: str = ""

    @classmethod
    def from_file(cls, path: str | Path) -> "LocalClusterConfig":
        d = json.loads(Path(path).read_text())
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ClusterError(f"unknown cluster config keys: "
                               f"{sorted(unknown)}")
        return cls(**d)

    @property
    def root(self) -> Path:
        return Path(self.workdir) / self.name

    def worker_dir(self, k: int) -> Path:
        return self.root / f"worker{k}"

    def standby_dir(self, j: int) -> Path:
        return self.root / f"standby{j}"

    def resolved_compile_cache_dir(self) -> Path | None:
        if not self.compile_cache:
            return None
        return (Path(self.compile_cache_dir) if self.compile_cache_dir
                else self.root / "compile_cache")

    def with_device(self, command: str) -> str:
        """``command`` asked for :attr:`device`: ``--device D`` appended
        when a device is set and the command runs a port verb
        (``distributedmnist_tpu_torch.launch ...``, last in the
        command) and names no device. Other payloads (the shell loops)
        pass unchanged."""
        if (not self.device or _PORT_VERB not in command
                or "--device" in command):
            return command
        return f"{command} --device {shlex.quote(self.device)}"

    def resolved_standby_command(self) -> str:
        return self.with_device(self.standby_command or self.train_command)

    def command_for(self, k: int) -> str:
        return self.with_device(
            self.worker_commands.get(str(k), self.train_command))


class LocalProcessCluster(ClusterBackend):
    """The same lifecycle as real local subprocesses.

    Each worker is an actual detached OS process running
    ``cfg.train_command`` (on the card, or on ``cfg.device``) with cwd
    = its own logdir; every other verb (pgrep-equivalent status probe, tail
    poll, cp -r download, kill delete) executes as a real subprocess
    through the :class:`CommandExecutor`, so the fault plan and the
    command journal apply uniformly. The mock-free test realization of
    the backend contract — and a usable N-process trainer on any box.
    """

    def __init__(self, cfg: LocalClusterConfig,
                 executor: CommandExecutor | None = None):
        self.cfg = cfg
        self.exec = executor or CommandExecutor(
            journal=self.cfg.root / "command_journal.jsonl",
            retry=RetryPolicy(max_attempts=1))
        self._fault_fired: set[tuple[str, int]] = set()

    # -- state file -----------------------------------------------------

    @property
    def state_path(self) -> Path:
        return self.cfg.root / "state.json"

    def _read_state(self) -> dict[str, Any]:
        if self.exec.dry_run:
            # dry-run writes no state file; synthesize the worker list
            # from the config so every verb still records its argv
            return {"phase": "dry-run",
                    "workers": [{"worker": k, "pid": None,
                                 "logdir": str(self.cfg.worker_dir(k))}
                                for k in range(self.cfg.num_workers)]}
        if not self.state_path.exists():
            return {"phase": "absent", "workers": []}
        try:
            state = json.loads(self.state_path.read_text())
        except (json.JSONDecodeError, OSError) as e:
            # a state file garbled by a killed previous run must not
            # wedge every verb behind manual cleanup — treat it as
            # absent (create() rebuilds it) and leave the evidence in
            # the journal
            logger.warning("state file %s unreadable (%s) — treating the "
                           "cluster as absent", self.state_path, e)
            self.exec.journal({"event": "lifecycle", "action": "stale_state",
                               "cluster": self.cfg.name, "error": str(e)})
            return {"phase": "absent", "workers": []}
        if not isinstance(state.get("workers"), list):
            state["workers"] = []
        return state

    def _write_state(self, state: dict[str, Any]) -> None:
        if self.exec.dry_run:
            return  # dry-run records argv only — no on-disk mutation
        self.state_path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.state_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(state, indent=2))
        tmp.replace(self.state_path)

    # -- lifecycle ------------------------------------------------------

    def create(self) -> None:
        dirs = " ".join(shlex.quote(str(self.cfg.worker_dir(k)))
                        for k in range(self.cfg.num_workers))
        self.exec.run(["sh", "-c", f"mkdir -p {dirs}"], verb="create")
        self._write_state({"phase": "created",
                           "workers": [{"worker": k, "pid": None,
                                        "logdir": str(self.cfg.worker_dir(k))}
                                       for k in range(self.cfg.num_workers)]})
        if self.cfg.setup_command:
            self.exec_all(self.cfg.setup_command)

    def delete(self, ignore_missing: bool = False) -> None:
        """Kill every worker, mark the cluster deleted. Logdirs are
        retained (≙ the reference's shutdown, which terminated instances
        but kept the NFS outdir) — a caller wanting a clean slate
        removes ``cfg.root``."""
        self.kill_all()
        state = self._read_state()
        state["phase"] = "deleted"
        self._write_state(state)
        self.exec.journal({"event": "lifecycle", "action": "delete",
                           "cluster": self.cfg.name})

    def _worker_env(self, k: int) -> dict[str, str]:
        """The environment of one worker process: the parent's (the
        card stays visible: nothing forces a platform), the repo root
        first on ``PYTHONPATH``, the kernel build cache, ``cfg.env``,
        the worker's identity and its disk-fault scripts."""
        env = dict(os.environ)
        # workers run with cwd = their logdir, so the default
        # `python -m distributedmnist_tpu_torch...` train command can
        # only resolve this package if its repo root is importable —
        # put it first on PYTHONPATH (a pip-installed copy is
        # unaffected; cfg.env below still overrides)
        repo_root = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = os.pathsep.join(
            [repo_root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                           else []))
        cache = self.cfg.resolved_compile_cache_dir()
        if cache is None and not self.exec.dry_run:
            # compile_cache=false must mean COLD: an inherited cache dir
            # would warm the worker, and no dir at all means the
            # package's own _build/, which persists across processes —
            # so each process gets a fresh empty directory of its own
            cold = self.cfg.root / "cold_compile"
            cold.mkdir(parents=True, exist_ok=True)
            cache = Path(tempfile.mkdtemp(prefix=f"w{k}-", dir=cold))
        if cache is not None:
            # the shared warm-build seam: every worker (and standby) of
            # this cluster reads/writes ONE kernel build cache
            env["DMT_COMPILE_CACHE_DIR"] = str(cache)
        env.update(self.cfg.env)
        env.update({"DMT_WORKER_INDEX": str(k),
                    "DMT_NUM_WORKERS": str(self.cfg.num_workers),
                    "DMT_WORKER_DIR": str(self.cfg.worker_dir(k))})
        # Disk-fault scripts arm INSIDE the worker's own durable-write
        # path (train/storage.py reads this at first shim op); firings
        # land in the worker's storage_faults.jsonl, which the chaos
        # fired-fault count and the storage_faults invariant read.
        # Per-incarnation-safe: a restarted worker re-arms the same
        # deterministic scripts (counters reset with the process).
        scripts = self.exec.fault_plan.disk_faults.get(k)
        if scripts:
            env["DMT_DISK_FAULTS"] = json.dumps({
                "worker": k, "faults": scripts,
                "journal": str(Path(self.cfg.worker_dir(k))
                               / "storage_faults.jsonl")})
        else:
            env.pop("DMT_DISK_FAULTS", None)
        return env

    def _pid_alive(self, pid: int) -> bool:
        probe = self.exec.run(["sh", "-c", f"kill -0 {pid} 2>/dev/null"],
                              verb="status", check=False, max_attempts=1)
        return probe is not None and probe.returncode == 0

    def _spawn_worker(self, w: dict[str, Any]) -> None:
        """Spawn ONE worker process and record its pid in ``w`` (shared
        by the initial ``run_train`` fan-out and per-worker restarts)."""
        k = w["worker"]
        logdir = Path(w["logdir"])
        logdir.mkdir(parents=True, exist_ok=True)
        command = self.cfg.command_for(k)
        log_fh = open(logdir / "train_stdout.log", "ab")
        try:
            proc = subprocess.Popen(
                ["sh", "-c", command],
                cwd=logdir, env=self._worker_env(k),
                stdout=log_fh, stderr=subprocess.STDOUT,
                start_new_session=True)
        finally:
            log_fh.close()  # the child holds its own descriptor
        w["pid"] = proc.pid
        # epoch timestamp of THIS incarnation's spawn: lets consumers
        # (the chaos drain) tell "hasn't logged since its restart —
        # still booting" from "logged, then stalled" by comparing the
        # worker's train_log.jsonl mtime against it
        w["spawned_at"] = time.time()
        self.exec.journal({"event": "spawn", "worker": k, "pid": proc.pid,
                           "command": command})

    def run_train(self) -> None:
        """Spawn one REAL detached process per worker (≙ run_tf's
        nohup-per-host, tf_ec2.py:445) — stdout/stderr to the worker's
        ``train_stdout.log``, pid recorded in the cluster state.

        Pids left in the state file by a previous killed driver are
        reaped first: a re-run over a stale ``state.json`` must neither
        double-spawn against still-live old workers nor require manual
        cleanup. (The reap is a best-effort ``kill -9``; a pid recycled
        by the OS since that run is the accepted local-tool risk.)"""
        state = self._read_state()
        if not state["workers"]:
            raise ClusterError("run_train before create: no workers")
        delay_s = self.exec.fault_plan.command_delay_s("run")
        for w in state["workers"]:
            if self.exec.dry_run:  # record the spawn argv, don't Popen
                self.exec.run(["sh", "-c", self.cfg.command_for(w["worker"])],
                              verb="run")
                continue
            if w.get("pid"):
                if self._pid_alive(w["pid"]):
                    self.exec.journal(
                        {"event": "lifecycle", "action": "stale_worker_reaped",
                         "worker": w["worker"], "pid": w["pid"]})
                self._kill_pid(w["pid"], "kill")
                w["pid"] = None
            if delay_s > 0:
                time.sleep(delay_s)
            self._spawn_worker(w)
        state["phase"] = "running"
        self._write_state(state)

    def restart_worker(self, k: int) -> None:
        """Respawn ONE worker in place (the supervisor's recovery verb):
        best-effort kill of any previous pid, then a fresh spawn of the
        same train command in the same logdir — the worker's own
        resume-from-checkpoint logic decides where it continues."""
        state = self._read_state()
        sel = self._select(state["workers"], str(k))
        if not sel:
            raise ClusterError(f"restart_worker({k}): no such worker")
        w = sel[0]
        if self.exec.dry_run:
            self.exec.run(["sh", "-c", self.cfg.command_for(k)], verb="run")
            return
        if w.get("pid"):
            self._kill_pid(w["pid"], "kill")
        self._spawn_worker(w)
        state["phase"] = "running"
        self._write_state(state)

    def stop_all(self, worker: str = "all") -> None:
        """Graceful drain: SIGTERM the worker process groups. A
        preemption-aware payload (`launch train`,
        train.handle_preemption) finishes its step, flushes a
        checkpoint, and exits resumable — the checkpoint-flush half of
        an elastic reconfigure. Callers bound the wait with
        :meth:`wait_drained` and fall back to :meth:`kill_all` for
        stragglers."""
        state = self._read_state()
        for w in self._select(state["workers"], worker):
            if w.get("pid"):
                pid = w["pid"]
                self.exec.run(
                    ["sh", "-c", f"kill -TERM -{pid} 2>/dev/null || "
                                 f"kill -TERM {pid} 2>/dev/null || true"],
                    verb="stop", check=False)

    def _group_live_count(self, pid: int) -> int:
        """Non-zombie processes still in ``pid``'s process group. The
        recorded pid is the ``sh -c`` LEADER (start_new_session=True
        makes it the pgid) and dash FORKS the payload: on a group
        SIGTERM the leader dies instantly while the python trainer is
        still flushing its preemption checkpoint — ``kill -0 <leader>``
        reads "drained" mid-flush and the straggler SIGKILL would land
        on the half-written save. Group membership is the truth a drain
        must wait on (zombies excluded: an exited-but-unreaped leader
        is not still flushing anything)."""
        probe = self.exec.run(
            ["sh", "-c", f"ps -eo pgid=,stat= | "
                         f"awk '$1 == {pid} && $2 !~ /Z/' | wc -l"],
            verb="status", check=False, max_attempts=1)
        if probe is None or probe.returncode != 0:
            return 0
        try:
            return int((probe.stdout or "").strip())
        except ValueError:
            return 0

    def wait_drained(self, timeout_s: float,
                     poll_secs: float = 0.5) -> bool:
        """Block until every worker's process GROUP has fully exited —
        leader AND all forked descendants — or the deadline passes.
        Returns True when fully drained. This is what makes
        ``stop_all`` → straggler-kill safe: only a group that kept
        members past the deadline eats the SIGKILL."""
        state = self._read_state()
        pids = [w["pid"] for w in state["workers"] if w.get("pid")]
        deadline = time.monotonic() + timeout_s
        while True:
            pids = [p for p in pids if self._group_live_count(p) > 0]
            if not pids:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(poll_secs)

    # -- elastic world-size reconfiguration ------------

    def reconfigure(self, new_num_workers: int,
                    survivors: list[int] | None = None) -> dict[str, Any]:
        """Reshape the roster WITHOUT spawning: shrink keeps the named
        ``survivors`` (logdirs, checkpoints, and worker ids untouched —
        ids need not stay contiguous, every verb iterates the roster),
        grow appends fresh ids whose logdirs are SEEDED with the first
        survivor's newest checkpoint artifacts so the new worker
        resumes at the last loadable step instead of step 0. The
        caller (the supervisor's :meth:`~.supervisor.ClusterSupervisor.
        reconfigure`) drains before and relaunches after; anything not
        surviving is killed here. Journaled as an
        ``event: "reconfigure"`` record — the causal license the
        cross-world resume invariant requires — and returned."""
        if new_num_workers < 1:
            raise ClusterError(
                f"reconfigure to {new_num_workers} workers: a cluster "
                "needs at least one")
        state = self._read_state()
        workers = state["workers"]
        if not workers:
            raise ClusterError("reconfigure before create: no workers")
        old_ids = [w["worker"] for w in workers]
        if survivors is None:
            survivors = old_ids[:new_num_workers]
        keep_set = set(survivors)
        unknown = keep_set - set(old_ids)
        if unknown:
            raise ClusterError(f"reconfigure: unknown survivor ids "
                               f"{sorted(unknown)} (roster: {old_ids})")
        if len(keep_set) > new_num_workers:
            raise ClusterError(
                f"reconfigure: {len(keep_set)} survivors > new world "
                f"{new_num_workers}")
        keep = [w for w in workers if w["worker"] in keep_set]
        dropped = [w for w in workers if w["worker"] not in keep_set]
        for w in dropped:  # nothing outside the new world may keep running
            if w.get("pid"):
                self._kill_pid(w["pid"], "kill")
            w["pid"] = None
        grown: dict[int, int] = {}
        next_id = (max(old_ids) + 1) if old_ids else 0
        seed_from = keep[0]["worker"] if keep else None
        while len(keep) < new_num_workers:
            k = next_id
            next_id += 1
            logdir = self.cfg.worker_dir(k)
            nw = {"worker": k, "pid": None, "logdir": str(logdir)}
            if not self.exec.dry_run:
                logdir.mkdir(parents=True, exist_ok=True)
            if seed_from is not None:
                # seed the grown worker's resume point: the survivor's
                # NEWEST checkpoint artifacts (resolved via the
                # checkpoint.json pointer — copying every retained
                # cadence save would multiply disk per grown worker
                # and leave stale steps as silent fallback candidates);
                # payloads without a pointer (the shell loops' bare
                # `ckpt` file) fall back to the glob
                src = next(w2["logdir"] for w2 in keep
                           if w2["worker"] == seed_from)
                pattern = "ckpt*"
                try:
                    ptr = json.loads(
                        (Path(src) / "checkpoint.json").read_text())
                    step = int(ptr["latest_step"])
                    pattern = f"ckpt-{step:08d}*"
                except (OSError, ValueError, KeyError, TypeError):
                    pass
                self.exec.run(
                    ["sh", "-c",
                     f"cp -p {shlex.quote(src)}/{pattern} "
                     f"{shlex.quote(str(logdir))}/ 2>/dev/null; "
                     f"cp -p {shlex.quote(src)}/checkpoint.json "
                     f"{shlex.quote(str(logdir))}/ 2>/dev/null; true"],
                    verb="reconfigure", check=False)
                grown[k] = seed_from
            keep.append(nw)
        state["workers"] = keep
        self.cfg = dataclasses.replace(self.cfg,
                                       num_workers=new_num_workers)
        self._write_state(state)
        rec = {"event": "reconfigure", "layer": "cluster",
               "action": "reshape",
               "old_world": len(old_ids), "new_world": new_num_workers,
               "old_workers": old_ids,
               "workers": [w["worker"] for w in keep],
               "dropped": [w["worker"] for w in dropped],
               "grown": {str(k): v for k, v in grown.items()}}
        self.exec.journal(rec)
        logger.info("reconfigured cluster %s: %d -> %d workers "
                    "(dropped %s, grown %s)", self.cfg.name, len(old_ids),
                    new_num_workers, rec["dropped"], sorted(grown))
        return rec

    # -- warm standbys ---------------------------------

    def _spawn_standby(self, state: dict[str, Any]) -> dict[str, Any]:
        """Spawn ONE pre-booting spare process: it runs the standby
        command with ``DMT_STANDBY_ACTIVATION`` pointing at its own
        activation file, boots, precompiles, touches
        ``<activation>.ready`` and parks. Returns the standby record
        (appended to ``state["standbys"]``); the caller writes state."""
        slots = state.setdefault("standbys", [])
        # monotonic id from a state-level sequence — NOT max(live slots):
        # a back-fill after a promotion must never reuse a consumed
        # standby's dir, where a stale activation file would instantly
        # (and wrongly) activate the fresh spare onto the old assignment
        j = state.get("standby_seq", 0)
        state["standby_seq"] = j + 1
        sdir = self.cfg.standby_dir(j)
        sdir.mkdir(parents=True, exist_ok=True)
        activation = sdir / "activate.json"
        # stale protocol files from a previous cluster incarnation in
        # the same workdir would likewise fire the protocol early
        activation.unlink(missing_ok=True)
        Path(str(activation) + ".ready").unlink(missing_ok=True)
        env = self._worker_env(0)
        env.pop("DMT_WORKER_INDEX", None)
        env.pop("DMT_WORKER_DIR", None)
        env["DMT_STANDBY_ACTIVATION"] = str(activation)
        log_fh = open(sdir / "standby_stdout.log", "ab")
        try:
            proc = subprocess.Popen(
                ["sh", "-c", self.cfg.resolved_standby_command()],
                cwd=sdir, env=env, stdout=log_fh,
                stderr=subprocess.STDOUT, start_new_session=True)
        finally:
            log_fh.close()
        sb = {"standby": j, "pid": proc.pid, "dir": str(sdir),
              "activation": str(activation), "spawned_at": time.time()}
        slots.append(sb)
        self.exec.journal({"event": "spawn", "standby": j, "pid": proc.pid,
                           "command": self.cfg.resolved_standby_command()})
        return sb

    def _standby_ready(self, sb: dict[str, Any]) -> bool:
        """Parked and promotable: the process signalled ready (it has
        imported torch, built its trainer, precompiled) and is alive."""
        marker = Path(sb["activation"] + ".ready")
        return (marker.exists() and bool(sb.get("pid"))
                and self._pid_alive(sb["pid"]))

    def ensure_standbys(self, n: int) -> None:
        """Top the warm-standby pool up to ``n`` live spares. Spawning
        is async (the spare boots in the background); only a spare that
        reached its ready marker is promotable."""
        state = self._read_state()
        if not state["workers"]:
            raise ClusterError("ensure_standbys before create: no workers")
        if self.exec.dry_run:
            for _ in range(n):
                self.exec.run(["sh", "-c",
                               self.cfg.resolved_standby_command()],
                              verb="run")
            return
        slots = state.setdefault("standbys", [])
        dead = [sb for sb in slots
                if not (sb.get("pid") and self._pid_alive(sb["pid"]))]
        for sb in dead:
            slots.remove(sb)
            self.exec.journal({"event": "lifecycle",
                               "action": "standby_reaped",
                               "standby": sb["standby"], "pid": sb.get("pid")})
        for _ in range(max(0, n - len(slots))):
            self._spawn_standby(state)
        self._write_state(state)

    def promote_standby(self, k: int) -> bool:
        """Hand worker ``k``'s identity to a READY standby: kill any
        previous incarnation, write the activation file (atomically, so
        the parked process never reads a torn assignment), and record
        the standby's pid as the worker's. Returns False — caller falls
        back to a cold ``restart_worker`` — when no standby is ready.

        The worker's ``spawned_at`` is stamped with the PROMOTION time:
        per-incarnation clocks (the chaos drain's stall parking) must
        measure from when this process took over the logdir, not from
        when the spare originally booted — its old log silence was
        parking, not stalling."""
        if self.exec.dry_run:
            return False
        if str(k) in self.cfg.worker_commands:
            # mixed roster: this slot runs an OVERRIDDEN payload (e.g.
            # a serving replica in a publisher+replicas cluster), but
            # the parked spare runs the standby/default payload —
            # promoting it would silently swap the worker's role.
            # Cold respawn of the worker's OWN command is the correct
            # recovery. (The standby command legitimately differs from
            # train_command — it is the parked-protocol variant of the
            # DEFAULT payload, which is exactly what overridden slots
            # are not.)
            return False
        state = self._read_state()
        sel = self._select(state["workers"], str(k))
        if not sel:
            raise ClusterError(f"promote_standby({k}): no such worker")
        w = sel[0]
        ready = [sb for sb in state.get("standbys", [])
                 if self._standby_ready(sb)]
        if not ready:
            return False
        sb = ready[0]
        if w.get("pid"):
            self._kill_pid(w["pid"], "kill")
        activation = Path(sb["activation"])
        tmp = activation.with_suffix(".tmp")
        tmp.write_text(json.dumps({"train_dir": w["logdir"], "worker": k}))
        tmp.replace(activation)
        state["standbys"].remove(sb)
        w["pid"] = sb["pid"]
        w["spawned_at"] = time.time()
        w["promoted_from_standby"] = sb["standby"]
        state["phase"] = "running"
        # The activation file above is the commit point: the parked
        # process is already adopting worker k's logdir, so EVERYTHING
        # below is best-effort — an exception escaping here reads as
        # promoted=False to the supervisor, which would cold-respawn a
        # second trainer into the train_dir the live standby now owns.
        try:
            self._write_state(state)
            self.exec.journal({"event": "lifecycle",
                               "action": "promote_standby",
                               "worker": k, "standby": sb["standby"],
                               "pid": sb["pid"]})
        except Exception as e:
            logger.warning("promotion bookkeeping failed (%s: %s) — "
                           "promotion stands", type(e).__name__, e)
        # back-fill asynchronously: the pool heals while the promoted
        # process is already training; a failed spawn (fork/fd
        # pressure) must not unwind the promotion either.
        try:
            self._spawn_standby(state)
            self._write_state(state)
        except Exception as e:
            logger.warning("standby back-fill failed (%s) — pool not "
                           "replenished", e)
            try:
                self.exec.journal({"event": "lifecycle",
                                   "action": "standby_backfill_failed",
                                   "error": str(e)})
            except Exception:
                pass
        return True

    def measured_boot_s(self) -> float | None:
        """Observed spawn→first-log-record latency (max over workers
        whose first intact record postdates their recorded spawn) —
        what adaptive stall timeouts derive from instead of the
        hardcoded worst case. None when nothing measurable yet (no
        logs, records without timestamps, or logs predating the
        current incarnation)."""
        state = self._read_state()
        out: list[float] = []
        for w in state["workers"]:
            spawned = w.get("spawned_at")
            if not spawned:
                continue
            log = Path(w["logdir"]) / "train_log.jsonl"
            try:
                with open(log) as fh:
                    for line in fh:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            rec = json.loads(line)
                        except json.JSONDecodeError:
                            continue
                        t = rec.get("time")
                        if isinstance(t, (int, float)) and t >= spawned:
                            out.append(t - spawned)
                        break  # first intact record decides
            except OSError:
                continue
        return max(out) if out else None

    def _select(self, workers: list[dict], worker: str) -> list[dict]:
        if worker == "all":
            return workers
        return [w for w in workers if w["worker"] == int(worker)]

    def _kill_pid(self, pid: int, verb: str) -> None:
        # the recorded pid is a session/process-group leader
        # (start_new_session=True) and `sh -c` FORKS the payload rather
        # than exec it — killing only the shell would orphan the real
        # worker, which then survives to keep training and writing.
        # Signal the whole group (negative pid), falling back to the
        # bare pid for processes that predate the group convention.
        self.exec.run(["sh", "-c", f"kill -9 -{pid} 2>/dev/null || "
                                   f"kill -9 {pid} 2>/dev/null || true"],
                      verb=verb, check=False)

    def kill_all(self, worker: str = "all") -> None:
        state = self._read_state()
        for w in self._select(state["workers"], worker):
            if w.get("pid"):
                self._kill_pid(w["pid"], "kill")
        if worker == "all":
            # parked spares die with the cluster — a standby that
            # outlives its run would hold device memory forever
            for sb in state.get("standbys", []):
                if sb.get("pid"):
                    self._kill_pid(sb["pid"], "kill")

    def status(self) -> dict[str, Any] | None:
        """pgrep-equivalent liveness per worker — a REAL ``kill -0``
        subprocess per pid (≙ the idle probe the gcloud backend sends
        over SSH), so a worker killed mid-run surfaces as
        ``alive: False`` here."""
        if self.exec.dry_run:
            return None  # the backend contract's dry-run sentinel; the
            # liveness probes need real pids, so there is no argv to record
        state = self._read_state()
        workers = []
        for w in state["workers"]:
            # max_attempts=1 in the probe: a dead pid is not transient —
            # a retrying executor must not burn its budget observing it
            alive = bool(w.get("pid")) and self._pid_alive(w["pid"])
            workers.append({"worker": w["worker"], "pid": w.get("pid"),
                            "alive": alive, "logdir": w["logdir"],
                            "spawned_at": w.get("spawned_at")})
        standbys = [{"standby": sb["standby"], "pid": sb.get("pid"),
                     "alive": (bool(sb.get("pid"))
                               and self._pid_alive(sb["pid"])),
                     "ready": self._standby_ready(sb)}
                    for sb in state.get("standbys", [])]
        got = {"state": state["phase"].upper(),
               "workers": workers,
               "idle": not any(w["alive"] for w in workers)}
        if standbys:
            got["standbys"] = standbys
        return got

    def exec_all(self, command: str, worker: str = "all") -> None:
        state = self._read_state()
        for w in self._select(state["workers"], worker):
            self.exec.run(["sh", "-c", command], verb="exec",
                          cwd=w["logdir"], env=self._worker_env(w["worker"]))

    def download(self, local_dir: str | Path, remote_path: str | None = None,
                 worker: str = "0") -> None:
        """File-copy "download" of a worker's logdir — a real ``cp -r``
        subprocess (≙ the scp download path, tf_ec2.py:651-742)."""
        state = self._read_state()
        local_dir = Path(local_dir)
        local_dir.mkdir(parents=True, exist_ok=True)
        for w in self._select(state["workers"], worker):
            src = remote_path or w["logdir"]
            self.exec.run(["cp", "-r", str(src), str(local_dir)],
                          verb="download")

    def worker_progress(self) -> dict[int, int]:
        """Per-worker latest logged step ({worker: step}; -1 when a
        worker hasn't logged yet) — one real ``tail`` per worker. This
        is the stall-detection signal: a SIGSTOPped or wedged worker
        stays ``alive`` under the pid probe while its log stops moving,
        so liveness alone cannot see a hang."""
        state = self._read_state()
        out: dict[int, int] = {}
        for w in state["workers"]:
            log = Path(w["logdir"]) / "train_log.jsonl"
            res = self.exec.run(
                ["sh", "-c", f"tail -n 3 {shlex.quote(str(log))} "
                             f"2>/dev/null || true"],
                verb="progress", check=False, max_attempts=1)
            if res is None:  # dry-run
                continue
            out[w["worker"]] = parse_poll_output(res.stdout)["step"]
        return out

    def _latest_checkpoint_artifact(self, logdir: Path) -> Path | None:
        """The file a torn-write fault should hit: the pointer's
        latest_path when readable, else the newest ``ckpt-*`` data
        file."""
        try:
            d = json.loads((logdir / "checkpoint.json").read_text())
            target = logdir / d["latest_path"]
            if target.exists():
                return target
        except (OSError, json.JSONDecodeError, KeyError, TypeError):
            pass
        cands = [p for p in logdir.glob("ckpt-*")
                 if not p.name.endswith((".tmp", ".sha256"))]
        return max(cands, key=lambda p: p.name) if cands else None

    def _apply_poll_faults(self, state: dict[str, Any]
                           ) -> dict[int, int] | None:
        """Fire the step-triggered fault actions (each at most once per
        worker): kill → hang → corrupt-latest-checkpoint. Returns the
        worker-progress sweep it ran (None when no trigger was left to
        fire) so poll() can share it instead of re-spawning N tails.

        Worker-keyed triggers fire on the TARGET worker's own logged
        step, not worker 0's: worker boots skew by tens of seconds (a
        second process on a contended host), so "kill worker k at
        step s" keyed to another worker's log could fire while k is
        still booting — before it has done the work (e.g. saved the
        checkpoint a corrupt action wants to tear) the scenario is
        about."""
        plan = self.exec.fault_plan
        unfired = [(kind, mapping)
                   for kind, mapping in
                   (("kill", plan.kill_worker_at_step),
                    ("hang", plan.hang_worker_at_step),
                    ("corrupt", plan.corrupt_latest_checkpoint_at_step),
                    ("stall", plan.stall_worker_for_ms_at_step))
                   if any((kind, k) not in self._fault_fired
                          for k in mapping)]
        if not unfired:
            return None  # every trigger already fired — no tails
        prog = self.worker_progress()
        for k, s in plan.kill_worker_at_step.items():
            if prog.get(k, -1) >= s and ("kill", k) not in self._fault_fired:
                self._fault_fired.add(("kill", k))
                for w in self._select(state["workers"], str(k)):
                    if w.get("pid"):
                        self._kill_pid(w["pid"], "fault")
                        self.exec.journal(
                            {"event": "fault", "action": "kill_worker",
                             "worker": k, "pid": w["pid"],
                             "at_step": prog[k], "planned_step": s})
        for k, s in plan.hang_worker_at_step.items():
            if prog.get(k, -1) >= s and ("hang", k) not in self._fault_fired:
                self._fault_fired.add(("hang", k))
                for w in self._select(state["workers"], str(k)):
                    if w.get("pid"):
                        # stop the whole group: the payload is the
                        # shell's CHILD (see _kill_pid)
                        self.exec.run(
                            ["sh", "-c", f"kill -STOP -{w['pid']} "
                                         f"2>/dev/null || "
                                         f"kill -STOP {w['pid']} "
                                         f"2>/dev/null || true"],
                            verb="fault", check=False)
                        self.exec.journal(
                            {"event": "fault", "action": "hang_worker",
                             "worker": k, "pid": w["pid"],
                             "at_step": prog[k], "planned_step": s})
        for k, (s, ms) in plan.stall_worker_for_ms_at_step.items():
            if prog.get(k, -1) >= s and ("stall", k) not in self._fault_fired:
                self._fault_fired.add(("stall", k))
                for w in self._select(state["workers"], str(k)):
                    if not w.get("pid"):
                        continue
                    pid = w["pid"]
                    # STOP the whole group now; a detached subshell
                    # CONTs it after the stall window — the resume must
                    # not depend on the driver still polling (the
                    # whole point is a straggler that recovers on its
                    # OWN, racing any supervisor restart decision)
                    secs = ms / 1e3
                    self.exec.run(
                        ["sh", "-c",
                         f"kill -STOP -{pid} 2>/dev/null || "
                         f"kill -STOP {pid} 2>/dev/null; "
                         f"( sleep {secs}; "
                         f"kill -CONT -{pid} 2>/dev/null || "
                         f"kill -CONT {pid} 2>/dev/null ) "
                         f">/dev/null 2>&1 &"],
                        verb="fault", check=False)
                    self.exec.journal(
                        {"event": "fault", "action": "stall_worker",
                         "worker": k, "pid": pid, "stall_ms": ms,
                         "at_step": prog[k], "planned_step": s})
        for k, s in plan.corrupt_latest_checkpoint_at_step.items():
            if (prog.get(k, -1) >= s
                    and ("corrupt", k) not in self._fault_fired):
                self._fault_fired.add(("corrupt", k))
                for w in self._select(state["workers"], str(k)):
                    target = self._latest_checkpoint_artifact(
                        Path(w["logdir"]))
                    if target is None:
                        self.exec.journal(
                            {"event": "fault",
                             "action": "corrupt_latest_checkpoint",
                             "worker": k, "target": None,
                             "at_step": prog[k], "planned_step": s})
                        continue
                    targets = [target]
                    if target.name.endswith(".msgpack") and \
                            not target.name.endswith(".quant.msgpack"):
                        # the publish-time quantization pass writes a
                        # .quant sidecar next to the artifact — tear it
                        # TOO, so a serving replica on a quantized
                        # precision tier exercises the SIDECAR's digest
                        # refusal, not just the checkpoint's
                        quant = target.with_name(
                            target.name[:-len(".msgpack")]
                            + ".quant.msgpack")
                        if quant.exists():
                            targets.append(quant)
                    for tgt in targets:
                        keep = max(1, tgt.stat().st_size // 2)
                        self.exec.run(["truncate", "-s", str(keep),
                                       str(tgt)], verb="fault",
                                      check=False)
                        self.exec.journal(
                            {"event": "fault",
                             "action": "corrupt_latest_checkpoint",
                             "worker": k, "target": tgt.name,
                             "truncated_to": keep,
                             "at_step": prog[k], "planned_step": s})

    def poll(self) -> dict[str, Any] | None:
        """Tail worker 0's ``train_log.jsonl`` via a real subprocess;
        additionally the seam where the fault plan's step-triggered
        actions fire (the poll cadence is when the driver looks at the
        cluster — exactly when a lost worker becomes observable)."""
        state = self._read_state()
        if not state["workers"]:
            return {"step": -1, "record": None}
        log = Path(state["workers"][0]["logdir"]) / "train_log.jsonl"
        out = self.exec.run(
            ["sh", "-c", f"tail -n 3 {shlex.quote(str(log))} "
                         f"2>/dev/null || true"],
            verb="poll", check=False)
        if out is None:  # dry-run: tail argv recorded above
            return None
        got = parse_poll_output(out.stdout)
        if state["phase"] == "running":
            st = self.status()
            got["workers_alive"] = sum(w["alive"] for w in st["workers"])
            # the full per-worker snapshot rides along so a supervisor
            # polling every tick doesn't re-run N liveness probes it
            # already paid for here
            got["workers"] = st["workers"]
        prog = self._apply_poll_faults(state)
        if prog is not None:
            # share the fault hook's progress sweep with callers (the
            # supervisor) instead of letting them re-spawn N tails
            got["worker_progress"] = prog
        return got


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def make_backend(backend: str, config: str | None,
                 executor: CommandExecutor,
                 device: str | None = None) -> ClusterBackend:
    """Backend factory — the pluggability seam the CLI and tests use.
    ``device`` (``--device``) overrides the config's."""
    if backend == "local":
        cfg = (LocalClusterConfig.from_file(config) if config
               else LocalClusterConfig())
        if device is not None:
            cfg = dataclasses.replace(cfg, device=device)
        return LocalProcessCluster(cfg, executor)
    if backend == "gcloud":
        raise ClusterError(
            "--backend gcloud is not ported: the gcloud TPU-VM backend "
            "belongs to `launch pod`, which the port does not have; "
            "use --backend local")
    raise ClusterError(f"unknown backend {backend!r} (choices: local)")


def main(argv: list[str] | None = None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        prog="distributedmnist_tpu_torch.launch cluster")
    p.add_argument("action",
                   choices=["create", "delete", "status", "run", "kill-all",
                            "exec", "download", "poll", "supervise",
                            "reconfigure", "broker", "chaos"])
    p.add_argument("--backend", default="local", choices=["local", "gcloud"])
    p.add_argument("--config", default=None,
                   help="LocalClusterConfig JSON")
    p.add_argument("--device", default=None,
                   help="torch device of every worker that runs a port "
                        "verb (default: the verb's own, cuda:0; 'cpu' "
                        "appends --device cpu to each such payload)")
    p.add_argument("--fault-plan", default=None, help="FaultPlan JSON")
    p.add_argument("--journal", default=None,
                   help="command journal JSONL path (local backend "
                        "defaults to <workdir>/command_journal.jsonl)")
    p.add_argument("--dry-run", action="store_true",
                   help="record commands instead of executing")
    p.add_argument("--command", default=None, help="for exec")
    p.add_argument("--worker", default=None, help="worker index or 'all'")
    p.add_argument("--local-dir", default="./cluster_results",
                   help="for download")
    p.add_argument("--remote-path", default=None, help="for download")
    p.add_argument("--timeout-s", type=float, default=None,
                   help="per-command timeout")
    p.add_argument("--max-attempts", type=int, default=1,
                   help="retry budget for transient command failures")
    p.add_argument("--until-step", type=int, default=None, metavar="N",
                   help="for run/poll/supervise: follow train_log.jsonl and "
                        "return at step N (run/supervise also stop the "
                        "cluster)")
    # None → 5.0 for run/poll/supervise; chaos resolves a per-payload
    # default instead (0.2 shell / 1.0 train), so only an EXPLICIT
    # flag may override it
    p.add_argument("--poll-secs", type=float, default=None)
    p.add_argument("--poll-timeout-s", type=float, default=24 * 3600.0)
    p.add_argument("--supervisor-config", default=None,
                   help="for supervise: SupervisorConfig JSON (quorum, "
                        "restart budget/backoff, stall timeout); flags "
                        "below override it")
    p.add_argument("--quorum", type=int, default=None,
                   help="for supervise: min live workers to continue")
    p.add_argument("--max-restarts", type=int, default=None,
                   help="for supervise: restart budget per worker")
    p.add_argument("--restart-backoff-s", type=float, default=None,
                   help="for supervise: base restart backoff")
    p.add_argument("--stall-timeout-s", type=float, default=None,
                   help="for supervise: hang detection window (0 = off)")
    p.add_argument("--standby-workers", type=int, default=None,
                   help="for supervise/chaos: keep N pre-booted, "
                        "precompiled standby processes parked; a due "
                        "restart promotes one instead of cold-starting")
    p.add_argument("--elastic", action="store_true", default=None,
                   help="for supervise: below quorum with every restart "
                        "budget exhausted, SHRINK the world to the "
                        "survivors (drain → checkpoint-flush → relaunch "
                        "smaller, quorum rescaled) instead of aborting")
    p.add_argument("--min-workers", type=int, default=None,
                   help="for supervise: smallest world elastic shrink "
                        "may produce (below it the run aborts)")
    p.add_argument("--new-workers", type=int, default=None, metavar="M",
                   help="for reconfigure: the target world size (shrink "
                        "drops the highest ids / dead workers first; "
                        "grow seeds fresh workers from a survivor's "
                        "newest checkpoint)")
    p.add_argument("--target-worker", type=int, default=None,
                   help="for supervise: count progress toward "
                        "--until-step from THIS worker's log only "
                        "(mixed-payload clusters: the publisher, not a "
                        "serving replica's request counter)")
    p.add_argument("--seed", type=int, default=None,
                   help="for supervise/chaos: schedule + retry-jitter "
                        "seed, stamped on every journaled recovery/chaos "
                        "event so an episode is replayable from the "
                        "artifact alone")
    p.add_argument("--trials", type=int, default=None,
                   help="for chaos: number of seeded fault-schedule "
                        "trials")
    p.add_argument("--payload", default=None,
                   choices=["train", "shell", "serving"],
                   help="for chaos: real `launch train` workers (all "
                        "invariants incl. bitwise determinism), the "
                        "cheap shell loop (CI smoke), or the serving "
                        "tier under fire (publisher + serve replicas + "
                        "closed-loop load, serving invariants checked)")
    p.add_argument("--chaos-config", default=None,
                   help="for chaos: ChaosConfig JSON (flags above "
                        "override it)")
    p.add_argument("--no-shrink", action="store_true",
                   help="for chaos: skip minimizing failing schedules")
    p.add_argument("--serve-decode", action="store_true",
                   help="for chaos (payload=serving): decode replicas "
                        "(token streaming) instead of classifiers")
    p.add_argument("--network", action="store_true",
                   help="for chaos (payload=serving, requires "
                        "--serve-decode): transport faults via per-"
                        "replica chaos proxies (launch/netchaos.py) — "
                        "mid-stream reset + partition window every "
                        "trial — instead of process faults; invariant "
                        "13 (net_faults) replays the exactly-once "
                        "books")
    p.add_argument("--disk", action="store_true",
                   help="for chaos (payload=train): storage faults via "
                        "the workers' durable-write shim "
                        "(train/storage.py) — retry-exhausting ENOSPC, "
                        "torn write, and power-cut rename paired with "
                        "a kill every trial — instead of process "
                        "faults; invariant 14 (storage_faults) replays "
                        "the crash-consistency books")
    p.add_argument("--serve-command", default=None,
                   help="for broker: the serving payload a scaled-up "
                        "replica slot runs — also how the broker "
                        "recognizes which roster slots are serving "
                        "(command equality)")
    p.add_argument("--broker-config", default=None,
                   help="for broker: BrokerConfig JSON (thresholds, "
                        "hysteresis marks, cooldown, roster bounds)")
    p.add_argument("--loadgen-journal", default=None,
                   help="for broker: the loadgen.jsonl carrying "
                        "rolling-window pressure snapshots (defaults "
                        "to <workdir>/loadgen.jsonl)")
    p.add_argument("--warm-standbys", type=int, default=0,
                   help="for broker: pre-boot N parked serving spares; "
                        "a scale-up promotes one instead of paying a "
                        "cold boot")
    args = p.parse_args(argv)
    poll_secs = 5.0 if args.poll_secs is None else args.poll_secs

    if args.action == "chaos":
        # the campaign owns its clusters/executors (one per trial, all
        # local, fault plans generated from the seed) — flags that
        # would silently be discarded must error instead
        for flag, val in (("--backend", args.backend != "local"),
                          ("--dry-run", args.dry_run),
                          ("--fault-plan", args.fault_plan is not None),
                          ("--config", args.config is not None),
                          ("--journal", args.journal is not None),
                          ("--timeout-s", args.timeout_s is not None)):
            if val:
                p.error(f"{flag} does not apply to chaos — campaigns run "
                        "local clusters with seed-generated fault plans "
                        "(use --chaos-config)")
        from .chaos import ChaosConfig, run_campaign
        overrides = {"trials": args.trials, "seed": args.seed,
                     "until_step": args.until_step,
                     "payload": args.payload,
                     # the supervisor policy under test — same flags as
                     # `supervise`, mapped onto the campaign config
                     "quorum": args.quorum,
                     "max_restarts": args.max_restarts,
                     "restart_backoff_s": args.restart_backoff_s,
                     "stall_timeout_s": args.stall_timeout_s,
                     "standby_workers": args.standby_workers,
                     "poll_secs": args.poll_secs,
                     "device": args.device}
        overrides = {k: v for k, v in overrides.items() if v is not None}
        if args.no_shrink:
            overrides["shrink"] = False
        # store_true flags: only override when SET, so a chaos-config
        # file's own values survive the merge
        if args.serve_decode:
            overrides["serve_decode"] = True
        if args.network:
            overrides["network"] = True
        if args.disk:
            overrides["disk"] = True
        # merged before construction — __post_init__ validates
        # cross-field constraints, so flags can't land via replace()
        ccfg = (ChaosConfig.from_file(args.chaos_config, overrides=overrides)
                if args.chaos_config else ChaosConfig(**overrides))
        print(json.dumps(run_campaign(ccfg), default=str))
        return

    fault = FaultPlan.from_file(args.fault_plan) if args.fault_plan else None
    journal = args.journal
    if journal is None and args.backend == "local" and not args.dry_run:
        cfg0 = (LocalClusterConfig.from_file(args.config) if args.config
                else LocalClusterConfig())
        cfg0.root.mkdir(parents=True, exist_ok=True)
        journal = cfg0.root / "command_journal.jsonl"
    executor = CommandExecutor(
        journal=journal,
        retry=RetryPolicy(max_attempts=args.max_attempts, seed=args.seed),
        timeout_s=args.timeout_s, fault_plan=fault, dry_run=args.dry_run)
    backend = make_backend(args.backend, args.config, executor,
                           device=args.device)

    if args.action == "create":
        backend.create()
    elif args.action == "delete":
        backend.delete()
    elif args.action == "status":
        print(json.dumps(backend.status(), indent=2))
    elif args.action == "run":
        if args.until_step is not None:
            print(json.dumps(run_until_step(
                backend, args.until_step, poll_secs=poll_secs,
                timeout_secs=args.poll_timeout_s)))
        else:
            backend.run_train()
    elif args.action in ("supervise", "reconfigure", "broker"):
        from .supervisor import ClusterSupervisor, SupervisorConfig
        if args.action in ("supervise", "broker") \
                and args.until_step is None:
            p.error(f"{args.action} requires --until-step")
        if args.action == "broker" and not args.serve_command:
            p.error("broker requires --serve-command (the serving "
                    "payload a scaled-up slot runs)")
        if args.action == "reconfigure" and args.new_workers is None:
            p.error("reconfigure requires --new-workers")
        scfg = (SupervisorConfig.from_file(args.supervisor_config)
                if args.supervisor_config else SupervisorConfig())
        overrides = {"quorum": args.quorum,
                     "max_restarts_per_worker": args.max_restarts,
                     "restart_backoff_s": args.restart_backoff_s,
                     "stall_timeout_s": args.stall_timeout_s,
                     "standby_workers": args.standby_workers,
                     "elastic": args.elastic,
                     "min_workers": args.min_workers,
                     "seed": args.seed}
        scfg = dataclasses.replace(
            scfg, **{k: v for k, v in overrides.items() if v is not None})
        sup = ClusterSupervisor(backend, scfg)
        if args.action == "reconfigure":
            # drain → reshape → relaunch; optionally supervise the
            # resized world to a target step in the same invocation
            rec = sup.reconfigure(args.new_workers, trigger="cli")
            if args.until_step is not None:
                try:
                    got = sup.supervise_until_step(
                        args.until_step, poll_secs=poll_secs,
                        timeout_secs=args.poll_timeout_s,
                        target_worker=args.target_worker)
                finally:
                    backend.kill_all()
                print(json.dumps({"reconfigure": rec, **got}))
            else:
                print(json.dumps({"reconfigure": rec,
                                  "summary": sup.summary()}))
        elif args.action == "broker":
            # supervise + demand-driven autoscaling: the broker rides
            # the supervise loop's per-tick callback, trading roster
            # slots on journaled load pressure (every move replayable
            # via the `autoscale` invariant)
            from ..core.config import BrokerConfig
            from .broker import ResourceBroker
            bcfg = (BrokerConfig(**json.loads(
                        Path(args.broker_config).read_text()))
                    if args.broker_config else BrokerConfig())
            journal_path = (Path(args.loadgen_journal)
                            if args.loadgen_journal
                            else getattr(backend, "cfg", None)
                            and backend.cfg.root / "loadgen.jsonl")
            broker = ResourceBroker(
                sup, bcfg, serve_command=args.serve_command,
                loadgen_journal=journal_path,
                warm_standbys=args.warm_standbys)
            broker.start()
            got = sup.run_until_step(
                args.until_step, poll_secs=poll_secs,
                timeout_secs=args.poll_timeout_s,
                target_worker=args.target_worker,
                on_tick=broker.tick)
            print(json.dumps({**got, "autoscale": broker.summary()},
                             default=str))
        else:
            print(json.dumps(sup.run_until_step(
                args.until_step, poll_secs=poll_secs,
                timeout_secs=args.poll_timeout_s,
                target_worker=args.target_worker)))
    elif args.action == "poll":
        if args.until_step is not None:
            print(json.dumps(wait_until_step(
                backend, args.until_step, poll_secs=poll_secs,
                timeout_secs=args.poll_timeout_s)))
        else:
            print(json.dumps(backend.poll()))
    elif args.action == "kill-all":
        backend.kill_all(worker=args.worker or "all")
    elif args.action == "exec":
        if not args.command:
            p.error("exec requires --command")
        backend.exec_all(args.command, worker=args.worker or "all")
    elif args.action == "download":
        backend.download(args.local_dir, args.remote_path,
                         worker=args.worker or "0")
    if args.dry_run:
        print(json.dumps([shlex.join(a) for a in executor.recorded],
                         indent=2))
    executor.close()
