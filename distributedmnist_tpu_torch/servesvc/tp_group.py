"""Tensor-parallel serving process groups (≙
``distributedmnist_tpu/servesvc/tp_group.py``).

``serve.tp_ranks = m > 1`` turns one serving replica into a group of
``m`` processes behind the UNCHANGED socket/failover/hot-swap/heartbeat
contract:

* **rank 0** is the replica the clients see: it owns the socket, the
  batcher, the checkpoint follower, ``serve.json`` and
  ``serve_log.jsonl`` in the worker's own dir, and model shard 0.
* **ranks 1..m-1** hold model shards 1..m-1. They run no socket: each
  runs :func:`run_rank_follower`, which takes every unit of work rank 0
  broadcasts over the group (a predict batch, a prefill, a decode step,
  a version install, a release, a stop) and runs its shard of it. On
  every version it installs a follower journals a ``shard_verify``
  record with the sha256 of the bytes it holds
  (:func:`rank_shard_digest`), under ``serve_dir/rank<r>/``, and
  heartbeats as a worker does.
* the **supervisor** (:class:`ServeGroup`) spawns every rank, journals
  the group's lifecycle to ``group_log.jsonl`` (``group_start`` /
  ``rank_spawn`` / ``rank_exit`` / ``group_down`` / ``group_restart`` /
  ``group_stop``) and keeps it **die-as-a-unit**: any rank exiting
  outside a graceful stop kills every other rank and restarts the whole
  group (bounded by ``serve.tp_group_max_restarts``). A half-dead group
  never serves; the ``serve_group`` replay invariant checks the chain.

Where the reference runs the group's model axis as one XLA program over
a ``replica=1 × model=m`` mesh that rank 0 holds whole (its followers
only verify digests), here the group's ``m`` processes ARE that model
axis: a ``torch.distributed`` group (``core/mesh.py
serving_topology``), rank ``r`` holding shard ``r`` on ``cuda:(r mod
device_count)``, the Megatron all-reduces of ``wo`` and ``w2`` giving
every rank the full logits. The backend is NCCL when the host has a
card a rank, else gloo (on the shared card, or the CPU); a failing
rendezvous or collective ends the group, and the supervisor restarts it
as a unit. :func:`default_spawn_fn` hands each rank its rendezvous
(``MASTER_ADDR``, ``MASTER_PORT`` — a fresh port each attempt, so a
restarted group never joins the dead one's store — ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``).
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np

from ..core.log import JsonlSink, get_logger

logger = get_logger("tp_group")

_KILL_WAIT_S = 10.0
# a collective of the group that waits longer than this fails, so a
# rank never outlives its group by more (a chaos trial's window is
# minutes); it also bounds a follower's restore of a version
GROUP_TIMEOUT_S = 60.0


def _set_pdeathsig():
    """Child preexec hook: die with the supervisor. A SIGKILLed
    supervisor must not orphan half a TP group (linux only; a no-op
    elsewhere)."""
    try:
        import ctypes
        libc = ctypes.CDLL(None, use_errno=True)
        PR_SET_PDEATHSIG = 1
        libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL)
    except Exception:
        pass


class ServeGroup:
    """Spawn and supervise the ranks of one TP serving replica.

    ``spawn_fn(rank, attempt) -> subprocess.Popen`` builds one rank
    process (injectable, so die-as-a-unit is testable without a model);
    the CLI wires :func:`default_spawn_fn`. A supervisor started in a
    ``serve_dir`` whose ``group.json`` a previous supervisor left (the
    worker was killed and restarted) numbers its attempts on from it, so
    the journal's attempts only move forward; its restart budget counts
    from its own first attempt."""

    def __init__(self, serve_dir: str | Path, ranks: int,
                 spawn_fn: Callable[[int, int], subprocess.Popen], *,
                 max_restarts: int = 3, poll_secs: float = 0.25):
        if ranks < 2:
            raise ValueError(f"a TP group needs >= 2 ranks, got {ranks}")
        self.serve_dir = Path(serve_dir)
        self.serve_dir.mkdir(parents=True, exist_ok=True)
        self.ranks = ranks
        self.spawn_fn = spawn_fn
        self.max_restarts = max_restarts
        self.poll_secs = poll_secs
        self.attempt = self._first_attempt = self._previous_attempt() + 1
        self.procs: dict[int, subprocess.Popen] = {}
        self._stopping = False
        self._log = JsonlSink(self.serve_dir / "group_log.jsonl")

    def _previous_attempt(self) -> int:
        try:
            return int(json.loads(
                (self.serve_dir / "group.json").read_text())["attempt"])
        except (OSError, ValueError, KeyError, TypeError):
            return -1

    def _journal(self, record: dict) -> None:
        self._log.write({"event": "serve", "time": time.time(), **record})

    def _write_group_json(self) -> None:
        """Atomic group roster (pids by rank): what a chaos or bench
        harness reads to target one rank."""
        path = self.serve_dir / "group.json"
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps({
            "ranks": self.ranks, "attempt": self.attempt,
            "supervisor_pid": os.getpid(),
            "pids": {str(r): p.pid for r, p in self.procs.items()}}))
        tmp.replace(path)

    def start(self) -> None:
        self._spawn_all()

    def _spawn_all(self) -> None:
        self._journal({"action": "group_start", "ranks": self.ranks,
                       "attempt": self.attempt})
        self.procs = {}
        for r in range(self.ranks):
            p = self.spawn_fn(r, self.attempt)
            self.procs[r] = p
            self._journal({"action": "rank_spawn", "rank": r,
                           "pid": p.pid})
        self._write_group_json()

    def _kill_all(self, sig=signal.SIGKILL) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                try:
                    p.send_signal(sig)
                except OSError:
                    pass
        deadline = time.time() + _KILL_WAIT_S
        for p in self.procs.values():
            while p.poll() is None and time.time() < deadline:
                time.sleep(0.05)

    def _down(self, dead_rank: int, rc) -> None:
        """Die-as-a-unit: one rank is gone, so the whole group goes."""
        self._journal({"action": "rank_exit", "rank": dead_rank,
                       "pid": self.procs[dead_rank].pid, "rc": rc})
        self._kill_all()
        # rank 0's endpoint died with the group: drop the advertisement
        # until the restarted group publishes it again
        try:
            (self.serve_dir / "serve.json").unlink()
        except OSError:
            pass
        self._journal({"action": "group_down",
                       "reason": f"rank {dead_rank} exited (rc={rc})",
                       "ranks": self.ranks, "rank": dead_rank})

    def step(self) -> bool:
        """One supervision tick; False when the group is over for good
        (restart budget spent, or stopping). Of the ranks found gone in
        one tick, the journal names one a signal ended (the cause; a
        peer whose collective then failed exits with a code), else the
        lowest."""
        exited = [(r, p.returncode) for r, p in self.procs.items()
                  if p.poll() is not None]
        if self._stopping or not exited:
            return not self._stopping
        r, rc = min(exited, key=lambda e: (e[1] >= 0, e[0]))
        self._down(r, rc)
        if self.attempt - self._first_attempt >= self.max_restarts:
            self._journal({"action": "group_stop", "ranks": self.ranks})
            return False
        self.attempt += 1
        backoff = min(2.0, 0.25 * (self.attempt - self._first_attempt))
        self._journal({"action": "group_restart", "attempt": self.attempt,
                       "backoff_s": backoff})
        time.sleep(backoff)
        self._spawn_all()
        return True

    def stop(self) -> None:
        """Graceful whole-group stop: SIGTERM rank 0 first (it drains
        its in-flight work and then tells the followers to stop), then
        the followers; stragglers are killed."""
        self._stopping = True
        for r in sorted(self.procs):
            p = self.procs[r]
            if p.poll() is None:
                try:
                    p.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        deadline = time.time() + _KILL_WAIT_S
        for p in self.procs.values():
            while p.poll() is None and time.time() < deadline:
                time.sleep(0.05)
        self._kill_all()
        self._journal({"action": "group_stop", "ranks": self.ranks})

    def run_forever(self, after_start: Callable[["ServeGroup"], None]
                    | None = None) -> None:
        """Start the group and supervise it until it is over;
        ``after_start(self)`` runs once the ranks are spawned (the CLI
        reads the run config's restart budget there, while the ranks
        boot)."""
        def _on_term(signum, frame):
            self._stopping = True
        try:
            signal.signal(signal.SIGTERM, _on_term)
            signal.signal(signal.SIGINT, _on_term)
        except ValueError:
            pass  # not the main thread (tests)
        self.start()
        if after_start is not None:
            after_start(self)
        while self.step():
            time.sleep(self.poll_secs)
        if self._stopping:
            self.stop()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def default_spawn_fn(base_argv: list[str], serve_dir: str | Path,
                     ranks: int) -> Callable[[int, int], subprocess.Popen]:
    """Rank-process factory for the CLI: re-invoke ``launch serve`` with
    the SAME user flags plus ``--tp-rank r`` (rank 0 the replica, the
    others followers) and a per-rank serve dir (rank 0 keeps the group's
    dir — the socket contract's surface). Each rank's environment holds
    the group's rendezvous, on a port fresh for each attempt; a warm
    spare's activation variable is not passed on (the supervisor parked
    and adopted its dir already)."""
    serve_dir = Path(serve_dir)
    argv = []
    skip = False
    for tok in base_argv:
        if skip:
            skip = False
            continue
        if tok in ("--serve-dir", "--tp-ranks", "--tp-rank"):
            skip = True
            continue
        if tok.startswith(("--serve-dir=", "--tp-ranks=", "--tp-rank=")):
            continue
        argv.append(tok)
    ports: dict[int, int] = {}

    def spawn(rank: int, attempt: int) -> subprocess.Popen:
        if attempt not in ports:
            ports[attempt] = _free_port()
        rank_dir = serve_dir if rank == 0 else serve_dir / f"rank{rank}"
        cmd = ([sys.executable, "-m", "distributedmnist_tpu_torch.launch"]
               + argv + ["--serve-dir", str(rank_dir),
                         "--tp-ranks", str(ranks),
                         "--tp-rank", str(rank)])
        env = {k: v for k, v in os.environ.items()
               if k != "DMT_STANDBY_ACTIVATION"}
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(ports[attempt]),
                   RANK=str(rank), WORLD_SIZE=str(ranks),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(ranks))
        return subprocess.Popen(
            cmd, env=env,
            preexec_fn=_set_pdeathsig if os.name == "posix" else None)

    return spawn


def process_started_at() -> float | None:
    """This process's start on the wall clock (linux: ``/proc``), or
    None where it cannot be read — what a rank's boot is timed from."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


# ---------------------------------------------------------------------------
# Shard digests
# ---------------------------------------------------------------------------

def _model_axis_dim(spec, axis: str = "model") -> int | None:
    """The dim a spec splits over the model axis, or None (a replicated
    leaf, or no spec)."""
    from ..parallel.partition_rules import split_dim
    return None if spec is None else split_dim(spec, axis)


def _leaf_bytes(leaf: Any) -> np.ndarray:
    """A leaf (numpy array or torch tensor) as a numpy array whose bytes
    are the stored ones (a bfloat16 tensor as its raw 16-bit words, the
    bytes of an ml_dtypes bfloat16 array)."""
    import torch
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.view(torch.int16)
        return leaf.numpy()
    return np.asarray(leaf)


def rank_shard_digest(params, specs, rank: int, ranks: int) -> str:
    """sha256 over rank ``rank``'s model-axis shard of every leaf of the
    full ``params`` (the reference's canonical layout), leaves in
    ``jax.tree.flatten`` order (sorted dict keys, then list index:
    :func:`..parallel.partition_rules.tree_leaves`), a split leaf cut by
    ``np.array_split`` on the dim its spec puts on the model axis, a
    replicated one whole: the identity of the bytes rank ``rank`` holds.
    ``specs`` is the rule engine's tree for the params
    (``parallel/api.py tp_specs``), or None (every leaf whole, the same
    digest on every rank). The reference's hex digest for the same
    params and rank, byte for byte."""
    from ..parallel.partition_rules import spec_leaves, tree_leaves
    h = hashlib.sha256()
    leaves_p = tree_leaves(params)
    leaves_s = spec_leaves(specs) if specs is not None else None
    if leaves_s is None or len(leaves_s) != len(leaves_p):
        leaves_s = [None] * len(leaves_p)
    for leaf, spec in zip(leaves_p, leaves_s):
        arr = _leaf_bytes(leaf)
        dim = _model_axis_dim(spec)
        if dim is not None and arr.ndim > dim:
            arr = np.array_split(arr, ranks, axis=dim)[rank]
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def held_shard_digest(shard) -> str:
    """sha256 over the leaves a rank holds (its shard tree, in the same
    order): equal to :func:`rank_shard_digest` of the full params for
    that rank, since the group splits a leaf evenly."""
    from ..parallel.partition_rules import tree_leaves
    h = hashlib.sha256()
    for leaf in tree_leaves(shard):
        h.update(np.ascontiguousarray(_leaf_bytes(leaf)).tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Follower ranks: the group's work loop
# ---------------------------------------------------------------------------

def run_rank_follower(replica) -> None:
    """A non-zero rank of a TP serving group (≙ the reference's
    ``run_rank_follower``): no socket — run every unit of work rank 0
    broadcasts on this rank's shard (``replica``: a
    :class:`.server.ServingReplica` or :class:`.decode.DecodeReplica`
    built on the group's topology, in ``serve_dir/rank<r>``), journal
    ``shard_verify`` for every version it installs, heartbeat the count
    of versions verified, and return at rank 0's stop. A SIGTERM lets
    the loop run on to that stop (rank 0, stopped first, sends it); a
    failed collective raises, which ends the process and with it the
    group."""
    def _on_term(signum, frame):
        logger.info("rank %d: SIGTERM — waiting for rank 0's stop",
                    replica.topo.rank)
    try:
        signal.signal(signal.SIGTERM, _on_term)
        signal.signal(signal.SIGINT, _on_term)
    except ValueError:
        pass
    replica.follow_group()
