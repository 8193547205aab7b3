"""The serving replica's front door (≙ ``distributedmnist_tpu/servesvc/
server.py ServingReplica``) — the part the decode replica needs.

One replica = one socket + one bounded admission queue + one worker
thread (the decode loop, :class:`~.decode.DecodeReplica`). The
robustness contract the reference's replay invariants check, kept
here:

* **Exactly one terminal outcome per admitted request** — a response
  or a TYPED reject (``overloaded`` / ``deadline_exceeded`` /
  ``bad_request`` / ``shutting_down``); a graceful stop drains the
  queue by rejecting, never by dropping.
* **Never serve a checkpoint that failed digest verification** — the
  boot load goes through ``train/checkpoint.py restore_params``, which
  falls back from a torn or corrupt publish to the previous loadable
  step (journaled).
* **Idempotency** — a retried request id whose execution already
  completed here answers from a bounded cache instead of running twice.

Wire protocol: one JSON line per request on its own connection, one or
more JSON lines back (``{"meta": true}`` answers the model metadata
without queueing).

Artifacts per replica (in ``serve_dir``), record for record the
reference's: ``serve_log.jsonl`` (``event: "serve"`` — admit /
respond / reject / weight_swap / serve_start / serve_stop and the
decode records), ``train_log.jsonl`` (``event: "heartbeat"`` whose
``step`` counts terminal outcomes — the supervisor's progress probe),
and ``serve.json`` (the bound endpoint, written once the replica is
ready).

Not ported yet: hot-follow of new publishes and mid-generation weight
swaps (the replica serves the checkpoint it booted with), quantized
precision tiers, tensor-parallel serving groups, and the classification
replica itself.
"""

from __future__ import annotations

import collections
import json
import os
import queue
import socket
import threading
import time
from pathlib import Path
from typing import Any

from ..core.config import (SERVING_PRECISION_TIERS, ConfigError,
                           ExperimentConfig, ServeConfig,
                           effective_model_config)
from ..core.device import resolve_device
from ..core.log import JsonlSink, get_logger
from ..models.convert import params_from_reference
from ..models.registry import get_model
from ..train import checkpoint as ckpt

logger = get_logger("serve")

_MAX_REQUEST_BYTES = 4 << 20  # a request is one sequence, not a shard

wait_for_run_config = ckpt.wait_for_run_config


class _Pending:
    """One admitted request waiting in the admission queue."""

    __slots__ = ("req_id", "inputs", "conn", "admitted_at", "deadline_at")

    def __init__(self, req_id, inputs, conn, admitted_at, deadline_at):
        self.req_id = req_id
        self.inputs = inputs
        self.conn = conn
        self.admitted_at = admitted_at
        self.deadline_at = deadline_at


class ServingReplica:
    """Socket, admission, journals and boot-time weights shared by the
    serving workloads. Subclasses provide ``_build_item`` (request
    validation) and ``_batch_loop`` (the worker thread); the
    classification workload is not ported yet, so only
    :class:`~.decode.DecodeReplica` is constructible."""

    def __init__(self, train_dir: str | Path, serve_dir: str | Path = ".",
                 scfg: ServeConfig | None = None,
                 cfg: ExperimentConfig | None = None, device=None):
        if type(self) is ServingReplica:
            raise NotImplementedError(
                "classification serving is not ported yet; serve a "
                "causal LM with DecodeReplica (launch serve --decode)")
        self.device = resolve_device(device)
        self.train_dir = Path(train_dir)
        self.serve_dir = Path(serve_dir)
        self.serve_dir.mkdir(parents=True, exist_ok=True)
        if cfg is None:
            cfg = wait_for_run_config(self.train_dir)
        self.cfg = cfg
        self.scfg = scfg or cfg.serve
        if int(self.scfg.tp_ranks) > 1:
            raise ConfigError(
                f"serve.tp_ranks={self.scfg.tp_ranks}: tensor-parallel "
                "serving groups are not ported yet")
        self.model = get_model(effective_model_config(cfg, serving=True))
        self.tier = self.scfg.precision_tier or "fp32"
        if self.tier not in SERVING_PRECISION_TIERS:
            raise ConfigError(
                f"serve.precision_tier={self.tier!r} is not a known "
                f"tier; valid tiers: {', '.join(SERVING_PRECISION_TIERS)}")

        # weights: loaded once at start() and served until stop()
        self._params = None
        self.model_step = -1
        self.model_digest: str | None = None
        self.model_tier: str | None = None

        self._queue: queue.Queue[_Pending] = queue.Queue(
            maxsize=max(1, self.scfg.queue_depth))
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._conn_threads: set[threading.Thread] = set()
        self._conn_lock = threading.Lock()
        self._sock: socket.socket | None = None
        self.bound_port: int | None = None

        self._journal_lock = threading.Lock()
        self._journal_closed = False
        self._serve_log = JsonlSink(self.serve_dir / "serve_log.jsonl")
        self._heartbeat = JsonlSink(self.serve_dir / "train_log.jsonl")
        self._terminals = 0          # responses + rejects ever produced
        self._last_heartbeat = -1
        self.swaps = 0

        # request id → (final ok payload, completed_at), bounded LRU
        self._dedup_lock = threading.Lock()
        self._dedup: collections.OrderedDict[Any, tuple[dict, float]] = \
            collections.OrderedDict()
        self.dedup_hits = 0

    # -- journal ------------------------------------------------------

    def _journal(self, record: dict) -> None:
        with self._journal_lock:
            if self._journal_closed:
                return  # a straggler conn thread racing stop()
            self._serve_log.write({"event": "serve",
                                   "time": time.time(), **record})

    def _terminal(self, action: str, req_id, **fields) -> None:
        """Journal one terminal outcome and count it for the heartbeat
        — every admitted request produces exactly one of these."""
        self._journal({"action": action, "id": req_id, **fields})
        with self._journal_lock:
            self._terminals += 1

    # -- idempotency / dedup cache ------------------------------------

    def _dedup_put(self, req_id, payload: dict) -> None:
        if req_id is None or int(self.scfg.dedup_cache_size) <= 0:
            return
        with self._dedup_lock:
            self._dedup[req_id] = (payload, time.time())
            self._dedup.move_to_end(req_id)
            while len(self._dedup) > int(self.scfg.dedup_cache_size):
                self._dedup.popitem(last=False)

    def _dedup_get(self, req_id) -> tuple[dict, float] | None:
        if req_id is None:
            return None
        with self._dedup_lock:
            got = self._dedup.get(req_id)
            if got is not None:
                self._dedup.move_to_end(req_id)
        return got

    def _pressure_fields(self) -> dict:
        return {"queue_depth": self._queue.qsize(),
                "queue_limit": max(1, self.scfg.queue_depth)}

    def _maybe_heartbeat(self) -> None:
        with self._journal_lock:
            n = self._terminals
            if n == self._last_heartbeat or self._journal_closed:
                return
            self._last_heartbeat = n
            self._heartbeat.write({"event": "heartbeat", "step": n,
                                   "time": time.time(),
                                   **self._pressure_fields()})

    # -- weights ------------------------------------------------------

    def _read_weights(self) -> dict | None:
        """The newest loadable checkpoint, digest-verified, as params on
        this replica's device in the model's compute dtype (cast once
        here, so the per-call casts inside the model are no-ops)."""
        t0 = time.time()
        on_event = lambda rec: self._journal(
            {**rec, "action": "follow_" + rec["action"]})
        restored = ckpt.restore_params(self.train_dir, on_event=on_event)
        if restored is None:
            return None
        tree, _, step = restored
        params = params_from_reference(tree, device=self.device,
                                       dtype=self.model.compute_dtype)
        digest = ckpt.artifact_digest(self.train_dir, step)
        return {"params": params, "step": step, "digest": digest,
                "tier": "fp32", "source_artifact": f"ckpt-{step:08d}.msgpack",
                "source_digest": digest, "t0": t0}

    def _install(self, staged: dict, initial: bool = False) -> None:
        prev = self.model_step
        self._params = staged["params"]
        self.model_step = staged["step"]
        self.model_digest = staged["digest"]
        self.model_tier = staged["tier"]
        self.swaps += 1
        rec = {"action": "weight_swap", "step": staged["step"],
               "from_step": prev, "digest": staged["digest"],
               "tier": staged["tier"],
               "source_artifact": staged["source_artifact"],
               "source_digest": staged["source_digest"],
               "swap_ms": round((time.time() - staged["t0"]) * 1e3, 3)}
        if initial:
            rec["initial"] = True
        self._journal(rec)

    def _load_initial(self, timeout_s: float = 600.0) -> None:
        deadline = time.time() + timeout_s
        while time.time() < deadline and not self._stop.is_set():
            staged = self._read_weights()
            if staged is not None:
                self._install(staged, initial=True)
                return
            time.sleep(min(1.0, self.scfg.poll_secs))
        raise TimeoutError(
            f"no loadable checkpoint in {self.train_dir} within "
            f"{timeout_s:.0f}s")

    # -- socket front door --------------------------------------------

    def _respond(self, conn, payload: dict) -> bool:
        try:
            wt = float(self.scfg.conn_write_timeout_s)
            cur = conn.gettimeout()
            if wt > 0 and (cur is None or cur > wt):
                conn.settimeout(wt)
            conn.sendall((json.dumps(payload) + "\n").encode())
            return True
        except OSError:
            return False  # client went away; the outcome is journaled
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _reject(self, conn, req_id, reason: str, admitted: bool) -> None:
        self._terminal("reject", req_id, reason=reason, admitted=admitted)
        self._respond(conn, {"id": req_id, "status": "rejected",
                             "reason": reason,
                             "model_step": self.model_step})

    def _conn_abort(self, conn, reason: str, bytes_read: int) -> None:
        """Close a connection that never became a request (read
        deadline, half-open peer): nothing was admitted, no terminal is
        owed; the abort is journaled."""
        self._journal({"action": "conn_abort", "reason": reason,
                       "bytes_read": bytes_read})
        try:
            conn.close()
        except OSError:
            pass

    def _read_request(self, conn) -> bytes | None:
        """One request line under a TOTAL deadline; None when aborted."""
        total_s = max(0.1, float(self.scfg.conn_read_timeout_s))
        deadline = time.monotonic() + total_s
        buf = b""
        while b"\n" not in buf:
            remaining = deadline - time.monotonic()
            reason = "half_open" if not buf else "read_deadline"
            if remaining <= 0:
                self._conn_abort(conn, reason, len(buf))
                return None
            conn.settimeout(remaining)
            try:
                chunk = conn.recv(65536)
            except socket.timeout:
                self._conn_abort(conn, reason, len(buf))
                return None
            if not chunk:
                break
            buf += chunk
            if len(buf) > _MAX_REQUEST_BYTES:
                self._reject(conn, None, "bad_request", admitted=False)
                return None
        return buf

    def _handle_conn(self, conn) -> None:
        """Read one request; admit it (or shed typed). Runs on a
        per-connection thread so a slow client can't stall admission."""
        try:
            buf = self._read_request(conn)
            if buf is None:
                return
            try:
                req = json.loads(buf.decode())
                if not isinstance(req, dict):
                    raise ValueError("request must be a JSON object")
            except (ValueError, UnicodeDecodeError):
                self._reject(conn, None, "bad_request", admitted=False)
                return
            if req.get("meta"):
                self._respond(conn, self._meta())
                return
            req_id = req.get("id")
            cached = self._dedup_get(req_id)
            if cached is not None:
                payload, done_at = cached
                with self._journal_lock:
                    self.dedup_hits += 1
                self._journal({"action": "dedup_hit", "id": req_id,
                               "status": payload.get("status"),
                               "age_s": round(time.time() - done_at, 3)})
                self._respond(conn, payload)
                return
            if self._stop.is_set():
                self._reject(conn, req_id, "shutting_down", admitted=False)
                return
            item = self._build_item(req, conn)
            if item is None:
                return  # _build_item already sent the typed reject
            try:
                self._queue.put_nowait(item)
            except queue.Full:
                self._reject(conn, req_id, "overloaded", admitted=False)
                return
            self._journal({"action": "admit", "id": req_id,
                           "deadline_ms": round(
                               (item.deadline_at - item.admitted_at)
                               * 1e3, 3)})
        except OSError:
            try:
                conn.close()
            except OSError:
                pass

    def _accept_loop(self) -> None:
        assert self._sock is not None
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._handle_conn, args=(conn,),
                                 daemon=True)
            with self._conn_lock:
                self._conn_threads = {x for x in self._conn_threads
                                      if x.is_alive()}
                self._conn_threads.add(t)
            t.start()

    @staticmethod
    def _bucket(n: int, max_batch: int) -> int:
        """The smallest power of 2 >= n, capped at ``max_batch``."""
        b = 1
        while b < n and b < max_batch:
            b *= 2
        return min(b, max_batch)

    # -- lifecycle ----------------------------------------------------

    def start(self) -> None:
        """Load the newest loadable checkpoint, bind, start the accept
        and worker threads, publish ``serve.json``. One start per
        replica object."""
        endpoint_path = self.serve_dir / "serve.json"
        endpoint_path.unlink(missing_ok=True)  # stale incarnation
        self._load_initial()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.scfg.host, self.scfg.port))
        self._sock.listen(128)
        self.bound_port = self._sock.getsockname()[1]
        for target in (self._accept_loop, self._batch_loop):
            t = threading.Thread(target=target, daemon=True,
                                 name=f"serve-{target.__name__}")
            t.start()
            self._threads.append(t)
        tmp = endpoint_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(
            {"host": self.scfg.host, "port": self.bound_port,
             "pid": os.getpid(), "model_step": self.model_step,
             "started_at": time.time()}))
        tmp.replace(endpoint_path)
        self._journal({"action": "serve_start", "port": self.bound_port,
                       "model_step": self.model_step,
                       "precision_tier": self.tier,
                       "active_tier": self.model_tier,
                       "queue_depth": self.scfg.queue_depth,
                       "max_batch": self.scfg.max_batch})
        self._maybe_heartbeat()
        logger.info("serving %s step=%d on %s:%d (%s)", self.cfg.model.name,
                    self.model_step, self.scfg.host, self.bound_port,
                    self.device)

    def request_stop(self) -> None:
        self._stop.set()

    def stop(self) -> None:
        """Stop accepting, drain with typed rejects, close the journals."""
        self.request_stop()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=30)
        # a handler that passed its stop check just before
        # request_stop() may enqueue after the worker's final drain:
        # join the handlers, then drain once more
        with self._conn_lock:
            stragglers = list(self._conn_threads)
        for t in stragglers:
            t.join(timeout=10)
        while True:
            try:
                it = self._queue.get_nowait()
            except queue.Empty:
                break
            self._reject(it.conn, it.req_id, "shutting_down",
                         admitted=True)
        self._journal({"action": "serve_stop",
                       "terminals": self._terminals,
                       "model_step": self.model_step, "swaps": self.swaps})
        with self._journal_lock:
            self._journal_closed = True
            self._serve_log.close()
            self._heartbeat.close()

    def serve_forever(self, install_signal_handlers: bool = True) -> None:
        """The process entry: start, park until SIGTERM/SIGINT, stop."""
        if install_signal_handlers:
            import signal

            def handler(signum, frame):
                logger.warning("received signal %s — draining and "
                               "stopping", signum)
                self.request_stop()

            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    signal.signal(sig, handler)
                except (ValueError, OSError):
                    pass
        self.start()
        try:
            while not self._stop.is_set():
                self._stop.wait(0.5)
        finally:
            self.stop()
