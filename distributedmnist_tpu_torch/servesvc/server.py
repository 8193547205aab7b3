"""The serving replica (≙ ``distributedmnist_tpu/servesvc/server.py
ServingReplica``): one-shot classification, and the socket, admission,
journals and weight follow the decode replica (:mod:`.decode`) builds
on.

One replica = one socket + one bounded admission queue + one batcher
thread + one checkpoint-follower thread. The robustness contract the
reference's replay invariants check, kept here:

* **Exactly one terminal outcome per admitted request** — a response
  or a TYPED reject (``overloaded`` / ``deadline_exceeded`` /
  ``bad_request`` / ``shutting_down``); a graceful stop drains the
  queue by rejecting, never by dropping.
* **Never serve a checkpoint that failed digest verification** — the
  follower reads through ``train/checkpoint.py restore_params``, which
  falls back from a torn or corrupt publish to the previous loadable
  step (journaled), so the replica keeps serving the weights it has.
* **Served model step is monotone non-decreasing across swaps** — a
  swap installs only a strictly newer step.
* **Idempotency** — a retried request id whose execution already
  completed here answers from a bounded cache instead of running twice.

**Hot follow.** The follower thread polls the publish dir every
``serve.poll_secs``, restores a newer step, copies it to the device and
waits for the copy to finish before it stages it (a flip to half-copied
weights would show only as wrong probabilities); the batcher installs
the staged weights at a batch boundary, so the batch in flight finishes
on the old ones, and journals a ``weight_swap`` with ``swap_ms``.

**Precision tiers** (``serve.precision_tier``): with ``bf16`` or
``int8`` the replica prefers the step's quantized sidecar
(``ckpt-<step>.quant.msgpack``, written by ``quant.publish_tiers``),
digest-verified like the artifact; the int8 leaves and their scales
stay on the device and are dequantized inside the predict. A sidecar
that is absent, torn or lacks the tier journals one
``follow_quant_sidecar_fallback`` and that publish serves the
full-precision artifact; the follower's cursor still advances.

**Predict.** Pending requests gather into the smallest power-of-2
bucket up to ``serve.max_batch``, zero-padded, and run through the
model's ``predictions`` export (a transformer's is its next-token
distribution, through the flash kernel K1 when
``model.attention_impl=flash``) under the train step's cuDNN policy.

Wire protocol: one JSON line per request on its own connection, one or
more JSON lines back:

  request:  {"id": ..., "inputs": [...], "deadline_ms": ...}
            {"meta": true}   → model metadata, never queued
  response: {"id": ..., "status": "ok", "model_step": N, "tier": t,
             "prediction": k, "probs": [...]}
            {"id": ..., "status": "rejected", "reason": "..."}

Artifacts per replica (in ``serve_dir``), record for record the
reference's: ``serve_log.jsonl`` (``event: "serve"`` — admit /
respond / reject / weight_swap / follower fallbacks / serve_start /
serve_stop, and the decode records), ``train_log.jsonl`` (``event:
"heartbeat"`` whose ``step`` counts terminal outcomes — the
supervisor's progress probe), and ``serve.json`` (the bound endpoint,
written once the replica is ready). The port adds one file: at each
stop the process appends its kernel launches (:meth:`ServingReplica.
kernel_launches`) as a line of ``kernel_launches.jsonl``, so a
supervisor or a script can read what a replica process ran on the card
after the process is gone.

Not ported yet: tensor-parallel serving groups (``serve.tp_ranks > 1``
is refused).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import queue
import socket
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..core.compile_cache import cache_stats
from ..core.config import (SERVING_PRECISION_TIERS, ConfigError,
                           ExperimentConfig, ServeConfig,
                           effective_model_config)
from ..core.device import resolve_device
from ..core.log import JsonlSink, get_logger
from ..models.convert import params_from_reference
from ..models.registry import get_model
from ..ops.flash_attention import flash_attention_bshd
from ..ops.paged_attention import paged_attention
from ..quant.ptq import build_tier_predict
from ..train import checkpoint as ckpt

logger = get_logger("serve")

_MAX_REQUEST_BYTES = 4 << 20  # a request is one image/sequence, not a shard

wait_for_run_config = ckpt.wait_for_run_config


def settle(device: torch.device) -> None:
    """Wait until every copy this thread queued on ``device`` is done
    (the follower thread's, before it stages weights for the batcher)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class _Pending:
    """One admitted request waiting in the batch queue."""

    __slots__ = ("req_id", "inputs", "conn", "admitted_at", "deadline_at")

    def __init__(self, req_id, inputs, conn, admitted_at, deadline_at):
        self.req_id = req_id
        self.inputs = inputs
        self.conn = conn
        self.admitted_at = admitted_at
        self.deadline_at = deadline_at


class ServingReplica:
    """Load the newest digest-verified checkpoint and serve it; keep
    following publishes and hot-swap without dropping in-flight work.
    ``device`` defaults to ``cuda:0`` (an error without CUDA); the tests
    pass ``"cpu"``."""

    def __init__(self, train_dir: str | Path, serve_dir: str | Path = ".",
                 scfg: ServeConfig | None = None,
                 cfg: ExperimentConfig | None = None, device=None):
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
        # serve.compute_dtype → precision.compute_dtype → the model's
        self.model = get_model(effective_model_config(cfg, serving=True))
        self.tier = self.scfg.precision_tier or "fp32"
        if self.tier not in SERVING_PRECISION_TIERS:
            raise ConfigError(
                f"serve.precision_tier={self.tier!r} is not a known "
                f"tier; valid tiers: {', '.join(SERVING_PRECISION_TIERS)}")
        self.follower = ckpt.CheckpointFollower(self.train_dir)
        # one predict per tier (fp32 now, a quant tier's at its first
        # sidecar install); the installed weights' predict flips with them
        self._tier_predict_fns: dict[str, Any] = {
            "fp32": build_tier_predict(self.model, "fp32", self.device)}
        self._predict = None

        # current weights (batcher-owned) + the buffer the follower
        # stages, flipped at a batch boundary
        self._params = None
        self.model_step = -1
        self.model_digest: str | None = None
        self.model_tier: str | None = None      # the tier installed
        self.model_source_digest: str | None = None
        # the step a sidecar fallback was journaled for: once a publish,
        # not once a poll
        self._quant_fallback_step: int | None = None
        self._staged: tuple | None = None
        self._staged_lock = threading.Lock()

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
        self.batches = 0
        self.batch_sizes: collections.Counter[int] = collections.Counter()

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

    def _tier_predict(self, tier: str):
        """A tier's predict, built once per tier. The bf16 tier
        computes in bfloat16 unless ``serve.compute_dtype`` names a
        dtype."""
        fn = self._tier_predict_fns.get(tier)
        if fn is None:
            model = self.model
            if tier == "bf16" and not self.cfg.serve.compute_dtype:
                model = get_model(dataclasses.replace(
                    effective_model_config(self.cfg, serving=True),
                    compute_dtype="bfloat16"))
            fn = self._tier_predict_fns[tier] = build_tier_predict(
                model, tier, self.device)
        return fn

    def _params_on_device(self, tree: dict):
        """A restored params tree (numpy, the reference layout) as the
        port's params on this replica's device, float32 as saved."""
        return params_from_reference(tree, device=self.device)

    def _read_quant_tier(self, step: int, t0: float):
        """The sidecar half of the follower's read: a digest-verified
        sidecar holding the configured tier → a staged install;
        anything else journals ``follow_quant_sidecar_fallback`` (once
        a step) and returns None, so the read falls through to the
        full-precision artifact."""
        def fallback(reason: str):
            if self._quant_fallback_step != step:
                self._quant_fallback_step = step
                self._journal({"action": "follow_quant_sidecar_fallback",
                               "step": step, "tier": self.tier,
                               "reason": reason})
            return None
        try:
            payload = ckpt.read_quant_sidecar(self.train_dir, step)
            tiers = payload["tiers"]
            if self.tier not in tiers:
                raise KeyError(
                    f"sidecar has tiers {sorted(tiers)}, not "
                    f"{self.tier!r}")
        except FileNotFoundError:
            return fallback("sidecar_absent")
        except (OSError, ValueError, KeyError) as e:
            # ValueError covers CheckpointCorruptError: a torn sidecar
            # is never served
            return fallback(f"{type(e).__name__}: {e}")
        if step <= self.model_step:
            return ("noswap", step)
        params = params_from_reference(tiers[self.tier], device=self.device)
        settle(self.device)
        meta = payload.get("meta") or {}
        return ("swap", {
            "params": params,
            "predict": self._tier_predict(self.tier),
            "step": step,
            "digest": ckpt.quant_sidecar_digest(self.train_dir, step),
            "tier": self.tier,
            "source_artifact": ckpt.quant_sidecar_path(
                self.train_dir, step).name,
            "source_digest": meta.get("source_params_digest"),
        }, t0)

    def _read_weights(self, ptr_step: int):
        """The follower's ``read``: the tier's sidecar first (when
        ``serve.precision_tier`` names one), then the digest-verified
        full-precision restore with fallback to the previous loadable
        step. Returns ``("swap", staged, t0)``, ``("noswap", step)`` when
        the fallback landed on weights already served, or None."""
        t0 = time.time()
        if self.tier != "fp32":
            got = self._read_quant_tier(ptr_step, t0)
            if got is not None:
                return got
        on_event = lambda rec: self._journal(
            {"action": "follow_" + rec.get("action", "?"),
             **{k: v for k, v in rec.items()
                if k not in ("layer", "action")}})
        restored = ckpt.restore_params(self.train_dir, on_event=on_event)
        if restored is None:
            return None
        tree, _, at_step = restored
        if at_step <= self.model_step:
            # the newest publish was unusable and the fallback landed on
            # what is served: consume the pointer step
            return ("noswap", at_step)
        params = self._params_on_device(tree)
        settle(self.device)
        digest = ckpt.artifact_digest(self.train_dir, at_step)
        return ("swap", {
            "params": params, "predict": self._tier_predict("fp32"),
            "step": at_step, "digest": digest, "tier": "fp32",
            "source_artifact": f"ckpt-{at_step:08d}.msgpack",
            "source_digest": digest,
        }, t0)

    def _install(self, staged: dict, t0: float, initial: bool = False,
                 extra: dict | None = None) -> None:
        """Flip the staged weights in (batcher or boot thread) and
        journal the swap with its tier and source; ``extra`` adds the
        decode replica's ``sequences_pinned`` / ``sequences_restarted``."""
        prev = self.model_step
        self._params = staged["params"]
        self._predict = staged["predict"]
        self.model_step = staged["step"]
        self.model_digest = staged["digest"]
        self.model_tier = staged["tier"]
        self.model_source_digest = staged["source_digest"]
        self.swaps += 1
        rec = {"action": "weight_swap", "step": staged["step"],
               "from_step": prev, "digest": staged["digest"],
               "tier": staged["tier"],
               "source_artifact": staged["source_artifact"],
               "source_digest": staged["source_digest"],
               "swap_ms": round((time.time() - t0) * 1e3, 3),
               **(extra or {})}
        if initial:
            rec["initial"] = True
        self._journal(rec)

    def _load_initial(self, timeout_s: float = 600.0) -> None:
        deadline = time.time() + timeout_s
        while time.time() < deadline and not self._stop.is_set():
            got = self.follower.poll(self._read_weights)
            if got is not None and got[0] == "swap":
                _, staged, t0 = got
                self._install(staged, t0, initial=True)
                return
            time.sleep(min(1.0, self.scfg.poll_secs))
        raise TimeoutError(
            f"no loadable checkpoint in {self.train_dir} within "
            f"{timeout_s:.0f}s")

    def _follow_loop(self) -> None:
        while not self._stop.is_set():
            try:
                got = self.follower.poll(self._read_weights)
            except Exception as e:  # the service must outlive any read
                logger.warning("checkpoint follow failed (%s: %s)",
                               type(e).__name__, e)
                got = None
            if got is not None and got[0] == "swap":
                with self._staged_lock:
                    self._staged = got[1:]
            self._stop.wait(self.scfg.poll_secs)

    def _maybe_swap(self) -> None:
        """Batch-boundary flip: the batch in flight drained on the old
        weights; installing the staged buffer is one assignment."""
        with self._staged_lock:
            staged, self._staged = self._staged, None
        if staged is None:
            return
        install, t0 = staged
        if install["step"] <= self.model_step:
            return  # monotone: never swap backwards
        self._install(install, t0)

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

    def _meta(self) -> dict:
        return {"status": "ok", "meta": True,
                "model": self.cfg.model.name,
                "input_shape": list(self.model.input_shape),
                "input_dtype": str(np.dtype(self.model.input_dtype)),
                "model_step": self.model_step,
                "precision_tier": self.tier,
                "active_tier": self.model_tier,
                "model_digest": self.model_digest,
                "tier_source_digest": self.model_source_digest,
                "max_batch": self.scfg.max_batch,
                "device": str(self.device)}

    def _build_item(self, req: dict, conn) -> _Pending | None:
        """Validate one request into a queue item, or send the typed
        ``bad_request`` and return None. The decode replica parses
        ``prompt`` requests instead."""
        req_id = req.get("id")
        try:
            inputs = np.asarray(req["inputs"],
                                dtype=np.dtype(self.model.input_dtype))
        except (KeyError, ValueError, TypeError, OverflowError):
            self._reject(conn, req_id, "bad_request", admitted=False)
            return None
        if tuple(inputs.shape) != tuple(self.model.input_shape):
            self._reject(conn, req_id, "bad_request", admitted=False)
            return None
        now = time.time()
        deadline_ms = req.get("deadline_ms",
                              self.scfg.default_deadline_ms)
        return _Pending(req_id, inputs, conn, now,
                        now + float(deadline_ms) / 1e3)

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

    # -- the batcher --------------------------------------------------

    @staticmethod
    def _bucket(n: int, max_batch: int) -> int:
        """The smallest power of 2 >= n, capped at ``max_batch``."""
        b = 1
        while b < n and b < max_batch:
            b *= 2
        return min(b, max_batch)

    def _gather(self) -> list[_Pending]:
        """Pop up to ``max_batch`` requests: block briefly for the
        first, then drain whatever arrives within the batch window."""
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return []
        items = [first]
        deadline = time.monotonic() + self.scfg.batch_window_ms / 1e3
        while len(items) < self.scfg.max_batch:
            remaining = deadline - time.monotonic()
            try:
                items.append(self._queue.get(timeout=max(0.0, remaining)))
            except queue.Empty:
                break
        return items

    def _run_batch(self, items: list[_Pending]) -> None:
        now = time.time()
        live: list[_Pending] = []
        for it in items:
            if now >= it.deadline_at:
                self._reject(it.conn, it.req_id, "deadline_exceeded",
                             admitted=True)
            else:
                live.append(it)
        if not live:
            return
        bucket = self._bucket(len(live), self.scfg.max_batch)
        x = np.zeros((bucket, *self.model.input_shape),
                     np.dtype(self.model.input_dtype))
        for i, it in enumerate(live):
            x[i] = it.inputs
        step, digest, tier = (self.model_step, self.model_digest,
                              self.model_tier)
        probs = self._predict(self._params, x)
        if isinstance(probs, torch.Tensor):
            probs = probs.float().cpu().numpy()
        self.batches += 1
        self.batch_sizes[len(live)] += 1
        for i, it in enumerate(live):
            p = probs[i]
            self._terminal(
                "respond", it.req_id, model_step=step, tier=tier,
                batch=len(live), bucket=bucket,
                latency_ms=round((time.time() - it.admitted_at) * 1e3, 3))
            payload = {
                "id": it.req_id, "status": "ok", "model_step": step,
                "model_digest": digest, "tier": tier,
                "prediction": int(np.argmax(p)),
                "probs": [round(float(v), 6) for v in p]}
            # cached before sending: a retry after a send that died
            # mid-wire finds the completed outcome here
            self._dedup_put(it.req_id, payload)
            self._respond(it.conn, payload)

    def _batch_loop(self) -> None:
        while not self._stop.is_set():
            self._maybe_swap()
            items = self._gather()
            if items:
                self._run_batch(items)
            self._maybe_heartbeat()
        # graceful drain: everything still queued gets a TYPED reject
        while True:
            try:
                it = self._queue.get_nowait()
            except queue.Empty:
                break
            self._reject(it.conn, it.req_id, "shutting_down", admitted=True)
        self._maybe_heartbeat()

    # -- lifecycle ----------------------------------------------------

    def start(self) -> None:
        """Load the newest loadable checkpoint, bind, start the
        follower, accept and batcher threads, publish ``serve.json``.
        One start per replica object."""
        endpoint_path = self.serve_dir / "serve.json"
        endpoint_path.unlink(missing_ok=True)  # stale incarnation
        self._load_initial()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.scfg.host, self.scfg.port))
        self._sock.listen(128)
        self.bound_port = self._sock.getsockname()[1]
        for target in (self._follow_loop, self._accept_loop,
                       self._batch_loop):
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
            first_stop = not self._journal_closed
            self._journal_closed = True
            self._serve_log.close()
            self._heartbeat.close()
        if not first_stop:
            return
        with open(self.serve_dir / "kernel_launches.jsonl", "a") as fh:
            fh.write(json.dumps({
                "pid": os.getpid(), "time": time.time(),
                "device": str(self.device),
                "launches": self.kernel_launches(),
                "kernel_cache": cache_stats()}) + "\n")

    def kernel_launches(self) -> dict[str, int]:
        """The launches this process made of the kernels a replica can
        run, by kernel: K1 (the flash forward of a transformer's
        predict or prefill) and K5 (paged attention), from the
        wrappers' counters (which a CPU tensor leaves at 0)."""
        return {"K1": flash_attention_bshd.launches,
                "K5": paged_attention.launches}

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
