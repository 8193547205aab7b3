"""Round-robin failover client for the serving replicas (≙
``distributedmnist_tpu/servesvc/client.py``).

N interchangeable replicas behind one client, and a request never
depends on any single replica staying alive. Each request gets a
**deadline** and a **bounded retry budget with backoff**; a dead, hung,
restarting or load-shedding replica costs one attempt and the next
attempt goes to the next replica (round-robin). Every request ends in
exactly one terminal outcome:

* ``{"status": "ok", ...}`` — a replica answered;
* ``{"status": "rejected", ...}`` — a non-retryable typed reject
  (``bad_request``, ``deadline_exceeded``);
* ``{"status": "error", "reason": "unavailable" | "deadline_exceeded"}``
  — the budget or the deadline ran out first.

``overloaded`` and ``shutting_down`` rejects are retried (that replica
shed load; a sibling may have room). An endpoint whose attempt failed
at the transport (refused, reset, timed out) is quarantined for a
jittered, exponentially growing window, cleared by any success; when
every endpoint is benched the rotation ignores the bench.

Endpoints come from a list or a zero-argument callable returning one,
re-read every attempt, so a replica restarted onto a fresh port (its
``serve.json`` rewritten) is picked up without a client restart.
"""

from __future__ import annotations

import itertools
import json
import random
import socket
import threading
import time
from pathlib import Path
from typing import Any, Callable

from ..core.log import get_logger

logger = get_logger("serveclient")

RETRYABLE_REJECTS = ("overloaded", "shutting_down")


def discover_endpoints(cluster_root: str | Path) -> list[dict[str, Any]]:
    """Scan a cluster root's ``worker*/serve.json`` ready files (one
    replica a worker dir) → ``[{"worker", "host", "port"}, ...]``
    (sorted by worker id). Torn or stale files are skipped — the client
    treats a bad endpoint as one failed attempt anyway."""
    out: list[dict[str, Any]] = []
    root = Path(cluster_root)
    for f in sorted(root.glob("worker*/serve.json")):
        name = f.parent.name[len("worker"):]
        try:
            d = json.loads(f.read_text())
            out.append({"worker": int(name) if name.isdigit() else name,
                        "host": d["host"], "port": int(d["port"])})
        except (OSError, ValueError, KeyError):
            continue
    return out


class ServeClient:
    """Thread-safe round-robin client over N serving replicas.
    ``endpoints``: ``[(host, port), ...]``, ``[{"host", "port"}, ...]``
    or a zero-argument callable returning either."""

    def __init__(self,
                 endpoints: (list[dict] | list[tuple]
                             | Callable[[], list[dict]]),
                 deadline_s: float = 2.0, max_attempts: int = 4,
                 backoff_s: float = 0.05,
                 quarantine_s: float = 0.25,
                 quarantine_max_s: float = 5.0, seed: int = 0):
        self._endpoints_fn = (endpoints if callable(endpoints)
                              else (lambda: endpoints))
        self.deadline_s = deadline_s
        self.max_attempts = max_attempts
        self.backoff_s = backoff_s
        # partition-aware endpoint quarantine: an endpoint whose
        # attempt failed at the TRANSPORT (refused, reset, timed out —
        # a partitioned or half-open link) is benched for a jittered,
        # exponentially-growing window so retries stop stampeding the
        # dead link; any success clears it, and when EVERY endpoint is
        # benched the rotation ignores the bench entirely (quarantine
        # narrows the search, it never causes a total lockout).
        self.quarantine_s = quarantine_s
        self.quarantine_max_s = quarantine_max_s
        self._rng = random.Random(seed)
        self._quarantined_until: dict[tuple[str, int], float] = {}
        self._failures: dict[tuple[str, int], int] = {}
        self._rr = itertools.count()
        self._lock = threading.Lock()

    @staticmethod
    def _as_ep(ep) -> tuple[str, int]:
        if isinstance(ep, dict):
            return ep["host"], int(ep["port"])
        return ep[0], int(ep[1])

    def _next_endpoint(self) -> tuple[str, int] | None:
        eps = self._endpoints_fn()
        if not eps:
            return None
        now = time.monotonic()
        with self._lock:
            live = [e for e in eps
                    if self._quarantined_until.get(self._as_ep(e), 0.0)
                    <= now]
            pool = live or eps
            i = next(self._rr)
        return self._as_ep(pool[i % len(pool)])

    def _jitter(self) -> float:
        with self._lock:
            return 1.0 + 0.25 * (2.0 * self._rng.random() - 1.0)

    def _note_failure(self, host: str, port: int) -> None:
        ep = (host, port)
        with self._lock:
            n = self._failures.get(ep, 0) + 1
            self._failures[ep] = n
            hold = min(self.quarantine_max_s,
                       self.quarantine_s * 2.0 ** (n - 1))
            hold *= 1.0 + 0.25 * (2.0 * self._rng.random() - 1.0)
            self._quarantined_until[ep] = time.monotonic() + hold

    def _note_success(self, host: str, port: int) -> None:
        ep = (host, port)
        with self._lock:
            self._failures.pop(ep, None)
            self._quarantined_until.pop(ep, None)

    def quarantined(self) -> list[tuple[str, int]]:
        """Endpoints currently benched (for tests/introspection)."""
        now = time.monotonic()
        with self._lock:
            return sorted(ep for ep, t in self._quarantined_until.items()
                          if t > now)

    def _one_attempt(self, payload: bytes, host: str, port: int,
                     timeout_s: float) -> dict:
        with socket.create_connection((host, port),
                                      timeout=timeout_s) as conn:
            conn.settimeout(timeout_s)
            conn.sendall(payload)
            buf = b""
            while b"\n" not in buf:
                chunk = conn.recv(65536)
                if not chunk:
                    raise OSError("connection closed mid-response")
                buf += chunk
            return json.loads(buf.decode())

    def _failover_loop(self, request_id,
                       deadline_s: float | None, attempt) -> dict:
        """The ONE failover/retry engine both request shapes share:
        rotate endpoints, bound attempts and the deadline, back off
        between tries, and classify outcomes — ``attempt(host, port,
        remaining, attempts, t0)`` performs one wire exchange and
        returns the raw response dict (raising ``OSError``/
        ``ValueError`` for a dead/garbled replica). A retryable typed
        reject (``overloaded``/``shutting_down``: that replica shed
        load, a sibling may have room) costs one attempt; anything
        else terminal is returned enriched with ``attempts``/
        ``endpoint``/``latency_ms``."""
        deadline_s = self.deadline_s if deadline_s is None else deadline_s
        t0 = time.time()
        deadline = t0 + deadline_s
        last_reason = "unavailable"
        attempts = 0
        while attempts < self.max_attempts:
            remaining = deadline - time.time()
            if remaining <= 0:
                last_reason = "deadline_exceeded"
                break
            ep = self._next_endpoint()
            if ep is None:
                attempts += 1
                time.sleep(min(self.backoff_s * attempts, remaining))
                continue
            host, port = ep
            attempts += 1
            try:
                resp = attempt(host, port, remaining, attempts, t0)
            except (OSError, ValueError) as e:
                # transport-level failure: quarantine the endpoint
                # (partition-aware — the next attempts rotate PAST the
                # dead link) and back off with seeded jitter so N
                # retrying clients don't re-stampede in lockstep
                logger.debug("attempt %d via %s:%d failed: %s",
                             attempts, host, port, e)
                self._note_failure(host, port)
                time.sleep(min(self.backoff_s * attempts * self._jitter(),
                               max(0.0, deadline - time.time())))
                continue
            self._note_success(host, port)
            status = resp.get("status")
            out = {**resp, "attempts": attempts,
                   "retried": attempts > 1,
                   "endpoint": f"{host}:{port}",
                   "latency_ms": round((time.time() - t0) * 1e3, 3)}
            if (status == "rejected"
                    and resp.get("reason") in RETRYABLE_REJECTS):
                time.sleep(min(self.backoff_s * attempts * self._jitter(),
                               max(0.0, deadline - time.time())))
                continue
            return out  # ok / typed non-retryable / unknown: terminal
        return {"id": request_id, "status": "error", "reason": last_reason,
                "attempts": attempts, "retried": attempts > 1,
                "latency_ms": round((time.time() - t0) * 1e3, 3)}

    def request(self, inputs, request_id=None,
                deadline_s: float | None = None) -> dict:
        """One request → one terminal outcome dict (never raises for
        server/network trouble; see module docstring). The outcome
        carries ``latency_ms``, ``attempts``, and the answering
        replica's ``endpoint`` when one answered."""
        def attempt(host, port, remaining, attempts, t0):
            req = {"id": request_id, "inputs": inputs,
                   "deadline_ms": round(remaining * 1e3, 1)}
            return self._one_attempt(
                (json.dumps(req) + "\n").encode(), host, port,
                timeout_s=remaining)

        return self._failover_loop(request_id, deadline_s, attempt)

    def _stream_attempt(self, payload: bytes, host: str, port: int,
                        timeout_s: float,
                        on_token) -> tuple[dict, list[float], list]:
        """One streaming attempt: send, then read token lines until
        the terminal line. Returns (terminal, token_times, tokens)."""
        with socket.create_connection((host, port),
                                      timeout=timeout_s) as conn:
            conn.settimeout(timeout_s)
            conn.sendall(payload)
            buf = b""
            tokens: list = []
            token_times: list[float] = []
            while True:
                while b"\n" not in buf:
                    chunk = conn.recv(65536)
                    if not chunk:
                        raise OSError("connection closed mid-stream")
                    buf += chunk
                line, _, buf = buf.partition(b"\n")
                rec = json.loads(line.decode())
                if "status" in rec:
                    return rec, token_times, tokens
                if rec.get("stream") == "token":
                    tokens.append(rec.get("token"))
                    token_times.append(time.time())
                    if on_token is not None:
                        on_token(rec)
                elif rec.get("stream") == "restart":
                    # a server-side swap-policy restart: the replica
                    # regenerates on new weights — reset accumulation
                    tokens = []
                    token_times = []
                    if on_token is not None:
                        on_token(rec)

    def generate(self, prompt, request_id=None,
                 deadline_s: float | None = None,
                 max_tokens: int | None = None,
                 temperature: float | None = None,
                 top_k: int | None = None,
                 on_token=None) -> dict:
        """One generation request → one terminal outcome dict, with
        tokens streamed through ``on_token`` as they arrive. Same
        failover/retry/terminal semantics as :meth:`request` (the
        shared :meth:`_failover_loop`); a connection lost MID-STREAM
        costs one attempt and the whole generation retries on a
        sibling — accumulated tokens reset, and ``on_token`` receives
        the same ``{"stream": "restart"}`` signal a server-side
        swap-restart sends, so a consumer never keeps a duplicated
        prefix. The outcome carries ``ttft_ms`` (first token latency),
        ``itl_ms`` (mean inter-token gap) and ``tokens`` alongside the
        usual ``latency_ms``/``attempts``/``endpoint``."""
        def attempt(host, port, remaining, attempts, t0):
            req: dict[str, Any] = {"id": request_id, "prompt": prompt,
                                   "deadline_ms": round(remaining * 1e3,
                                                        1)}
            if max_tokens is not None:
                req["max_tokens"] = max_tokens
            if temperature is not None:
                req["temperature"] = temperature
            if top_k is not None:
                req["top_k"] = top_k
            attempt_t0 = time.time()
            streamed_any = False

            def _tap(rec):
                nonlocal streamed_any
                streamed_any = True
                if on_token is not None:
                    on_token(rec)

            try:
                resp, token_times, tokens = self._stream_attempt(
                    (json.dumps(req) + "\n").encode(), host, port,
                    timeout_s=remaining, on_token=_tap)
            except (OSError, ValueError):
                if streamed_any and on_token is not None:
                    # client-side failover mid-stream: the next
                    # attempt regenerates from scratch on a sibling —
                    # give the consumer the protocol's own reset
                    # signal, or its accumulated prefix silently
                    # duplicates
                    on_token({"id": request_id, "stream": "restart",
                              "reason": "failover"})
                raise
            if resp.get("status") == "ok":
                resp.setdefault("tokens", tokens)
                resp["tokens_streamed"] = len(resp["tokens"] or [])
                if token_times:
                    resp["ttft_ms"] = round(
                        (token_times[0] - attempt_t0) * 1e3, 3)
                if len(token_times) > 1:
                    gaps = [b - a for a, b in zip(token_times,
                                                  token_times[1:])]
                    resp["itl_ms"] = round(
                        sum(gaps) / len(gaps) * 1e3, 3)
            return resp

        return self._failover_loop(request_id, deadline_s, attempt)

    def meta(self, deadline_s: float | None = None) -> dict | None:
        """Model metadata from any live replica (input shape/dtype —
        what a load generator needs to fabricate requests), or None."""
        deadline_s = self.deadline_s if deadline_s is None else deadline_s
        deadline = time.time() + deadline_s
        payload = (json.dumps({"meta": True}) + "\n").encode()
        for _ in range(self.max_attempts):
            remaining = deadline - time.time()
            if remaining <= 0:
                return None
            ep = self._next_endpoint()
            if ep is None:
                time.sleep(min(self.backoff_s, remaining))
                continue
            try:
                return self._one_attempt(payload, ep[0], ep[1],
                                         timeout_s=remaining)
            except (OSError, ValueError):
                time.sleep(min(self.backoff_s,
                               max(0.0, deadline - time.time())))
        return None
