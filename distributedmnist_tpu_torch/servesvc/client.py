"""Round-robin failover client for decode replicas (≙
``distributedmnist_tpu/servesvc/client.py ServeClient``: ``meta`` and
``generate``).

N interchangeable replicas behind one client: each request gets a
deadline and a bounded retry budget with backoff; a dead, restarting
or load-shedding replica costs one attempt and the next attempt goes
to the next replica. Every request ends in exactly one terminal
outcome:

* ``{"status": "ok", ...}`` — a replica answered;
* ``{"status": "rejected", ...}`` — a non-retryable typed reject
  (``bad_request``, ``deadline_exceeded``);
* ``{"status": "error", "reason": "unavailable" | "deadline_exceeded"}``
  — the budget or the deadline ran out first.

``overloaded`` and ``shutting_down`` rejects are retried (that replica
shed load; a sibling may have room). The reference's endpoint
quarantine and one-shot classification ``request`` are not ported yet.
"""

from __future__ import annotations

import itertools
import json
import random
import socket
import threading
import time
from typing import Any, Callable

RETRYABLE_REJECTS = ("overloaded", "shutting_down")


class ServeClient:
    """Thread-safe round-robin client over N decode replicas.
    ``endpoints``: ``[(host, port), ...]``, ``[{"host", "port"}, ...]``
    or a zero-argument callable returning either (re-read every
    attempt)."""

    def __init__(self, endpoints: list | Callable[[], list],
                 deadline_s: float = 2.0, max_attempts: int = 4,
                 backoff_s: float = 0.05, seed: int = 0):
        self._endpoints_fn = (endpoints if callable(endpoints)
                              else (lambda: endpoints))
        self.deadline_s = deadline_s
        self.max_attempts = max_attempts
        self.backoff_s = backoff_s
        self._rng = random.Random(seed)
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
        with self._lock:
            i = next(self._rr)
        return self._as_ep(eps[i % len(eps)])

    def _backoff(self, attempts: int, deadline: float) -> None:
        with self._lock:
            jitter = 1.0 + 0.25 * (2.0 * self._rng.random() - 1.0)
        time.sleep(min(self.backoff_s * attempts * jitter,
                       max(0.0, deadline - time.time())))

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

    def _failover_loop(self, request_id, deadline_s: float | None,
                       attempt) -> dict:
        """Rotate endpoints under the attempt budget and the deadline;
        ``attempt(host, port, remaining)`` does one wire exchange and
        returns the raw response (raising ``OSError``/``ValueError`` for
        a dead or garbled replica)."""
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
            attempts += 1
            if ep is None:
                self._backoff(attempts, deadline)
                continue
            host, port = ep
            try:
                resp = attempt(host, port, remaining)
            except (OSError, ValueError):
                self._backoff(attempts, deadline)
                continue
            out = {**resp, "attempts": attempts, "retried": attempts > 1,
                   "endpoint": f"{host}:{port}",
                   "latency_ms": round((time.time() - t0) * 1e3, 3)}
            if (resp.get("status") == "rejected"
                    and resp.get("reason") in RETRYABLE_REJECTS):
                self._backoff(attempts, deadline)
                continue
            return out
        return {"id": request_id, "status": "error", "reason": last_reason,
                "attempts": attempts, "retried": attempts > 1,
                "latency_ms": round((time.time() - t0) * 1e3, 3)}

    def _stream_attempt(self, payload: bytes, host: str, port: int,
                        timeout_s: float, on_token
                        ) -> tuple[dict, list[float], list]:
        """Send, then read token lines until the terminal line."""
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

    def generate(self, prompt, request_id=None,
                 deadline_s: float | None = None,
                 max_tokens: int | None = None,
                 temperature: float | None = None,
                 top_k: int | None = None, on_token=None) -> dict:
        """One generation → one terminal outcome, tokens streamed
        through ``on_token``. An ``ok`` outcome carries ``tokens``,
        ``ttft_ms`` (first-token latency of the answering attempt) and
        ``itl_ms`` (mean inter-token gap) besides ``latency_ms``/
        ``attempts``/``endpoint``."""
        def attempt(host, port, remaining):
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
            resp, token_times, tokens = self._stream_attempt(
                (json.dumps(req) + "\n").encode(), host, port,
                timeout_s=remaining, on_token=on_token)
            if resp.get("status") == "ok":
                resp.setdefault("tokens", tokens)
                resp["tokens_streamed"] = len(resp["tokens"] or [])
                if token_times:
                    resp["ttft_ms"] = round(
                        (token_times[0] - attempt_t0) * 1e3, 3)
                if len(token_times) > 1:
                    gaps = [b - a for a, b in zip(token_times,
                                                  token_times[1:])]
                    resp["itl_ms"] = round(sum(gaps) / len(gaps) * 1e3, 3)
            return resp

        return self._failover_loop(request_id, deadline_s, attempt)

    def meta(self, deadline_s: float | None = None) -> dict | None:
        """Model metadata from any live replica, or None."""
        deadline_s = self.deadline_s if deadline_s is None else deadline_s
        deadline = time.time() + deadline_s
        payload = (json.dumps({"meta": True}) + "\n").encode()
        for attempts in range(1, self.max_attempts + 1):
            remaining = deadline - time.time()
            if remaining <= 0:
                return None
            ep = self._next_endpoint()
            if ep is None:
                self._backoff(attempts, deadline)
                continue
            try:
                return self._one_attempt(payload, ep[0], ep[1],
                                         timeout_s=remaining)
            except (OSError, ValueError):
                self._backoff(attempts, deadline)
        return None
