"""Closed-loop load generator for the serving tier (≙
``distributedmnist_tpu/servesvc/loadgen.py``).

``concurrency`` workers each keep exactly one request in flight
(closed-loop: the next request is issued only when the previous one
reached a terminal outcome), so offered load is bounded and the
latency distribution is measurable instead of collapsing into queueing
divergence. Every request is journaled twice — ``issue`` when sent,
``outcome`` when terminal — which is the artifact the serving
invariants replay: a request with no outcome is a DROP, and the whole
point of the serving tier is that there are none.

The summary carries p50/p99 latency over successful responses, the
reject/error tallies by typed reason, the distinct model steps the
responses were served from (evidence that a hot-swap happened
mid-sweep), and ``dropped`` (issued − terminal; must be 0).
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np

from ..core.log import JsonlSink
from .client import ServeClient


def _percentile(sorted_vals: list[float], q: float) -> float:
    idx = min(len(sorted_vals) - 1,
              max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def make_input_fn(shape, dtype: str, vocab: int = 256
                  ) -> Callable[[int], list]:
    """Deterministic per-request inputs: request ``i`` is always the
    same array, so any replica (and any retry) sees identical bytes."""
    shape = tuple(shape)
    np_dtype = np.dtype(dtype)

    def make(i: int) -> list:
        rng = np.random.default_rng(i)
        if np_dtype.kind in "iu":
            return rng.integers(0, vocab, size=shape).astype(
                np_dtype).tolist()
        return (rng.random(size=shape).astype(np_dtype) - 0.5).tolist()

    return make


def make_prompt_fn(vocab: int, max_prompt_len: int,
                   min_prompt_len: int = 2) -> Callable[[int], list]:
    """Deterministic per-request prompts for the decode service:
    request ``i`` is always the same token list, with lengths spread
    across [min, max] — the wildly-different-lengths mix the paged
    cache exists to batch into one compiled shape."""
    lo = max(1, min_prompt_len)
    hi = max(lo, max_prompt_len)

    def make(i: int) -> list:
        rng = np.random.default_rng(i)
        n = int(rng.integers(lo, hi + 1))
        return rng.integers(0, vocab, size=(n,)).astype(int).tolist()

    return make


def run_load(client: ServeClient, num_requests: int | None,
             concurrency: int, make_input: Callable[[int], Any],
             journal_path: str | Path | None = None,
             stop_event: threading.Event | None = None,
             deadline_s: float | None = None,
             decode: bool = False,
             window_s: float = 0.0,
             snapshot_every_s: float = 0.0,
             first_id: int = 0) -> dict[str, Any]:
    """Drive the cluster closed-loop until ``num_requests`` terminal
    outcomes (or ``stop_event``, whichever first; one of the two must
    be provided). Returns the summary; journals to ``journal_path``.

    ``decode``: drive the generation path (``make_input`` yields token
    prompts, requests go through :meth:`ServeClient.generate`) — the
    outcome records then carry the two decode latency numbers
    alongside e2e: ``ttft_ms`` (time-to-first-token) and ``itl_ms``
    (mean per-token inter-arrival), and the summary aggregates their
    p50/p99 plus total ``tokens_streamed``.

    ``window_s`` > 0 (with a journal) turns on rolling-window pressure
    snapshots: every ``snapshot_every_s`` (defaults to ``window_s/2``)
    a ``{"event": "load", "action": "window"}`` record summarizing the
    last ``window_s`` seconds of outcomes lands in the journal — the
    live signal a poller (and a human tailing the file) reads, where
    the end-of-run summary only exists after the fact.

    ``first_id``: the id of the first request (then one up each). Legs
    of one trace that share a journal and a set of replicas start where
    the last leg's ids ended, so no id repeats: a replica's dedup cache
    answers a repeated id from its cache, and the serving books would
    then count one request twice. The reference numbers every call from
    0."""
    if num_requests is None and stop_event is None:
        raise ValueError("run_load needs num_requests or stop_event")
    sink = JsonlSink(journal_path) if journal_path is not None else None
    sink_lock = threading.Lock()
    counter = iter(range(first_id, 1 << 62))
    outcomes: list[dict] = []
    out_lock = threading.Lock()
    issued = [0]
    t_start = time.time()

    def journal(rec: dict) -> None:
        if sink is not None:
            with sink_lock:
                sink.write(rec)

    def should_stop() -> bool:
        return stop_event is not None and stop_event.is_set()

    def worker() -> None:
        while not should_stop():
            with out_lock:
                if num_requests is not None and issued[0] >= num_requests:
                    return
                issued[0] += 1
                rid = next(counter)
            journal({"event": "load", "action": "issue", "id": rid,
                     "time": time.time()})
            if decode:
                got = client.generate(make_input(rid), request_id=rid,
                                      deadline_s=deadline_s)
            else:
                got = client.request(make_input(rid), request_id=rid,
                                     deadline_s=deadline_s)
            rec = {"event": "load", "action": "outcome", "id": rid,
                   "time": time.time(), "status": got.get("status"),
                   "reason": got.get("reason"),
                   "model_step": got.get("model_step"),
                   # which precision tier actually answered — the
                   # loadgen artifact's record of what a sweep measured
                   "tier": got.get("tier"),
                   "attempts": got.get("attempts"),
                   # retry amplification is measured, not inferred:
                   # True exactly when the terminal took > 1 attempt
                   "retried": bool(got.get("retried")),
                   "endpoint": got.get("endpoint"),
                   "latency_ms": got.get("latency_ms")}
            if decode:
                # decode latency is two numbers, not one: when the
                # first token landed, and how fast they kept coming
                rec["ttft_ms"] = got.get("ttft_ms")
                rec["itl_ms"] = got.get("itl_ms")
                rec["tokens"] = got.get("tokens_streamed")
            journal(rec)
            with out_lock:
                outcomes.append(rec)

    threads = [threading.Thread(target=worker, daemon=True,
                                name=f"loadgen-{i}")
               for i in range(max(1, concurrency))]
    for t in threads:
        t.start()

    done = threading.Event()

    def snapshotter() -> None:
        every = snapshot_every_s if snapshot_every_s > 0 else window_s / 2
        while not done.wait(every):
            with out_lock:
                snap = summarize_window(outcomes, issued[0],
                                        time.time(), window_s)
            journal({"event": "load", "action": "window",
                     "time": time.time(), **snap})

    snap_thread = None
    if sink is not None and window_s > 0:
        snap_thread = threading.Thread(target=snapshotter, daemon=True,
                                       name="loadgen-window")
        snap_thread.start()

    for t in threads:
        # closed-loop workers exit on their own (count reached or stop
        # set); the join bounds a wedged worker by its own deadline
        t.join()
    duration = time.time() - t_start
    if snap_thread is not None:
        done.set()
        snap_thread.join()
    if sink is not None:
        sink.close()
    return summarize_outcomes(outcomes, issued[0], duration)


def summarize_window(outcomes: list[dict], issued: int, now: float,
                     window_s: float) -> dict[str, Any]:
    """The rolling-window pressure snapshot — a pure function of the
    outcome records whose ``time`` falls in ``[now - window_s, now]``
    (deterministic in its inputs). Latency/TTFT percentiles appear only when the
    window saw ok responses carrying them."""
    recent = [r for r in outcomes
              if isinstance(r.get("time"), (int, float))
              and r["time"] >= now - window_s]
    ok = [r for r in recent if r.get("status") == "ok"]
    rejected = [r for r in recent if r.get("status") == "rejected"]
    errors = [r for r in recent if r.get("status") == "error"]
    retried = [r for r in recent if r.get("retried")]
    out: dict[str, Any] = {
        "window_s": window_s,
        "issued": issued,
        "terminal": len(recent),
        "responses": len(ok),
        "rejected": len(rejected),
        "errors": len(errors),
        "reject_rate": round(len(rejected) / max(1, len(recent)), 4),
        # retry amplification under faults, surfaced live: the share
        # of window terminals that needed more than one attempt
        "retried": len(retried),
        "retry_rate": round(len(retried) / max(1, len(recent)), 4),
        "throughput_rps": round(len(recent) / max(window_s, 1e-9), 2),
    }
    lat = sorted(r["latency_ms"] for r in ok
                 if isinstance(r.get("latency_ms"), (int, float)))
    if lat:
        out["p50_ms"] = _percentile(lat, 0.50)
        out["p99_ms"] = _percentile(lat, 0.99)
    ttft = sorted(r["ttft_ms"] for r in ok
                  if isinstance(r.get("ttft_ms"), (int, float)))
    if ttft:
        out["ttft_p50_ms"] = _percentile(ttft, 0.50)
        out["ttft_p99_ms"] = _percentile(ttft, 0.99)
    return out


def _tail_records(path: str | Path, tail_bytes: int):
    """Intact dict records of a live JSONL file's last ``tail_bytes``,
    newest first; blank, torn and non-dict lines are skipped (the writer
    may be mid-append, the window may start mid-line)."""
    try:
        with open(Path(path), "rb") as f:
            f.seek(0, 2)
            f.seek(max(0, f.tell() - tail_bytes))
            text = f.read().decode("utf-8", errors="replace")
    except OSError:
        return
    for line in reversed(text.splitlines()):
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict):
            yield rec


def read_latest_window(journal_path: str | Path,
                       tail_bytes: int = 1 << 16) -> dict | None:
    """The newest ``window`` snapshot in a (possibly still-growing)
    loadgen journal, or None. Reads the file's tail and scans backwards
    past torn lines — a poller reads it against a journal another
    process is appending to. When the tail holds no snapshot (a busy
    leg can journal more than ``tail_bytes`` of outcomes between two),
    the tail doubles until it covers the whole file: the reference
    reads one 64 KiB tail and then answers None, which hides a snapshot
    that is there. How old the snapshot is stays the caller's question
    (``launch/broker.py collect_signals`` drops a stale one)."""
    try:
        size = Path(journal_path).stat().st_size
    except OSError:
        return None
    while True:
        for rec in _tail_records(journal_path, tail_bytes):
            if rec.get("event") == "load" and rec.get("action") == "window":
                return rec
        if tail_bytes >= size:
            return None
        tail_bytes *= 2


def summarize_outcomes(outcomes: list[dict], issued: int,
                       duration_s: float) -> dict[str, Any]:
    ok = [r for r in outcomes if r.get("status") == "ok"]
    rejected = [r for r in outcomes if r.get("status") == "rejected"]
    errors = [r for r in outcomes if r.get("status") == "error"]
    lat = sorted(r["latency_ms"] for r in ok
                 if isinstance(r.get("latency_ms"), (int, float)))
    by_reason: dict[str, int] = {}
    for r in rejected + errors:
        key = f"{r.get('status')}:{r.get('reason')}"
        by_reason[key] = by_reason.get(key, 0) + 1
    steps = sorted({r["model_step"] for r in ok
                    if isinstance(r.get("model_step"), int)})
    # which precision tier(s) answered; a pre-quantization journal has
    # no tier field — those responses count as fp32 (the legacy path)
    tiers = sorted({r.get("tier") or "fp32" for r in ok})
    out: dict[str, Any] = {
        "issued": issued,
        "terminal": len(outcomes),
        # issued − terminal: every request MUST reach a terminal
        # outcome; nonzero here is the silent drop the tier forbids
        "dropped": issued - len(outcomes),
        "responses": len(ok),
        "rejected": len(rejected),
        "errors": len(errors),
        "by_reason": by_reason,
        # terminals that took >1 attempt — under net faults this is the
        # retry amplification the dedup cache must absorb
        "retried": sum(1 for r in outcomes if r.get("retried")),
        "reject_rate": round(len(rejected) / max(1, len(outcomes)), 4),
        "duration_s": round(duration_s, 3),
        "throughput_rps": round(len(outcomes) / max(duration_s, 1e-9), 2),
        "model_steps_served": steps,
        "tiers_served": tiers,
    }
    if lat:
        out["latency_ms"] = {"p50": _percentile(lat, 0.50),
                             "p90": _percentile(lat, 0.90),
                             "p99": _percentile(lat, 0.99),
                             "max": lat[-1],
                             "mean": round(sum(lat) / len(lat), 3)}
    # decode sweeps: the per-request two-number latency split — TTFT
    # (prefill + queueing) and mean inter-token gap — aggregated only
    # when the records carry them (classification records don't)
    ttft = sorted(r["ttft_ms"] for r in ok
                  if isinstance(r.get("ttft_ms"), (int, float)))
    if ttft:
        out["ttft_ms"] = {"p50": _percentile(ttft, 0.50),
                          "p99": _percentile(ttft, 0.99),
                          "max": ttft[-1],
                          "mean": round(sum(ttft) / len(ttft), 3)}
    itl = sorted(r["itl_ms"] for r in ok
                 if isinstance(r.get("itl_ms"), (int, float)))
    if itl:
        out["inter_token_ms"] = {"p50": _percentile(itl, 0.50),
                                 "p99": _percentile(itl, 0.99),
                                 "max": itl[-1]}
    tokens = sum(r["tokens"] for r in ok
                 if isinstance(r.get("tokens"), int))
    if tokens:
        out["tokens_streamed"] = tokens
        out["tokens_per_sec"] = round(tokens / max(duration_s, 1e-9), 2)
    return out


def load_outcomes(journal_path: str | Path) -> tuple[list[dict],
                                                     list[dict]]:
    """(issues, outcomes) from a loadgen journal — what the serving
    invariants replay. A torn final line is skipped."""
    records = []
    path = Path(journal_path)
    for line in (path.read_text().splitlines() if path.exists() else ()):
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue  # torn tail write
        if isinstance(rec, dict) and rec.get("event") == "load":
            records.append(rec)
    return ([r for r in records if r.get("action") == "issue"],
            [r for r in records if r.get("action") == "outcome"])
