"""Seeded per-endpoint TCP chaos proxy for the serving tier (≙
``distributedmnist_tpu/launch/netchaos.py``, copied whole: sockets and
threads, no device).

arXiv:1604.00981 treats slow links and slow workers as one phenomenon;
TF-Replicator (arXiv:1902.00465) argues the fault model must cover the
transport, not just the process. This module is the transport half of
the chaos harness: a :class:`ChaosProxy` interposed between clients
and ONE serving replica's socket, executing a small script of network
faults — added latency/jitter, a bandwidth cap, a connection reset
after N bytes (mid-stream for decode), a half-open blackhole, and a
timed bidirectional partition window — each deterministic in the
chaos run's ``(seed, trial)`` and journaled as a schema-declared
``event:"fault" action:"net_*"`` record (``obsv/schema.py``) so the
replay invariants can license exactly what they observe.

The proxy is transparent to the protocol: it re-resolves its upstream
from the replica's ``serve.json`` on EVERY accepted connection, so a
replica restarted onto a fresh ephemeral port keeps being reachable
through the same proxy port — the client never learns the difference.

Fault script grammar (one dict per fault, the ``net_faults`` value of
``launch.exec.FaultPlan`` keyed by the proxied worker):

``{"kind": "latency", "delay_ms": d, "jitter_ms": j}``
    delay every request-direction chunk by ``d + U[0, j)`` ms (seeded).
``{"kind": "bandwidth", "bytes_per_s": r}``
    pace response-direction forwarding at ``r`` bytes/s.
``{"kind": "reset", "after_bytes": n}``
    cut the FIRST connection whose response stream passes ``n`` bytes
    — exactly at byte ``n``, with an RST (SO_LINGER 0) — so a decode
    stream dies mid-generation, after tokens flowed, before the
    terminal. Fires once.
``{"kind": "blackhole", "conn": c, "hold_s": h}``
    accept connection ordinal ``c`` and never speak: no upstream, no
    bytes, socket held open ``h`` seconds (the half-open peer a
    client-side deadline must bound). Fires once.
``{"kind": "partition", "start_s": s, "duration_s": d}``
    a bidirectional partition window ``[s, s+d)`` seconds after the
    proxy accepts its FIRST connection (not after start() — replicas
    spend a long boot serving nothing, and the window must land under
    live load): live connections are torn down and new ones refused
    for the duration. Journaled when the window opens, whether or not
    traffic was in flight at that instant.
"""

from __future__ import annotations

import json
import random
import socket
import struct
import threading
import time
from pathlib import Path
from typing import Callable

from ..core.log import get_logger

logger = get_logger("netchaos")

NET_FAULT_KINDS = ("latency", "bandwidth", "reset", "blackhole",
                   "partition")

# poll granularity for every blocking socket op inside the proxy — no
# recv/accept ever blocks unbounded
_TICK_S = 0.25
_UPSTREAM_CONNECT_TIMEOUT_S = 2.0
_CHUNK = 65536


class NetChaosError(RuntimeError):
    """A malformed net-fault script."""


def serve_json_resolver(serve_json: str | Path
                        ) -> Callable[[], tuple[str, int] | None]:
    """Upstream resolver reading a replica's ``serve.json`` ready file
    — re-read per connection, so restarts onto new ports are followed;
    torn/missing files resolve to None (the connection is refused and
    the client's failover retries)."""
    path = Path(serve_json)

    def resolve() -> tuple[str, int] | None:
        try:
            d = json.loads(path.read_text())
            return d["host"], int(d["port"])
        except (OSError, ValueError, KeyError):
            return None

    return resolve


def _validate_scripts(scripts: list[dict]) -> list[dict]:
    out = []
    for s in scripts:
        kind = s.get("kind")
        if kind not in NET_FAULT_KINDS:
            raise NetChaosError(
                f"unknown net fault kind {kind!r} — valid kinds: "
                f"{NET_FAULT_KINDS}")
        out.append(dict(s))
    return out


class ChaosProxy:
    """One seeded fault-injecting TCP proxy in front of one replica.

    ``journal`` is any callable taking one record dict (e.g.
    ``CommandExecutor.journal``); every fault firing lands there as a
    schema-declared ``event:"fault" action:"net_*"`` record carrying
    the proxied ``worker`` — the same shape process faults use, so the
    ``serve_outcomes`` faulted-replica exemption and invariant 13
    license them with no special cases.
    """

    def __init__(self, resolve_upstream, scripts: list[dict], *,
                 worker: int, journal=None, seed: int = 0,
                 listen_host: str = "127.0.0.1"):
        if isinstance(resolve_upstream, (str, Path)):
            resolve_upstream = serve_json_resolver(resolve_upstream)
        elif isinstance(resolve_upstream, tuple):
            ep = (resolve_upstream[0], int(resolve_upstream[1]))
            resolve_upstream = lambda: ep  # noqa: E731
        self._resolve = resolve_upstream
        self.scripts = _validate_scripts(scripts)
        self.worker = int(worker)
        self._journal_fn = journal
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()
        self._jlock = threading.Lock()
        self.listen_host = listen_host
        self.bound_port: int | None = None
        self._lsock: socket.socket | None = None
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._conn_lock = threading.Lock()
        self._open_socks: set[socket.socket] = set()
        self._conn_count = 0
        self._fired: set[str] = set()
        self._reset_done = False
        self._partition_until = 0.0
        self._started_at = 0.0
        self._first_conn = threading.Event()

    # -- bookkeeping ---------------------------------------------------

    def _journal(self, record: dict) -> None:
        if self._journal_fn is None:
            return
        with self._jlock:
            self._journal_fn(record)

    def _fire_once(self, key: str, record: dict) -> None:
        """Journal a continuously-applied fault's record exactly once."""
        with self._conn_lock:
            if key in self._fired:
                return
            self._fired.add(key)
        self._journal(record)

    @property
    def fired(self) -> set[str]:
        return set(self._fired)

    def _script(self, kind: str) -> dict | None:
        for s in self.scripts:
            if s["kind"] == kind:
                return s
        return None

    # -- lifecycle -----------------------------------------------------

    def start(self) -> int:
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind((self.listen_host, 0))
        lsock.listen(128)
        lsock.settimeout(_TICK_S)
        self._lsock = lsock
        self.bound_port = lsock.getsockname()[1]
        self._started_at = time.monotonic()
        t = threading.Thread(target=self._accept_loop,
                             name=f"netchaos-w{self.worker}", daemon=True)
        t.start()
        self._threads.append(t)
        part = self._script("partition")
        if part is not None:
            pt = threading.Thread(target=self._partition_timer,
                                  args=(float(part["start_s"]),
                                        float(part["duration_s"])),
                                  daemon=True)
            pt.start()
            self._threads.append(pt)
        logger.info("chaos proxy for worker %d on %s:%d (%d scripts)",
                    self.worker, self.listen_host, self.bound_port,
                    len(self.scripts))
        return self.bound_port

    def stop(self) -> None:
        self._stop.set()
        if self._lsock is not None:
            try:
                self._lsock.close()
            except OSError:
                pass
        with self._conn_lock:
            socks = list(self._open_socks)
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=5.0)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- partition window ----------------------------------------------

    def _partition_timer(self, start_s: float, duration_s: float) -> None:
        # the clock arms at FIRST live traffic, not proxy boot: the
        # window exists to cut a link the client is actually using
        while not self._stop.is_set() and not self._first_conn.wait(
                timeout=_TICK_S):
            pass
        if not self._stop.wait(timeout=start_s):
            with self._conn_lock:
                self._partition_until = time.monotonic() + duration_s
                socks = list(self._open_socks)
            for s in socks:
                _abort(s)
            self._journal({"event": "fault", "action": "net_partition",
                           "worker": self.worker, "time": time.time(),
                           "start_s": start_s, "duration_s": duration_s,
                           "conns_dropped": len(socks)})

    def _partitioned(self) -> bool:
        return time.monotonic() < self._partition_until

    # -- data path -----------------------------------------------------

    def _register(self, s: socket.socket) -> None:
        with self._conn_lock:
            self._open_socks.add(s)

    def _unregister(self, s: socket.socket) -> None:
        with self._conn_lock:
            self._open_socks.discard(s)

    def _accept_loop(self) -> None:
        assert self._lsock is not None
        while not self._stop.is_set():
            try:
                conn, _addr = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with self._conn_lock:
                n = self._conn_count
                self._conn_count += 1
            self._first_conn.set()
            if self._partitioned():
                _abort(conn)
                continue
            t = threading.Thread(target=self._handle_conn,
                                 args=(conn, n), daemon=True)
            t.start()
            self._threads.append(t)

    def _handle_conn(self, conn: socket.socket, n: int) -> None:
        conn.settimeout(_TICK_S)
        self._register(conn)
        try:
            bh = self._script("blackhole")
            if bh is not None and n == int(bh.get("conn", 0)) \
                    and f"blackhole:{n}" not in self._fired:
                self._fire_once(f"blackhole:{n}", {
                    "event": "fault", "action": "net_blackhole",
                    "worker": self.worker, "time": time.time(),
                    "hold_s": float(bh.get("hold_s", 5.0)), "conn": n})
                self._hold_half_open(conn, float(bh.get("hold_s", 5.0)))
                return
            ep = self._resolve()
            if ep is None:
                _abort(conn)
                return
            try:
                up = socket.create_connection(
                    ep, timeout=_UPSTREAM_CONNECT_TIMEOUT_S)
            except OSError:
                _abort(conn)
                return
            up.settimeout(_TICK_S)
            self._register(up)
            done = threading.Event()
            t = threading.Thread(target=self._pump_up,
                                 args=(conn, up, n, done), daemon=True)
            t.start()
            try:
                self._pump_down(up, conn, n)
            finally:
                done.set()
                for s in (up, conn):
                    try:
                        s.close()
                    except OSError:
                        pass
                self._unregister(up)
                t.join(timeout=5.0)
        finally:
            self._unregister(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _hold_half_open(self, conn: socket.socket, hold_s: float) -> None:
        """The half-open peer: the socket stays open, nothing is ever
        sent or read — the far end's deadline must bound the stall."""
        end = time.monotonic() + hold_s
        while not self._stop.is_set() and time.monotonic() < end:
            time.sleep(min(_TICK_S, max(0.0, end - time.monotonic())))

    def _pump_up(self, conn: socket.socket, up: socket.socket, n: int,
                 done: threading.Event) -> None:
        """client → server, with the latency fault applied."""
        lat = self._script("latency")
        while not self._stop.is_set() and not done.is_set():
            if self._partitioned():
                break
            try:
                chunk = conn.recv(_CHUNK)
            except socket.timeout:
                continue
            except OSError:
                break
            if not chunk:
                break
            if lat is not None:
                with self._rng_lock:
                    jit = self._rng.random() * float(
                        lat.get("jitter_ms", 0.0))
                delay = (float(lat.get("delay_ms", 0.0)) + jit) / 1e3
                self._fire_once("latency", {
                    "event": "fault", "action": "net_latency",
                    "worker": self.worker, "time": time.time(),
                    "delay_ms": float(lat.get("delay_ms", 0.0)),
                    "jitter_ms": float(lat.get("jitter_ms", 0.0)),
                    "conn": n})
                time.sleep(delay)
            try:
                up.sendall(chunk)
            except OSError:
                break
        try:
            up.shutdown(socket.SHUT_WR)
        except OSError:
            pass

    def _pump_down(self, up: socket.socket, conn: socket.socket,
                   n: int) -> None:
        """server → client, with bandwidth pacing and the mid-stream
        reset applied."""
        bw = self._script("bandwidth")
        rst = self._script("reset")
        passed = 0
        while not self._stop.is_set():
            if self._partitioned():
                _abort(conn)
                return
            try:
                chunk = up.recv(_CHUNK)
            except socket.timeout:
                continue
            except OSError:
                return
            if not chunk:
                return
            if rst is not None and not self._reset_done:
                cut = int(rst["after_bytes"])
                if passed + len(chunk) > cut:
                    with self._conn_lock:
                        if self._reset_done:
                            cut = -1
                        else:
                            self._reset_done = True
                    if cut >= 0:
                        head = chunk[:max(0, cut - passed)]
                        if head:
                            try:
                                conn.sendall(head)
                            except OSError:
                                pass
                        passed += len(head)
                        self._journal({
                            "event": "fault", "action": "net_reset",
                            "worker": self.worker, "time": time.time(),
                            "after_bytes": int(rst["after_bytes"]),
                            "bytes_passed": passed,
                            "mid_stream": passed > 0, "conn": n})
                        _abort(conn)
                        return
            try:
                conn.sendall(chunk)
            except OSError:
                return
            passed += len(chunk)
            if bw is not None:
                self._fire_once("bandwidth", {
                    "event": "fault", "action": "net_bandwidth",
                    "worker": self.worker, "time": time.time(),
                    "bytes_per_s": int(bw["bytes_per_s"]), "conn": n})
                time.sleep(len(chunk) / float(int(bw["bytes_per_s"])))


def _abort(s: socket.socket) -> None:
    """Close with RST (SO_LINGER 0) — the far end sees ECONNRESET, not
    a graceful FIN, which is what a real partition/reset looks like."""
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     struct.pack("ii", 1, 0))
    except OSError:
        pass
    try:
        s.close()
    except OSError:
        pass


def start_proxies(cluster_root: str | Path,
                  net_faults: dict[int, list[dict]], *,
                  journal=None, seed: int = 0) -> dict[int, ChaosProxy]:
    """One proxy per net-faulted worker, upstream-resolved from that
    worker's ``serve.json`` under ``cluster_root``. Returns
    ``{worker: started proxy}`` — callers route client endpoints for
    those workers through ``proxy.bound_port`` and ``stop()`` each when
    the trial ends."""
    root = Path(cluster_root)
    out: dict[int, ChaosProxy] = {}
    for worker, scripts in sorted(net_faults.items()):
        p = ChaosProxy(root / f"worker{worker}" / "serve.json", scripts,
                       worker=worker, journal=journal,
                       seed=seed * 7_000_003 + worker)
        p.start()
        out[worker] = p
    return out
