"""The storage shim every durable checkpoint write goes through (≙
``distributedmnist_tpu/train/storage.py``).

* **Durability policy** (``train.durability``): ``none`` writes through
  the page cache with rename-only atomicity; ``data`` fsyncs a
  checkpoint's payload bytes before the rename publishes them; ``full``
  also fsyncs the digest sidecars, the pointer, every JSONL journal
  append (:class:`..core.log.JsonlSink` asks :func:`journal_sync_enabled`)
  and the parent directory after every rename.

* **Deterministic disk-fault injection**: per-process fault scripts of
  the :data:`DISK_FAULT_KINDS`, armed from the ``DMT_DISK_FAULTS``
  environment variable (``{"worker", "faults", "journal"}``) or by
  :func:`arm_faults`. Every firing is journaled as a ``fault`` record
  (``action: disk_*``, the reference's schema) into the process's
  ``storage_faults.jsonl``, so a replay can license each degradation it
  caused.

Fault kinds and their script fields (every script also takes
``at_step`` — armed once the trainer has reached that step, default 0 —
``times`` — firings before it disarms, default 1 — and ``match`` — a
substring of the target file name, default all):

* ``enospc_after_bytes`` (``bytes``): matching writes pass until the
  byte budget is spent, then fail with ``ENOSPC`` writing nothing.
* ``eio`` (``op`` = ``read``/``write``, ``nth``): the ``nth`` matching
  op (and the next ``times - 1``) fails with ``EIO``.
* ``slow_io_ms`` (``ms``): each matching op sleeps first.
* ``torn_write_at_byte`` (``at_byte``): the write lands its first
  ``at_byte`` bytes, then fails with ``EIO``; the torn ``.tmp`` stays.
* ``crash_rename`` (``keep_bytes``, default 0): the rename is applied
  but the renamed file keeps only ``keep_bytes`` bytes, and no error is
  raised (a power cut after the rename); only the digest sidecar
  catches it later.

Faults apply only to the artifacts routed through the shim
(checkpoints, digest sidecars, the pointer), never to the journals
that record them.
"""

from __future__ import annotations

import dataclasses
import errno as _errno
import json
import os
import threading
import time
from pathlib import Path
from typing import Any

from ..core.log import JsonlSink, get_logger

logger = get_logger("storage")

DISK_FAULT_KINDS = ("enospc_after_bytes", "eio", "slow_io_ms",
                    "torn_write_at_byte", "crash_rename")

_VALID_DURABILITY = ("none", "data", "full")

# roles fsynced per policy: "data" syncs payload bytes only; "full"
# syncs everything (payloads, sidecars, pointer, journals, directories)
_DATA_ROLES = ("data",)

_DURABILITY = "none"


def set_durability(policy: str) -> None:
    """Install the process-wide fsync policy (``train.durability``)."""
    if policy not in _VALID_DURABILITY:
        from ..core.config import ConfigError
        raise ConfigError(
            f"train.durability={policy!r} is not a known durability "
            f"policy; valid policies: {', '.join(_VALID_DURABILITY)}")
    global _DURABILITY
    _DURABILITY = policy


def durability() -> str:
    return _DURABILITY


def _role_synced(role: str) -> bool:
    if _DURABILITY == "full":
        return True
    if _DURABILITY == "data":
        return role in _DATA_ROLES
    return False


def journal_sync_enabled() -> bool:
    """True when JSONL journal appends must fsync (policy ``full``)."""
    return _DURABILITY == "full"


def fsync_journal(fh: Any) -> None:
    try:
        fh.flush()
        os.fsync(fh.fileno())
    except (OSError, ValueError):  # a closed handle: best effort
        pass


def _fsync_dir(dirpath: Path) -> None:
    try:
        fd = os.open(dirpath, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


# -- deterministic disk-fault injection -------------------------------------

@dataclasses.dataclass
class _Script:
    """One armed fault, from its script dict."""

    kind: str
    at_step: int = 0
    times: int = 1
    match: str = ""
    op: str = "write"       # eio: which op class faults
    nth: int = 1            # eio: fire on the nth matching op
    bytes: int = 0          # enospc_after_bytes: byte budget
    ms: float = 0.0         # slow_io_ms: per-op stall
    at_byte: int = 0        # torn_write_at_byte: truncation point
    keep_bytes: int = 0     # crash_rename: surviving prefix
    # counters while armed
    fired: int = 0
    seen_ops: int = 0
    written: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "_Script":
        d = dict(d)
        kind = d.get("kind")
        if kind not in DISK_FAULT_KINDS:
            raise ValueError(
                f"unknown disk fault kind {kind!r}; valid kinds: "
                f"{', '.join(DISK_FAULT_KINDS)}")
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(
                f"disk fault {kind!r} has unknown field(s) "
                f"{sorted(unknown)}")
        return cls(**d)

    def spent(self) -> bool:
        return self.fired >= self.times

    def applies(self, step: int, name: str) -> bool:
        if self.spent() or step < self.at_step:
            return False
        return (not self.match) or (self.match in name)


class DiskFaultInjector:
    """The per-process fault engine every shim op consults. Scripts
    fire deterministically (list order, op counters, byte budgets) and
    every firing lands in the journal as a ``fault`` record carrying
    the worker ordinal."""

    def __init__(self, worker: int, scripts: list[dict],
                 journal_path: str | Path | None = None):
        self.worker = int(worker)
        self._scripts = [_Script.from_dict(s) for s in scripts]
        self._journal_path = Path(journal_path) if journal_path else None
        self._sink: JsonlSink | None = None
        self._lock = threading.Lock()
        self._step = 0

    def note_step(self, step: int) -> None:
        with self._lock:
            self._step = max(self._step, int(step))

    def _journal(self, action: str, path: Path, **fields: Any) -> None:
        rec = {"event": "fault", "action": action, "worker": self.worker,
               "path": path.name, "at_step": self._step, **fields}
        logger.warning("injected disk fault %s on %s", action, path.name)
        if self._journal_path is None:
            return
        try:
            if self._sink is None:
                self._sink = JsonlSink(self._journal_path)
            self._sink.write(rec)
        except OSError as e:
            logger.warning("storage fault journal write failed: %s", e)

    def on_write(self, path: Path, nbytes: int) -> int | None:
        """Consulted before a durable write of ``nbytes`` to ``path``:
        raises ``OSError`` (ENOSPC/EIO), sleeps (slow I/O), or returns
        the torn-write length the shim must honor; None → write all."""
        name = path.name
        sleep_ms = 0.0
        torn_at: int | None = None
        with self._lock:
            for s in self._scripts:
                if not s.applies(self._step, name):
                    continue
                if s.kind == "slow_io_ms":
                    s.fired += 1
                    self._journal("disk_slow_io", path, op="write",
                                  ms=s.ms, planned_step=s.at_step)
                    sleep_ms += s.ms
                elif s.kind == "torn_write_at_byte":
                    s.fired += 1
                    self._journal("disk_torn_write", path, op="write",
                                  at_byte=s.at_byte,
                                  planned_step=s.at_step)
                    k = min(s.at_byte, nbytes)
                    torn_at = k if torn_at is None else min(torn_at, k)
                elif s.kind == "enospc_after_bytes":
                    if s.written + nbytes > s.bytes:
                        s.fired += 1
                        self._journal("disk_enospc", path, op="write",
                                      budget_bytes=s.bytes,
                                      planned_step=s.at_step)
                        raise OSError(
                            _errno.ENOSPC,
                            f"injected ENOSPC (budget {s.bytes}B)", name)
                    s.written += nbytes
                elif s.kind == "eio" and s.op == "write":
                    s.seen_ops += 1
                    if s.seen_ops >= s.nth:
                        s.fired += 1
                        self._journal("disk_eio", path, op="write",
                                      nth=s.seen_ops,
                                      planned_step=s.at_step)
                        raise OSError(_errno.EIO,
                                      "injected EIO on write", name)
        if sleep_ms:
            time.sleep(sleep_ms / 1000.0)
        return torn_at

    def on_read(self, path: Path) -> None:
        name = path.name
        sleep_ms = 0.0
        with self._lock:
            for s in self._scripts:
                if not s.applies(self._step, name):
                    continue
                if s.kind == "slow_io_ms":
                    s.fired += 1
                    self._journal("disk_slow_io", path, op="read",
                                  ms=s.ms, planned_step=s.at_step)
                    sleep_ms += s.ms
                elif s.kind == "eio" and s.op == "read":
                    s.seen_ops += 1
                    if s.seen_ops >= s.nth:
                        s.fired += 1
                        self._journal("disk_eio", path, op="read",
                                      nth=s.seen_ops,
                                      planned_step=s.at_step)
                        raise OSError(_errno.EIO,
                                      "injected EIO on read", name)
        if sleep_ms:
            time.sleep(sleep_ms / 1000.0)

    def on_replace(self, dst: Path) -> int | None:
        """Consulted before a publishing rename onto ``dst``: the bytes
        that survive when a ``crash_rename`` fires, else None."""
        with self._lock:
            for s in self._scripts:
                if s.kind != "crash_rename":
                    continue
                if not s.applies(self._step, dst.name):
                    continue
                s.fired += 1
                self._journal("disk_crash_rename", dst,
                              kept_bytes=s.keep_bytes,
                              planned_step=s.at_step)
                return s.keep_bytes
        return None

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()
            self._sink = None


_INJECTOR: DiskFaultInjector | None = None
_ENV_CHECKED = False

DISK_FAULTS_ENV = "DMT_DISK_FAULTS"


def arm_faults(worker: int, scripts: list[dict],
               journal_path: str | Path | None = None) -> DiskFaultInjector:
    """Arm ``scripts`` for this process (replacing any armed ones)."""
    global _INJECTOR, _ENV_CHECKED
    if _INJECTOR is not None:
        _INJECTOR.close()
    _INJECTOR = DiskFaultInjector(worker, scripts, journal_path)
    _ENV_CHECKED = True
    return _INJECTOR


def clear_faults() -> None:
    """Disarm; the environment variable does not re-arm afterwards."""
    global _INJECTOR, _ENV_CHECKED
    if _INJECTOR is not None:
        _INJECTOR.close()
    _INJECTOR = None
    _ENV_CHECKED = True


def _injector() -> DiskFaultInjector | None:
    global _INJECTOR, _ENV_CHECKED
    if not _ENV_CHECKED:
        _ENV_CHECKED = True
        spec = os.environ.get(DISK_FAULTS_ENV, "")
        if spec:
            try:
                d = json.loads(spec)
                _INJECTOR = DiskFaultInjector(
                    int(d.get("worker", 0)), list(d.get("faults", [])),
                    d.get("journal"))
            except (ValueError, TypeError, KeyError) as e:
                logger.warning("ignoring malformed %s (%s)",
                               DISK_FAULTS_ENV, e)
    return _INJECTOR


def note_step(step: int) -> None:
    """The trainer's progress, so that ``at_step`` scripts arm."""
    inj = _injector()
    if inj is not None:
        inj.note_step(step)


# -- the shim ops -----------------------------------------------------------

def write_bytes(path: str | Path, data: bytes, role: str = "data") -> None:
    """Write ``data`` to ``path`` (the caller owns the tmp + rename),
    applying the armed faults and the fsync policy for ``role``."""
    path = Path(path)
    inj = _injector()
    torn_at = inj.on_write(path, len(data)) if inj is not None else None
    if torn_at is not None:
        with open(path, "wb") as fh:
            fh.write(data[:torn_at])
        raise OSError(_errno.EIO,
                      f"injected torn write at byte {torn_at}", path.name)
    with open(path, "wb") as fh:
        fh.write(data)
        if _role_synced(role):
            fh.flush()
            os.fsync(fh.fileno())


def write_text(path: str | Path, text: str, role: str = "sidecar") -> None:
    write_bytes(path, text.encode("utf-8"), role=role)


def read_bytes(path: str | Path) -> bytes:
    path = Path(path)
    inj = _injector()
    if inj is not None:
        inj.on_read(path)
    return path.read_bytes()


def read_text(path: str | Path) -> str:
    return read_bytes(path).decode("utf-8")


def replace(src: str | Path, dst: str | Path, role: str = "data") -> None:
    """The publishing rename (``os.replace``): ``crash_rename`` faults
    land here, and policy ``full`` makes the rename durable by fsyncing
    the parent directory."""
    src, dst = Path(src), Path(dst)
    inj = _injector()
    keep = inj.on_replace(dst) if inj is not None else None
    os.replace(src, dst)
    if keep is not None:
        # the rename's metadata survived the power cut, the data did not
        with open(dst, "r+b") as fh:
            fh.truncate(keep)
    if _DURABILITY == "full":
        _fsync_dir(dst.parent)
