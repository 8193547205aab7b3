"""TensorBoard scalar summaries: a first-party tfevents writer (≙
``distributedmnist_tpu/obsv/tb.py``, pure Python and copied here so the
port needs neither the reference package nor TensorFlow).

The trainer writes train scalars on ``train.summary_every_steps`` and
the evaluator writes ``Validation Accuracy`` / ``Validation Loss``, as
the source paper's chief and evaluator do
(src/distributed_train.py:382-390, src/nn_eval.py:107-110). The
tfevents wire format is length-prefixed records with masked CRC32C
checksums, each payload a serialized ``Event`` proto; only the fields
written here are encoded: Event{wall_time=1, step=2, file_version=3,
summary=5} and Summary{value=1{tag=1, simple_value=2}}.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from pathlib import Path

# --------------------------------------------------------------------------
# CRC32C (Castagnoli, reflected poly 0x82F63B78) + TF record masking
# --------------------------------------------------------------------------

_CRC_TABLE = []


def _crc_table() -> list[int]:
    if not _CRC_TABLE:
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --------------------------------------------------------------------------
# minimal protobuf encoding (only what Event/Summary scalars need)
# --------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _f64(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _f32(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _i64(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _bytes(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _event(wall_time: float, step: int | None = None,
           file_version: str | None = None,
           scalars: dict[str, float] | None = None) -> bytes:
    ev = _f64(1, wall_time)
    if step is not None:
        ev += _i64(2, step)
    if file_version is not None:
        ev += _bytes(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _bytes(1, _bytes(1, tag.encode()) + _f32(2, float(v)))
            for tag, v in scalars.items())
        ev += _bytes(5, summary)
    return ev


# --------------------------------------------------------------------------
# writer
# --------------------------------------------------------------------------

class SummaryWriter:
    """Append-only tfevents scalar writer.

    ``add_scalars({"loss": 0.3}, step)`` buffers one Event record;
    ``flush()`` appends to disk. Files land as
    ``events.out.tfevents.<ts>.<host>`` under ``log_dir`` — exactly
    what ``tensorboard --logdir`` expects.
    """

    def __init__(self, log_dir: str | Path):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        ts = time.time()
        host = socket.gethostname() or "host"
        self.path = self.log_dir / f"events.out.tfevents.{ts:.6f}.{host}.{os.getpid()}"
        self._buf = bytearray(self._record(_event(ts, file_version="brain.Event:2")))
        self._closed = False

    @staticmethod
    def _record(payload: bytes) -> bytes:
        header = struct.pack("<Q", len(payload))
        return (header + struct.pack("<I", _masked_crc(header))
                + payload + struct.pack("<I", _masked_crc(payload)))

    def add_scalars(self, scalars: dict[str, float], step: int,
                    wall_time: float | None = None) -> None:
        if self._closed:
            raise RuntimeError("SummaryWriter is closed")
        ev = _event(wall_time if wall_time is not None else time.time(),
                    step=step, scalars=scalars)
        self._buf += self._record(ev)

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: float | None = None) -> None:
        self.add_scalars({tag: value}, step, wall_time)

    def flush(self) -> None:
        if self._buf:
            with open(self.path, "ab") as f:
                f.write(self._buf)
            self._buf = bytearray()

    def close(self) -> None:
        if not self._closed:
            self.flush()
            self._closed = True
