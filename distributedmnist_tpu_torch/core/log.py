"""Structured logging (≙ ``distributedmnist_tpu/core/log.py``).

A logger for humans on stderr, and an append-only JSONL sink for the
machine-readable journals (``serve_log.jsonl``, heartbeats). The
reference's sink can also validate every record against its event
schema (``obsv/schema.py``, a test-time switch); the port writes the
same records and its tests validate them with that schema from the
outside.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path
from typing import IO, Any

_LOGGER = logging.getLogger("distributedmnist_tpu_torch")
if not _LOGGER.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s] %(message)s"))
    _LOGGER.addHandler(_h)
    _LOGGER.setLevel(logging.INFO)
    _LOGGER.propagate = False


def get_logger(name: str | None = None) -> logging.Logger:
    return _LOGGER if name is None else _LOGGER.getChild(name)


class JsonlSink:
    """Append-only JSONL event sink (one file per run/role)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh: IO[str] = open(self.path, "a", buffering=1)

    def write(self, record: dict[str, Any]) -> None:
        record.setdefault("ts", time.time())
        self._fh.write(json.dumps(record, default=_default) + "\n")

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _default(o: Any):
    import numpy as np
    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)
