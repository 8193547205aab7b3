"""Structured logging (≙ ``distributedmnist_tpu/core/log.py``).

A logger for humans on stderr, and an append-only JSONL sink for the
machine-readable journals (``serve_log.jsonl``, heartbeats). With
``DMT_VALIDATE_EVENTS`` set (a test-time switch, sampled when a sink is
opened) the sink checks every record against the event schema
(``obsv/schema.py``) before it lands, as the reference's does. Under
``train.durability=full`` each append is fsynced (``train/storage.py``
owns the policy). :func:`eval_line` is the evaluator's parseable line.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path
from typing import IO, Any

from ..obsv import schema

# the storage shim owns the fsync policy for journal appends; looked up
# through sys.modules, since a process that never loaded it can never
# have set a policy other than the default
_STORAGE_MODULE = __package__.rsplit(".", 1)[0] + ".train.storage"

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
        self._validate = schema.validation_enabled()

    def write(self, record: dict[str, Any]) -> None:
        record.setdefault("ts", time.time())
        if self._validate:
            # records without an "event" key (sweep rows) pass
            schema.check_event(record, source=self.path.name)
        self._fh.write(json.dumps(record, default=_default) + "\n")
        storage = sys.modules.get(_STORAGE_MODULE)
        if storage is not None and storage.journal_sync_enabled():
            storage.fsync_journal(self._fh)

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


def text_tail(s: str | None, limit: int = 2000) -> str | None:
    """Last ``limit`` characters of ``s`` — the journal-friendly form of
    a subprocess stream (a crashing worker's last lines are the
    diagnostic ones)."""
    if s is None:
        return None
    return s if len(s) <= limit else s[-limit:]


def eval_line(num_examples: int, precision: float, loss: float,
              seconds: float) -> str:
    """The evaluator's line, in the exact format of the source paper's
    evaluator (``src/nn_eval.py``), so its log parsers still apply."""
    return ("Num examples: %d Precision @ 1: %f Loss: %f Time: %f"
            % (num_examples, precision, loss, seconds))
