"""Checkpoint read/write in the reference's single-file layout (≙
``distributedmnist_tpu/train/checkpoint.py``).

A training run publishes into ``train_dir``:

* ``ckpt-%08d.msgpack`` — flax's msgpack encoding of
  ``{"state": <state dict>, "extra": <json string>}``;
* ``ckpt-%08d.msgpack.sha256`` — the hex sha256 of those bytes;
* ``checkpoint.json`` — the pointer ``{"latest_step", "latest_path",
  "written_at"}``.

The port reads that layout with the ``msgpack`` package alone (no
flax): a leaf array is ext type 1 packing ``[shape, dtype name, raw
C-order bytes]``, a numpy scalar is ext type 3 (the same payload,
0-d), an array over 1 GiB is split into ``{"__msgpack_chunked_array__",
"shape", "chunks"}``, and a list of blocks was saved as a dict keyed
``"0"``, ``"1"``, ... A ``bfloat16`` leaf is read through a ``uint16``
view and widened to float32, which is exact.

Reading verifies the sha256 sidecar (a mismatch or a torn payload is a
:class:`CheckpointCorruptError`) and, when no step is named, falls back
from an unusable newest step to the previous loadable one. The writer
publishes a ``{"params", "step"}`` state in the same layout and order
as the reference — data to a tmp file and ``os.replace``, then the
sidecar, then the pointer — so a reader never sees a torn artifact
under the pointer.

Not ported yet: the per-host sharded layout (manifests), quantized
sidecars, the async writer, garbage collection and the hot-follow
``CheckpointFollower``.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import time
from pathlib import Path
from typing import Any, Callable

import msgpack
import numpy as np

from ..core.log import get_logger

logger = get_logger("checkpoint")

_POINTER = "checkpoint.json"
_DIGEST_SUFFIX = ".sha256"
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


class CheckpointCorruptError(ValueError):
    """A checkpoint artifact exists but cannot be trusted: a torn write
    (unparseable msgpack) or a sha256 mismatch. Distinct from
    ``FileNotFoundError`` (an incomplete publish); both fall back to
    the previous loadable step on restore."""


def _ckpt_path(train_dir: Path, step: int) -> Path:
    return train_dir / f"ckpt-{step:08d}.msgpack"


def _manifest_path(train_dir: Path, step: int) -> Path:
    return train_dir / f"ckpt-{step:08d}.manifest.json"


def _digest_path(path: Path) -> Path:
    return path.with_suffix(path.suffix + _DIGEST_SUFFIX)


# -- flax msgpack encoding --------------------------------------------------

def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, name, buf = msgpack.unpackb(data, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _ext_unpack(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _ndarray_to_bytes(a: np.ndarray) -> bytes:
    return msgpack.packb((a.shape, a.dtype.name, a.tobytes("C")),
                         use_bin_type=True)


def _ext_pack(x):
    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, _ndarray_to_bytes(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR,
                               _ndarray_to_bytes(np.asarray(x)))
    raise TypeError(f"cannot serialize {type(x).__name__}")


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            chunks = tree["chunks"]
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            flat = np.concatenate([chunks[str(i)]
                                   for i in range(len(chunks))])
            return flat.reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes) -> Any:
    """flax ``serialization.msgpack_restore`` without flax."""
    return _unchunk(msgpack.unpackb(data, ext_hook=_ext_unpack, raw=False))


def msgpack_serialize(tree: Any) -> bytes:
    """flax ``serialization.msgpack_serialize`` without flax, for trees
    of dicts with numpy leaves under 1 GiB each (flax would split a
    larger leaf into chunks; no port checkpoint has one)."""
    return msgpack.packb(tree, default=_ext_pack, strict_types=True)


def to_state_dict(tree: Any) -> Any:
    """Lists become dicts keyed by index, as flax's state dicts store
    them (a transformer's ``blocks``)."""
    if isinstance(tree, dict):
        return {k: to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


# -- reading ----------------------------------------------------------------

def _verified_read(path: Path) -> bytes:
    """Read ``path`` and check it against its sha256 sidecar when one
    exists (a file without one is accepted, as the reference does)."""
    data = path.read_bytes()
    dpath = _digest_path(path)
    if dpath.exists():
        want = dpath.read_text().strip()
        got = hashlib.sha256(data).hexdigest()
        if want and got != want:
            raise CheckpointCorruptError(
                f"{path.name}: sha256 mismatch (file {got[:12]}… != "
                f"recorded {want[:12]}…)")
    return data


def _read_payload(path: Path) -> dict:
    data = _verified_read(path)
    try:
        payload = msgpack_restore(data)
    except Exception as e:  # msgpack raises several unpack error types
        raise CheckpointCorruptError(
            f"{path.name}: torn or corrupt msgpack ({type(e).__name__}: "
            f"{e})") from e
    if not isinstance(payload, dict) or "state" not in payload:
        raise CheckpointCorruptError(
            f"{path.name}: payload has no 'state' entry")
    return payload


def _extra_of(payload: dict) -> dict:
    extra = payload.get("extra", {})
    if isinstance(extra, (str, bytes)):
        extra = json.loads(extra)
    return extra


_STEP_RE = re.compile(r"^ckpt-(\d+)\.msgpack$")


def _loadable_steps(train_dir: Path) -> list[int]:
    """Steps with a single-file artifact, ascending."""
    return sorted(int(m.group(1)) for f in train_dir.glob("ckpt-*")
                  if (m := _STEP_RE.match(f.name)))


def latest_checkpoint_step(train_dir: str | Path) -> int | None:
    """The pointer's step; a directory scan when the pointer is missing
    or torn."""
    train_dir = Path(train_dir)
    ptr = train_dir / _POINTER
    if ptr.exists():
        try:
            d = json.loads(ptr.read_text())
            if (train_dir / d["latest_path"]).exists():
                return int(d["latest_step"])
        except (json.JSONDecodeError, KeyError, ValueError, OSError):
            pass
    steps = _loadable_steps(train_dir)
    return max(steps) if steps else None


def _single_file(train_dir: Path, step: int) -> Path:
    path = _ckpt_path(train_dir, step)
    if _manifest_path(train_dir, step).exists() and not path.exists():
        raise NotImplementedError(
            f"step {step} of {train_dir} is a sharded (manifest) "
            "checkpoint; the port reads the single-file layout only")
    return path


def read_checkpoint_extra(train_dir: str | Path, step: int | None = None
                          ) -> tuple[dict, int] | None:
    """The JSON ``extra`` payload (the saved run config) of ``step``
    (default: the newest), or None when nothing was published."""
    train_dir = Path(train_dir)
    if step is None:
        step = latest_checkpoint_step(train_dir)
        if step is None:
            return None
    return _extra_of(_read_payload(_single_file(train_dir, step))), step


def wait_for_run_config(train_dir: str | Path, timeout_s: float = 600.0):
    """Block until the first checkpoint publishes, then adopt its saved
    config (an ``ExperimentConfig``; defaults when it saved none)."""
    from ..core.config import ExperimentConfig
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        try:
            out = read_checkpoint_extra(train_dir)
        except (OSError, ValueError, KeyError) as e:
            logger.warning("checkpoint read failed (%s); retrying", e)
            out = None
        if out is not None:
            extra, _ = out
            if "config" in extra:
                return ExperimentConfig.from_dict(extra["config"])
            logger.warning("checkpoint has no saved config; using defaults")
            return ExperimentConfig()
        time.sleep(1.0)
    raise TimeoutError(
        f"no checkpoint appeared in {train_dir} within {timeout_s:.0f}s")


def artifact_digest(train_dir: str | Path, step: int) -> str | None:
    """The recorded sha256 of a step's artifact (its sidecar), or None."""
    try:
        text = _digest_path(_ckpt_path(Path(train_dir), step)).read_text()
    except OSError:
        return None
    return text.strip() or None


_FALLBACK_ERRORS = (FileNotFoundError, CheckpointCorruptError, OSError)


def restore_params(train_dir: str | Path, step: int | None = None,
                   on_event: Callable[[dict], None] | None = None
                   ) -> tuple[dict, dict, int] | None:
    """(params, extra, step) of a checkpoint — params as the saved
    state dict of numpy arrays — or None when nothing is loadable.

    With no ``step``, an unusable newest step (torn, digest mismatch,
    vanished) falls back to the next older loadable one; each skip is
    reported through ``on_event`` with the reference's record shape
    (``corrupt_checkpoint_fallback``, then ``fallback_restore``)."""
    train_dir = Path(train_dir)
    if step is not None:
        payload = _read_payload(_single_file(train_dir, step))
        return payload["state"]["params"], _extra_of(payload), step
    candidates = set(_loadable_steps(train_dir))
    latest = latest_checkpoint_step(train_dir)
    if latest is not None:
        candidates.add(latest)
    fell_back = False
    for s in sorted(candidates, reverse=True):
        try:
            payload = _read_payload(_single_file(train_dir, s))
            params = payload["state"]["params"]
        except (*_FALLBACK_ERRORS, KeyError, TypeError) as e:
            fell_back = True
            logger.warning("checkpoint step=%d is unusable (%s: %s); "
                           "falling back to an older step",
                           s, type(e).__name__, e)
            if on_event is not None:
                on_event({"action": "corrupt_checkpoint_fallback",
                          "bad_step": s,
                          "error": f"{type(e).__name__}: {e}"})
            continue
        if fell_back and on_event is not None:
            on_event({"action": "fallback_restore", "step": s})
        return params, _extra_of(payload), s
    return None


# -- writing ----------------------------------------------------------------

def _write_atomic(path: Path, data: bytes) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(data)
    dpath = _digest_path(path)
    # a re-save of the same step must never leave the old digest over
    # the new bytes: drop it before the data lands
    dpath.unlink(missing_ok=True)
    os.replace(tmp, path)
    dtmp = dpath.with_name(dpath.name + ".tmp")
    dtmp.write_text(hashlib.sha256(data).hexdigest())
    os.replace(dtmp, dpath)


def save_checkpoint(train_dir: str | Path, params: dict, step: int,
                    extra: dict | None = None) -> Path:
    """Publish ``{"params": params, "step": step}`` at ``step``:
    artifact, sha256 sidecar, then the pointer. ``params`` is the
    reference layout as numpy arrays (``models.convert.
    params_to_reference``); ``extra`` is JSON-serializable (put the run
    config under ``"config"`` so a replica can boot from it)."""
    train_dir = Path(train_dir)
    train_dir.mkdir(parents=True, exist_ok=True)
    state = {"params": to_state_dict(params), "step": np.int32(step)}
    data = msgpack_serialize({"state": state,
                              "extra": json.dumps(extra or {})})
    path = _ckpt_path(train_dir, step)
    _write_atomic(path, data)
    pointer = {"latest_step": step, "latest_path": path.name,
               "written_at": time.time()}
    ptmp = train_dir / (_POINTER + ".tmp")
    ptmp.write_text(json.dumps(pointer))
    os.replace(ptmp, train_dir / _POINTER)
    logger.info("saved checkpoint step=%d → %s", step, path.name)
    return path
