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
publishes a whole TrainState state dict (:func:`save_state`, what the
Trainer saves) or a weights-only ``{"params", "step"}`` one
(:func:`save_checkpoint`) in the same layout and order as the reference
— data to a tmp file and ``os.replace``, then the sidecar, then the
pointer, then keep-N garbage collection — so a reader never sees a torn
artifact under the pointer, and either package resumes the other's
checkpoints. :func:`checkpoint_params_digest` is the reference's digest.

Not ported yet: the per-host sharded layout (manifests), quantized
sidecars, the async writer, the storage fault shim and the hot-follow
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


def loadable_steps(train_dir: str | Path) -> list[int]:
    """The steps with a single-file artifact in ``train_dir``,
    ascending (what a rollback walks)."""
    return _loadable_steps(Path(train_dir))


def _read_state(train_dir: Path, step: int) -> tuple[dict, dict]:
    payload = _read_payload(_single_file(train_dir, step))
    state = payload["state"]
    if not isinstance(state, dict) or state.get("params") is None:
        raise CheckpointCorruptError(
            f"ckpt-{step:08d}.msgpack: payload has no state/params entry")
    return state, _extra_of(payload)


def restore_state(train_dir: str | Path, step: int | None = None,
                  on_event: Callable[[dict], None] | None = None
                  ) -> tuple[dict, dict, int] | None:
    """(state, extra, step) of a checkpoint — ``state`` the saved state
    dict of numpy arrays (``models.convert.state_from_reference`` makes
    it a TrainState) — or None when nothing is loadable.

    With no ``step``, an unusable newest step (torn, digest mismatch,
    vanished) falls back to the next older loadable one; each skip is
    reported through ``on_event`` with the reference's record shape
    (``corrupt_checkpoint_fallback``, then ``fallback_restore``)."""
    train_dir = Path(train_dir)
    if step is not None:
        state, extra = _read_state(train_dir, step)
        return state, extra, step
    candidates = set(_loadable_steps(train_dir))
    latest = latest_checkpoint_step(train_dir)
    if latest is not None:
        candidates.add(latest)
    fell_back = False
    for s in sorted(candidates, reverse=True):
        try:
            state, extra = _read_state(train_dir, s)
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
        return state, extra, s
    return None


def restore_params(train_dir: str | Path, step: int | None = None,
                   on_event: Callable[[dict], None] | None = None
                   ) -> tuple[dict, dict, int] | None:
    """(params, extra, step): :func:`restore_state`'s params alone."""
    got = restore_state(train_dir, step, on_event)
    return None if got is None else (got[0]["params"], got[1], got[2])


# -- digests ----------------------------------------------------------------

def _digest_tree(tree: Any, h) -> None:
    """The reference's canonical fold of a nested state dict: sorted
    key paths, then dtype, shape and bytes per leaf, NUL-delimited."""
    if isinstance(tree, dict):
        h.update(b"{\x00")
        for key in sorted(tree):
            h.update(str(key).encode() + b"\x00")
            _digest_tree(tree[key], h)
        h.update(b"}\x00")
        return
    if tree is None:
        h.update(b"<none>\x00")
        return
    a = np.ascontiguousarray(np.asarray(tree))
    h.update(str(a.dtype).encode() + b"\x00")
    h.update(str(a.shape).encode() + b"\x00")
    h.update(a.tobytes())
    h.update(b"\x00")


def params_digest(params: dict) -> str:
    """sha256 of params in the reference layout as numpy
    (``models.convert.params_to_reference``) — equal to the reference's
    ``state_params_digest`` of the same values."""
    h = hashlib.sha256()
    _digest_tree(to_state_dict(params), h)
    return h.hexdigest()


def checkpoint_params_digest(train_dir: str | Path, step: int | None = None
                             ) -> tuple[str, int] | None:
    """(sha256 of the saved params, step) from the artifact alone (≙ the
    reference's ``checkpoint_params_digest``); None when nothing was
    published."""
    train_dir = Path(train_dir)
    if step is None:
        step = latest_checkpoint_step(train_dir)
        if step is None:
            return None
    state, _ = _read_state(train_dir, step)
    h = hashlib.sha256()
    _digest_tree(state["params"], h)
    return h.hexdigest(), step


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


def _garbage_collect(train_dir: Path, keep: int) -> None:
    """Keep the newest ``keep`` steps' artifacts (and their sidecars);
    ``keep <= 0`` keeps everything."""
    if keep <= 0:
        return
    by_step: dict[int, list[Path]] = {}
    for f in train_dir.glob("ckpt-*"):
        m = re.match(r"^ckpt-(\d+)\.", f.name)
        if m and not f.name.endswith(".tmp"):
            by_step.setdefault(int(m.group(1)), []).append(f)
    for s in sorted(by_step)[:-keep]:
        for old in by_step[s]:
            old.unlink(missing_ok=True)


def save_state(train_dir: str | Path, state: dict, step: int,
               extra: dict | None = None, keep: int = 0) -> Path:
    """Publish a state dict at ``step``: artifact, sha256 sidecar, then
    the pointer, then drop all but the newest ``keep`` steps. ``state``
    holds numpy leaves in the reference layout — a whole TrainState
    from ``models.convert.state_to_reference``, or any subset with
    ``params``; ``extra`` is JSON-serializable (the Trainer stores the
    run config, the world and the data cursor there, as the reference
    does)."""
    train_dir = Path(train_dir)
    train_dir.mkdir(parents=True, exist_ok=True)
    data = msgpack_serialize({"state": to_state_dict(state),
                              "extra": json.dumps(extra or {})})
    path = _ckpt_path(train_dir, step)
    _write_atomic(path, data)
    pointer = {"latest_step": step, "latest_path": path.name,
               "written_at": time.time()}
    ptmp = train_dir / (_POINTER + ".tmp")
    ptmp.write_text(json.dumps(pointer))
    os.replace(ptmp, train_dir / _POINTER)
    _garbage_collect(train_dir, keep)
    logger.info("saved checkpoint step=%d → %s", step, path.name)
    return path


def save_checkpoint(train_dir: str | Path, params: dict, step: int,
                    extra: dict | None = None) -> Path:
    """Publish ``{"params": params, "step": step}`` at ``step`` (a
    weights-only artifact, what a serving replica needs). ``params`` is
    the reference layout as numpy arrays (``models.convert.
    params_to_reference``); put the run config under ``extra["config"]``
    so a replica can boot from it."""
    return save_state(train_dir, {"params": params, "step": np.int32(step)},
                      step, extra)
