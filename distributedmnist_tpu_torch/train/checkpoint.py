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
``"0"``, ``"1"``, ... numpy has no ``bfloat16``: a bf16 leaf is read
through a ``uint16`` view and widened to float32, which is exact, or,
for the quantized sidecar's bf16 tier, kept as its 2-byte words in a
torch ``bfloat16`` tensor; a CPU torch ``bfloat16`` tensor is written
as the reference writes an ml_dtypes one (dtype name ``"bfloat16"``,
the raw words).

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

Every durable write and read goes through the storage shim
(``train/storage.py``: the fsync policy and the injectable disk faults)
inside the reference's bounded I/O retries (:func:`_io_retries`; a
missing file is not retried). :class:`AsyncCheckpointer` writes on a
background thread, latest wins; :class:`CheckpointFollower` is the
hot-follow loop of the evaluator and the serving replicas: pointer
read, step-advanced check, skip-and-retry on an unreadable artifact.

A step's quantized serving tiers (``quant/``) live in a sidecar
``ckpt-%08d.quant.msgpack`` with its own ``.sha256``, written with the
artifact's atomic-write contract (:func:`write_quant_sidecar`) and read
digest-verified (:func:`read_quant_sidecar`); the sidecar never makes a
step loadable and is garbage-collected with its step. The
:class:`AsyncCheckpointer`'s ``publish`` hook writes it on the writer
thread before the artifact and the pointer.

Where a process holds only its replicas' chunks of some state (ZeRO-1
over several processes), a save uses the reference's per-host layout
instead (:func:`save_sharded_state`): every replica-process writes
``ckpt-%08d.shard%03d-of-%03d.msgpack`` (with its ``.sha256``) holding
``{"leaves": {"a/b/c": array | {"indices", "datas"}}}`` — whole leaves
from process 0 only, and each replica-process's slabs of the split
ones (under model parallelism from its leader alone) — and process 0
writes ``ckpt-%08d.manifest.json`` (each leaf's global shape
and dtype, the ``extra`` payload and a checksum of its own) and then
the pointer. Any process count reads it back (:func:`restore_state`
reassembles the global arrays). :class:`OptimizerStateMismatchError`
is the typed refusal of another optimizer's state
(``parallel/api.py restore_for_topology``).
"""

from __future__ import annotations

import hashlib
import json
import re
import threading
import time
from pathlib import Path
from typing import Any, Callable

import msgpack
import numpy as np
import torch

from ..core.log import get_logger
from . import storage

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


class OptimizerStateMismatchError(ValueError):
    """A checkpoint holds another optimizer-state kind (none, momentum,
    lars, lamb — ``train/optim.opt_state_kind``) than the restoring run
    needs. Not a :class:`CheckpointCorruptError`: it affects every step
    alike, so a restore raises it (naming both kinds) instead of falling
    back past the run or grafting one optimizer's slots into another's
    (momentum and LARS slots even share a tree shape)."""

    def __init__(self, msg: str, saved_kind: str | None = None,
                 requested_kind: str | None = None):
        super().__init__(msg)
        self.saved_kind = saved_kind
        self.requested_kind = requested_kind


# -- I/O retries ------------------------------------------------------------
#
# A transient EIO on a network filesystem must not look like corruption
# (which would discard a good step); a missing file is a fact of the
# publish order, not a flake, and is not retried.

_IO_ATTEMPTS = 3
_IO_BACKOFF_S = 0.05


def _io_retries(fn: Callable[[], Any], what: str) -> Any:
    for attempt in range(1, _IO_ATTEMPTS + 1):
        try:
            return fn()
        except FileNotFoundError:
            raise
        except OSError as e:
            if attempt == _IO_ATTEMPTS:
                raise
            delay = _IO_BACKOFF_S * 2 ** (attempt - 1)
            logger.warning("I/O error on %s (%s) — attempt %d/%d, "
                           "retrying in %.2fs", what, e, attempt,
                           _IO_ATTEMPTS, delay)
            time.sleep(delay)


def _ckpt_path(train_dir: Path, step: int) -> Path:
    return train_dir / f"ckpt-{step:08d}.msgpack"


def _manifest_path(train_dir: Path, step: int) -> Path:
    return train_dir / f"ckpt-{step:08d}.manifest.json"


def _shard_path(train_dir: Path, step: int, p: int, count: int) -> Path:
    return train_dir / f"ckpt-{step:08d}.shard{p:03d}-of-{count:03d}.msgpack"


def _digest_path(path: Path) -> Path:
    return path.with_suffix(path.suffix + _DIGEST_SUFFIX)


# -- flax msgpack encoding --------------------------------------------------

def _ndarray_from_bytes(data: bytes, keep_bfloat16: bool = False):
    shape, name, buf = msgpack.unpackb(data, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        if keep_bfloat16:
            words = np.frombuffer(buf, dtype=np.int16).reshape(shape)
            return torch.from_numpy(words.copy()).view(torch.bfloat16)
        bits = np.frombuffer(buf, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _ext_unpacker(keep_bfloat16: bool):
    def unpack(code: int, data: bytes):
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(data, keep_bfloat16)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(data)[()]
        return msgpack.ExtType(code, data)
    return unpack


def _ndarray_to_bytes(a: np.ndarray) -> bytes:
    return msgpack.packb((a.shape, a.dtype.name, a.tobytes("C")),
                         use_bin_type=True)


def _bfloat16_to_bytes(t: torch.Tensor) -> bytes:
    """A CPU bf16 tensor as flax packs an ml_dtypes ``bfloat16`` array:
    its shape, the name ``"bfloat16"`` and its raw 2-byte words."""
    words = t.contiguous().view(torch.int16).numpy()
    return msgpack.packb((tuple(t.shape), "bfloat16", words.tobytes("C")),
                         use_bin_type=True)


def _ext_pack(x):
    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, _ndarray_to_bytes(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR,
                               _ndarray_to_bytes(np.asarray(x)))
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return msgpack.ExtType(_EXT_NDARRAY, _bfloat16_to_bytes(x.cpu()))
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


def msgpack_restore(data: bytes, keep_bfloat16: bool = False) -> Any:
    """flax ``serialization.msgpack_restore`` without flax. A bf16 leaf
    comes back widened to float32, or with ``keep_bfloat16`` as a CPU
    torch ``bfloat16`` tensor of the same words."""
    return _unchunk(msgpack.unpackb(
        data, ext_hook=_ext_unpacker(keep_bfloat16), raw=False))


def msgpack_serialize(tree: Any) -> bytes:
    """flax ``serialization.msgpack_serialize`` without flax, for trees
    of dicts with numpy leaves under 1 GiB each (flax would split a
    larger leaf into chunks; no port checkpoint has one)."""
    return msgpack.packb(tree, default=_ext_pack, strict_types=True)


def to_state_dict(tree: Any) -> Any:
    """The tree as the reference's writer hands it to msgpack: lists
    become dicts keyed by index, as flax's state dicts store them (a
    transformer's ``blocks``); every dict's keys sorted and numpy
    scalars 0-d arrays, as jax's tree map and ``device_get`` leave
    them. The same state then packs to the reference's bytes."""
    if isinstance(tree, dict):
        return {k: to_state_dict(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return to_state_dict({str(i): v for i, v in enumerate(tree)})
    if isinstance(tree, np.generic):
        return np.asarray(tree)
    return tree


# -- reading ----------------------------------------------------------------

def _verified_read(path: Path) -> bytes:
    """Read ``path`` (with I/O retries) and check it against its sha256
    sidecar when one exists (a file without one is accepted, as the
    reference does: a crash between the data and digest writes)."""
    data = _io_retries(lambda: storage.read_bytes(path), path.name)
    dpath = _digest_path(path)
    if dpath.exists():
        want = _io_retries(lambda: storage.read_text(dpath),
                           dpath.name).strip()
        got = hashlib.sha256(data).hexdigest()
        if want and got != want:
            raise CheckpointCorruptError(
                f"{path.name}: sha256 mismatch (file {got[:12]}… != "
                f"recorded {want[:12]}…)")
    return data


def verify_artifact(path: str | Path) -> None:
    """Raise :class:`CheckpointCorruptError` when ``path`` fails its
    sha256 sidecar (a file without a sidecar is accepted)."""
    _verified_read(Path(path))


def _restore_checked(data: bytes, path: Path,
                     keep_bfloat16: bool = False) -> Any:
    try:
        return msgpack_restore(data, keep_bfloat16)
    except Exception as e:  # msgpack raises several unpack error types
        raise CheckpointCorruptError(
            f"{path.name}: torn or corrupt msgpack ({type(e).__name__}: "
            f"{e})") from e


def _read_payload(path: Path) -> dict:
    payload = _restore_checked(_verified_read(path), path)
    if not isinstance(payload, dict) or "state" not in payload:
        raise CheckpointCorruptError(
            f"{path.name}: payload has no 'state' entry")
    return payload


def _extra_of(payload: dict) -> dict:
    extra = payload.get("extra", {})
    if isinstance(extra, (str, bytes)):
        extra = json.loads(extra)
    return extra


_STEP_RE = re.compile(r"^ckpt-(\d+)\.(?:msgpack|manifest\.json)$")


def _loadable_steps(train_dir: Path) -> list[int]:
    """Steps with a single-file artifact or a manifest, ascending."""
    return sorted(int(m.group(1)) for f in train_dir.glob("ckpt-*")
                  if (m := _STEP_RE.match(f.name)))


def latest_checkpoint_step(train_dir: str | Path) -> int | None:
    """The pointer's step; a directory scan when the pointer is missing
    or torn."""
    train_dir = Path(train_dir)
    ptr = train_dir / _POINTER
    if ptr.exists():
        try:
            d = json.loads(storage.read_text(ptr))
            if (train_dir / d["latest_path"]).exists():
                return int(d["latest_step"])
        except (json.JSONDecodeError, KeyError, ValueError, OSError):
            pass
    steps = _loadable_steps(train_dir)
    return max(steps) if steps else None


def _manifest_checksum(manifest: dict) -> str:
    body = {k: v for k, v in manifest.items() if k != "checksum"}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True).encode()).hexdigest()


def _read_manifest(train_dir: Path, step: int) -> dict:
    mpath = _manifest_path(train_dir, step)
    text = _io_retries(lambda: storage.read_text(mpath), mpath.name)
    try:
        manifest = json.loads(text)
    except json.JSONDecodeError as e:
        raise CheckpointCorruptError(
            f"{mpath.name}: torn or corrupt manifest ({e})") from e
    want = manifest.get("checksum")
    if want and _manifest_checksum(manifest) != want:
        raise CheckpointCorruptError(f"{mpath.name}: checksum mismatch")
    return manifest


def read_checkpoint_extra(train_dir: str | Path, step: int | None = None
                          ) -> tuple[dict, int] | None:
    """The JSON ``extra`` payload (the saved run config, world and data
    cursor) of ``step`` (default: the newest), from its file or its
    manifest; None when nothing was published."""
    train_dir = Path(train_dir)
    if step is None:
        step = latest_checkpoint_step(train_dir)
        if step is None:
            return None
    if _manifest_path(train_dir, step).exists():
        return _read_manifest(train_dir, step).get("extra", {}), step
    return _extra_of(_read_payload(_ckpt_path(train_dir, step))), step


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


def _recorded_digest(path: Path) -> str | None:
    try:
        text = storage.read_text(_digest_path(path))
    except OSError:
        return None
    return text.strip() or None


def artifact_digest(train_dir: str | Path, step: int) -> str | None:
    """The recorded sha256 of a step's artifact (its sidecar), or None."""
    return _recorded_digest(_ckpt_path(Path(train_dir), step))


# -- quantized-tier sidecars ------------------------------------------------

def quant_sidecar_path(train_dir: str | Path, step: int) -> Path:
    """Where a step's quantized-tier sidecar lives. The ``ckpt-`` prefix
    keeps it in the step-grouped GC; the suffix keeps it out of the
    loadable steps."""
    return Path(train_dir) / f"ckpt-{step:08d}.quant.msgpack"


def write_quant_sidecar(train_dir: str | Path, step: int, tiers: dict,
                        meta: dict) -> Path:
    """Atomically publish ``step``'s quantized tiers (tmp + rename, then
    the sha256 sidecar): ``tiers`` maps a tier name to its state-dict
    tree (numpy leaves; the bf16 tier's are CPU bf16 tensors), ``meta``
    is JSON. The bytes are the reference's for the same trees."""
    path = quant_sidecar_path(train_dir, step)
    _write_atomic(path, msgpack_serialize(to_state_dict(
        {"tiers": tiers, "meta": json.dumps(meta)})))
    return path


def read_quant_sidecar(train_dir: str | Path, step: int) -> dict:
    """Digest-verified read of a step's sidecar → ``{"tiers": {...},
    "meta": dict}``, bf16 leaves kept as bf16 tensors. Raises
    ``FileNotFoundError`` when none was published and
    :class:`CheckpointCorruptError` on a torn payload or a sha256
    mismatch — a serving replica then falls back to the full-precision
    artifact."""
    path = quant_sidecar_path(train_dir, step)
    payload = _restore_checked(_verified_read(path), path,
                               keep_bfloat16=True)
    if not isinstance(payload, dict) or not isinstance(
            payload.get("tiers"), dict):
        raise CheckpointCorruptError(
            f"{path.name}: payload has no 'tiers' entry")
    meta = payload.get("meta", {})
    if isinstance(meta, (str, bytes)):
        try:
            meta = json.loads(meta)
        except json.JSONDecodeError as e:
            raise CheckpointCorruptError(
                f"{path.name}: torn meta payload ({e})") from e
    return {"tiers": payload["tiers"], "meta": meta}


def quant_sidecar_digest(train_dir: str | Path, step: int) -> str | None:
    """The recorded sha256 of a step's quant sidecar, or None."""
    return _recorded_digest(quant_sidecar_path(train_dir, step))


_FALLBACK_ERRORS = (FileNotFoundError, CheckpointCorruptError, OSError)


def loadable_steps(train_dir: str | Path) -> list[int]:
    """The steps with a single-file artifact in ``train_dir``,
    ascending (what a rollback walks)."""
    return _loadable_steps(Path(train_dir))


_STATE_FIELDS = ("params", "momentum", "step", "updates_applied", "root_key",
                 "window_acc", "window_rounds", "wall_ms", "next_apply_ms")


def _read_sharded(train_dir: Path, step: int) -> tuple[dict, dict]:
    """Reassemble a per-host checkpoint's state dict from every shard
    file (global arrays; a ``bfloat16`` leaf widened to float32; fields
    without leaves are None) and its ``extra``."""
    manifest = _read_manifest(train_dir, step)
    try:
        pcount = int(manifest["num_shards"])
        meta = manifest["leaves"]
    except (KeyError, TypeError, ValueError) as e:
        raise CheckpointCorruptError(
            f"{_manifest_path(train_dir, step).name}: manifest missing "
            f"required fields ({type(e).__name__}: {e})") from e
    leaves: dict[str, np.ndarray] = {}
    for p in range(pcount):
        spath = _shard_path(train_dir, step, p, pcount)
        payload = _restore_checked(_verified_read(spath), spath)
        try:
            for key, val in payload["leaves"].items():
                if isinstance(val, dict) and "indices" in val:
                    m = meta[key]
                    dt = (np.float32 if m["dtype"] == "bfloat16"
                          else np.dtype(m["dtype"]))
                    buf = leaves.setdefault(
                        key, np.empty(tuple(m["shape"]), dt))
                    for idx, data in zip(val["indices"], val["datas"]):
                        buf[tuple(slice(a, b) for a, b in idx)] = data
                elif key not in leaves:
                    leaves[key] = np.asarray(val)
        except (KeyError, ValueError, TypeError, IndexError) as e:
            raise CheckpointCorruptError(
                f"{spath.name}: shard/manifest structure mismatch "
                f"({type(e).__name__}: {e})") from e
    missing = sorted(set(meta) - set(leaves))
    if missing:
        raise CheckpointCorruptError(
            f"sharded checkpoint step={step} is missing leaves {missing}")
    state: dict = {f: None for f in _STATE_FIELDS}
    for key, arr in leaves.items():
        node = state
        parts = key.split("/")
        for part in parts[:-1]:
            if node.get(part) is None:
                node[part] = {}
            node = node[part]
        node[parts[-1]] = arr
    return state, manifest.get("extra", {})


def _read_state(train_dir: Path, step: int) -> tuple[dict, dict]:
    if _manifest_path(train_dir, step).exists():
        state, extra = _read_sharded(train_dir, step)
        if state.get("params") is None:
            raise CheckpointCorruptError(
                f"ckpt-{step:08d}.manifest.json: no params leaves")
        return state, extra
    payload = _read_payload(_ckpt_path(train_dir, step))
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
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.bfloat16:
        # as the reference digests an ml_dtypes bfloat16 array
        words = tree.detach().cpu().contiguous().view(torch.int16).numpy()
        h.update(b"bfloat16\x00")
        h.update(str(words.shape).encode() + b"\x00")
        h.update(words.tobytes())
        h.update(b"\x00")
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


def checkpoint_state_digests(train_dir: str | Path, step: int | None = None
                             ) -> tuple[str, str, int] | None:
    """(sha256 of the saved params, sha256 of the saved optimizer state,
    step) from one read of the artifact alone (≙ the reference's
    ``checkpoint_state_digests``: what ``obsv/invariants.py
    determinism_verdict`` compares); None when nothing was published."""
    train_dir = Path(train_dir)
    if step is None:
        step = latest_checkpoint_step(train_dir)
        if step is None:
            return None
    state, _ = _read_state(train_dir, step)
    hp, ho = hashlib.sha256(), hashlib.sha256()
    _digest_tree(state["params"], hp)
    _digest_tree(state.get("momentum"), ho)
    return hp.hexdigest(), ho.hexdigest(), step


def checkpoint_params_digest(train_dir: str | Path, step: int | None = None
                             ) -> tuple[str, int] | None:
    """(sha256 of the saved params, step) from the artifact alone (≙ the
    reference's ``checkpoint_params_digest``); None when nothing was
    published."""
    got = checkpoint_state_digests(train_dir, step)
    return None if got is None else (got[0], got[2])


# -- writing ----------------------------------------------------------------

def _write_atomic(path: Path, data: bytes, digest: bool = True) -> None:
    """tmp write, rename, then (with ``digest``) the digest sidecar (tmp +
    rename), as one retried unit."""
    def write() -> None:
        tmp = path.with_name(path.name + ".tmp")
        storage.write_bytes(tmp, data, role="data")
        dpath = _digest_path(path)
        if digest:
            # a re-save of the same step must never leave the old digest
            # over the new bytes: drop it before the data lands (a crash
            # in between leaves a digest-less file, which is accepted)
            dpath.unlink(missing_ok=True)
        storage.replace(tmp, path, role="data")
        if digest:
            dtmp = dpath.with_name(dpath.name + ".tmp")
            storage.write_text(dtmp, hashlib.sha256(data).hexdigest(),
                               role="sidecar")
            storage.replace(dtmp, dpath, role="sidecar")
    _io_retries(write, path.name)


def _write_pointer(train_dir: Path, step: int, latest_name: str) -> None:
    pointer = {"latest_step": step, "latest_path": latest_name,
               "written_at": time.time()}
    ptmp = train_dir / (_POINTER + ".tmp")
    storage.write_text(ptmp, json.dumps(pointer), role="pointer")
    storage.replace(ptmp, train_dir / _POINTER, role="pointer")


def _garbage_collect(train_dir: Path, keep: int) -> None:
    """Keep the newest ``keep`` steps' artifacts (and their sidecars);
    ``keep <= 0`` keeps everything. An unlink that fails is skipped."""
    if keep <= 0:
        return
    by_step: dict[int, list[Path]] = {}
    for f in train_dir.glob("ckpt-*"):
        m = re.match(r"^ckpt-(\d+)\.", f.name)
        if m and not f.name.endswith(".tmp"):
            by_step.setdefault(int(m.group(1)), []).append(f)
    for s in sorted(by_step)[:-keep]:
        for old in by_step[s]:
            try:
                old.unlink()
            except OSError:
                pass


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
    data = msgpack_serialize(to_state_dict(
        {"state": state, "extra": json.dumps(extra or {})}))
    path = _ckpt_path(train_dir, step)
    _write_atomic(path, data)
    _write_pointer(train_dir, step, path.name)
    _garbage_collect(train_dir, keep)
    logger.info("saved checkpoint step=%d → %s", step, path.name)
    return path


def flat_state_items(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``[("a/b/c", leaf)]`` over a state dict as the reference's per-host
    writer names its leaves: dict keys sorted, list items by index, None
    skipped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flat_state_items(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in flat_state_items(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def save_sharded_state(train_dir: str | Path, local: dict, meta: dict,
                       step: int, process_index: int, process_count: int,
                       extra: dict | None = None, keep: int = 0) -> Path:
    """Publish this process's part of a per-host checkpoint at ``step``:
    ``local`` maps leaf keys to whole arrays (process 0's whole leaves)
    or ``{"indices": [[[lo, hi], ...], ...], "datas": [...]}`` slabs;
    ``meta`` maps every key to ``{"full": True}`` or ``{"shape",
    "dtype"}``. Process 0 then writes the manifest and the pointer.
    Every process calls this for the same step."""
    train_dir = Path(train_dir)
    train_dir.mkdir(parents=True, exist_ok=True)
    path = _shard_path(train_dir, step, process_index, process_count)
    _write_atomic(path, msgpack_serialize({"leaves": local}))
    if process_index == 0:
        manifest = {"step": step, "num_shards": process_count,
                    "leaves": meta, "extra": extra or {}}
        manifest["checksum"] = _manifest_checksum(manifest)
        # the manifest carries its own checksum: no digest sidecar
        mpath = _manifest_path(train_dir, step)
        _write_atomic(mpath, json.dumps(manifest).encode(), digest=False)
        _write_pointer(train_dir, step, mpath.name)
        logger.info("saved sharded checkpoint step=%d → %s (+%d shard "
                    "files)", step, mpath.name, process_count)
    _garbage_collect(train_dir, keep)
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


# -- the asynchronous writer ------------------------------------------------

class AsyncCheckpointer:
    """A background thread that writes checkpoints (≙ the reference's
    ``AsyncCheckpointer``), so that packing, hashing and file I/O leave
    the step loop.

    :meth:`save` queues ``(train_dir, state, step, extra, keep)``:
    ``state`` is a host state dict (numpy leaves, the reference layout)
    or, with ``prepare``, anything ``prepare`` turns into one on the
    worker thread — the device snapshot's path, where ``prepare`` copies
    fresh device buffers to the host. A ``prepare`` failure counts as a
    failed write. ``publish(state_dict, step)`` (the quantized tiers'
    pass) runs on the worker after ``prepare`` and before the artifact
    and pointer writes, so a follower that sees the pointer name a step
    finds its sidecar on disk; its failure is logged, never a failed
    write.

    Latest wins: a save queued while another is pending replaces it
    (checkpoints are snapshots, not a journal). A failed write is
    logged, reported to ``on_error(step, exc)`` and raised by the next
    :meth:`wait`; after ``max_consecutive_failures`` failures in a row,
    :meth:`save` raises instead of letting checkpoints go stale."""

    def __init__(self, max_consecutive_failures: int = 3,
                 on_error: Callable[[int, Exception], None] | None = None):
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._pending: tuple | None = None
        self._busy = False
        self._error: Exception | None = None  # the last write's outcome
        self._last_failure: Exception | None = None  # kept across wait()
        self._consecutive_failures = 0
        self.max_consecutive_failures = max_consecutive_failures
        self._on_error = on_error
        self._stop = False
        self.closed = False
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="ckpt-writer")
        self._thread.start()

    def _worker(self) -> None:
        while True:
            with self._wake:
                while self._pending is None and not self._stop:
                    self._wake.wait()
                if self._stop and self._pending is None:
                    return
                job = self._pending
                self._pending = None
                self._busy = True
            train_dir, state, step, extra, keep, prepare, publish = job
            del job  # a prepared snapshot's device buffers go with it
            try:
                if prepare is not None:
                    state = prepare(state)
                if publish is not None:
                    try:
                        publish(state, step)
                    except Exception as e:  # the sidecar is additive
                        logger.warning("pre-save publish hook for step=%d "
                                       "failed: %s", step, e)
                save_state(train_dir, state, step, extra=extra, keep=keep)
            except Exception as e:  # a failed write must not end the thread
                logger.error("async checkpoint write for step=%d failed: %s",
                             step, e)
                with self._lock:
                    self._error = e
                    self._last_failure = e
                    self._consecutive_failures += 1
                if self._on_error is not None:
                    try:
                        self._on_error(step, e)
                    except Exception:
                        logger.exception("checkpoint on_error hook failed")
            else:
                with self._lock:
                    self._error = None  # a later success supersedes
                    self._consecutive_failures = 0
            finally:
                state = None
                with self._wake:
                    self._busy = False
                    self._wake.notify_all()

    def save(self, train_dir: str | Path, state: Any, step: int,
             extra: dict | None = None, keep: int = 5,
             prepare: Callable[[Any], dict] | None = None,
             publish: Callable[[dict, int], Any] | None = None) -> None:
        """Queue a write (replacing a pending one). Raises only after
        ``max_consecutive_failures`` failed writes in a row, or when
        closed."""
        with self._lock:
            if self._consecutive_failures >= self.max_consecutive_failures:
                raise RuntimeError(
                    f"{self._consecutive_failures} consecutive async "
                    "checkpoint writes failed; giving up"
                ) from self._last_failure
        with self._wake:
            if self.closed:
                raise RuntimeError("AsyncCheckpointer is closed")
            if self._pending is not None:
                logger.warning("checkpoint writer lagging; replacing queued "
                               "step=%d with step=%d", self._pending[2], step)
            self._pending = (train_dir, state, step, extra, keep, prepare,
                             publish)
            self._wake.notify_all()

    def wait(self) -> None:
        """Drain the queued and running writes; raise if the last one
        failed (the error is then consumed)."""
        with self._wake:
            while self._pending is not None or self._busy:
                self._wake.wait()
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("async checkpoint write failed") from err

    def close(self) -> None:
        """Drain (raising as :meth:`wait` does), then join the thread."""
        try:
            self.wait()
        finally:
            with self._wake:
                self._stop = True
                self.closed = True
                self._wake.notify_all()
            self._thread.join(timeout=60)


# -- following a run's checkpoints ------------------------------------------

class CheckpointFollower:
    """The hot-follow loop of a checkpoint consumer (≙ the reference's
    ``CheckpointFollower``): :meth:`poll` reads the pointer and, when
    its step advanced past the last one consumed, returns
    ``read(step)``. ``read`` raising ``OSError``, ``ValueError`` (which
    covers :class:`CheckpointCorruptError`) or ``KeyError`` — the
    trainer's GC unlinking the step between the pointer read and the
    read, a torn file, a failed digest — is a skip: remembered in
    ``last_error``, reported to ``on_event`` as a ``follow_skip``
    record, and retried on the next poll. ``read`` returning None
    leaves the cursor where it was."""

    def __init__(self, train_dir: str | Path,
                 on_event: Callable[[dict], None] | None = None):
        self.train_dir = Path(train_dir)
        self.last_step = -1          # the last step consumed
        self.last_error: tuple[int, str] | None = None  # (step, error)
        self.skips = 0
        self._on_event = on_event

    def newest_step(self) -> int | None:
        """The pointer's step (None before the first publish)."""
        return latest_checkpoint_step(self.train_dir)

    def poll(self, read: Callable[[int], Any],
             step: int | None = None) -> Any | None:
        """One tick: ``read(step)``'s result for a newly advanced step,
        else None (nothing new, or the read failed and will be
        retried). ``step``: the step to consider instead of the
        pointer's (processes that must read the same step agree on it
        first)."""
        step = self.newest_step() if step is None else step
        if step is None or step == self.last_step:
            return None
        try:
            out = read(step)
        except (OSError, ValueError, KeyError) as e:
            self.skips += 1
            self.last_error = (step, f"{type(e).__name__}: {e}")
            logger.warning("checkpoint step=%s unreadable (%s); "
                           "skip-and-retry", step, e)
            if self._on_event is not None:
                self._on_event({"layer": "checkpoint",
                                "action": "follow_skip", "step": step,
                                "error": self.last_error[1]})
            return None
        if out is None:
            return None
        self.last_step = step
        return out
