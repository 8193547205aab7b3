"""The port's storage shim (``distributedmnist_tpu_torch/train/
storage.py``) and the checkpoint writer routed through it, against the
reference's (``distributedmnist_tpu/train/storage.py``), in one process:

* the durability knob and its ``ConfigError``;
* the fsync sequence of one save per policy — ``(role, file)`` for
  every ``os.fsync`` — equal to the reference's, and a journal append
  fsynced under ``full`` only;
* each disk fault kind, armed with the same script on both sides over
  the same saves and read: the same ``storage_faults.jsonl`` records,
  the same errors, the same restore, and the same files left on disk
  (names, sizes, bytes), with the clock fixed;
* arming from ``DMT_DISK_FAULTS``, and the script validation errors.
"""

import errno
import json
import os
import time

import numpy as np
import pytest

from distributedmnist_tpu.core.config import ConfigError as RefConfigError
from distributedmnist_tpu.core.log import JsonlSink as RefJsonlSink
from distributedmnist_tpu.train import checkpoint as ref_ckpt
from distributedmnist_tpu.train import storage as ref_storage
from distributedmnist_tpu_torch.core.config import ConfigError
from distributedmnist_tpu_torch.core.log import JsonlSink
from distributedmnist_tpu_torch.train import checkpoint as ckpt
from distributedmnist_tpu_torch.train import storage

SIDES = {"port": (storage, ckpt), "ref": (ref_storage, ref_ckpt)}


@pytest.fixture(autouse=True)
def _disarmed():
    for mod, _ in SIDES.values():
        mod.clear_faults()
        mod.set_durability("none")
    yield
    for mod, _ in SIDES.values():
        mod.clear_faults()
        mod.set_durability("none")


def _state(v: int) -> dict:
    return {"params": {"w": np.full((4, 3), float(v), np.float32),
                       "b": np.arange(3, dtype=np.float32) + v},
            "step": np.int32(v)}


def _save(side: str, d, v: int, keep: int = 5) -> None:
    _, ck = SIDES[side]
    if side == "port":
        ck.save_state(d, _state(v), v, extra={"v": v}, keep=keep)
    else:
        ck.save_checkpoint(d, _state(v), v, extra={"v": v}, keep=keep)


def _restore(side: str, d):
    """(step, w[0, 0], recovery events) of the newest loadable step."""
    _, ck = SIDES[side]
    events = []
    if side == "port":
        got = ck.restore_state(d, on_event=events.append)
        st = None if got is None else got[0]
    else:
        got = ck.restore_checkpoint(d, _state(0), on_event=events.append)
        st = None if got is None else got[0]
    events = [{k: v for k, v in e.items() if k != "layer"} for e in events]
    if got is None:
        return None, None, events
    return got[2], float(st["params"]["w"][0, 0]), events


def _files(d) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())
            if p.name != "storage_faults.jsonl"}


def _fault_records(path) -> list:
    if not path.exists():
        return []
    return [{k: v for k, v in json.loads(line).items()
             if k not in ("ts", "time")}
            for line in path.read_text().splitlines()]


def test_durability_policy_knob():
    assert storage.durability() == "none"
    assert not storage.journal_sync_enabled()
    with pytest.raises(ConfigError, match="valid policies") as port_err:
        storage.set_durability("paranoid")
    with pytest.raises(RefConfigError) as ref_err:
        ref_storage.set_durability("paranoid")
    assert str(port_err.value) == str(ref_err.value)
    storage.set_durability("full")
    assert storage.durability() == "full" and storage.journal_sync_enabled()
    storage.set_durability("data")
    assert not storage.journal_sync_enabled()


def _role(name: str) -> str:
    if name == ".":
        return "dir"
    if name.endswith(".sha256.tmp"):
        return "sidecar"
    if name.startswith("checkpoint.json"):
        return "pointer"
    return "data"


def _fsyncs(monkeypatch, d, fn) -> list:
    """``(role, file)`` of every ``os.fsync`` while ``fn`` runs."""
    seen = []
    real = os.fsync

    def spy(fd):
        target = os.readlink(f"/proc/self/fd/{fd}")
        name = "." if target == str(d) else os.path.basename(target)
        seen.append((_role(name), name))
        return real(fd)

    monkeypatch.setattr(os, "fsync", spy)
    try:
        fn()
    finally:
        monkeypatch.setattr(os, "fsync", real)
    return seen


# one save after a first one: the fsyncs the reference makes, by policy
FSYNCS_PER_SAVE = {"none": 0, "data": 1, "full": 6}


@pytest.mark.parametrize("policy", ["none", "data", "full"])
def test_fsync_sequence_matches_reference(tmp_path, monkeypatch, policy):
    seqs = {}
    for side, (mod, _) in SIDES.items():
        d = tmp_path / side
        d.mkdir()
        _save(side, d, 3)
        mod.set_durability(policy)
        seqs[side] = _fsyncs(monkeypatch, d, lambda: _save(side, d, 6))
        # a journal append fsyncs under "full" alone
        sink_cls = JsonlSink if side == "port" else RefJsonlSink
        sink = sink_cls(d / "journal.jsonl")
        n = len(_fsyncs(monkeypatch, d,
                        lambda: sink.write({"event": "recovery",
                                            "action": "save_failed",
                                            "step": 6, "error": "x"})))
        sink.close()
        assert n == (1 if policy == "full" else 0), (side, n)
        mod.set_durability("none")
    assert seqs["port"] == seqs["ref"]
    assert len(seqs["port"]) == FSYNCS_PER_SAVE[policy]
    if policy == "full":
        assert seqs["port"] == [
            ("data", "ckpt-00000006.msgpack.tmp"), ("dir", "."),
            ("sidecar", "ckpt-00000006.msgpack.sha256.tmp"), ("dir", "."),
            ("pointer", "checkpoint.json.tmp"), ("dir", ".")]


FAULT_SCRIPTS = {
    "enospc_after_bytes": {"kind": "enospc_after_bytes", "bytes": 0,
                           "match": ".msgpack", "times": 3},
    "eio_write": {"kind": "eio", "op": "write", "nth": 2, "times": 3},
    "eio_read": {"kind": "eio", "op": "read", "nth": 1, "times": 1,
                 "match": "ckpt-00000009"},
    "slow_io_ms": {"kind": "slow_io_ms", "ms": 1.0, "times": 4},
    "torn_write_at_byte": {"kind": "torn_write_at_byte", "at_byte": 37,
                           "match": ".msgpack", "times": 3},
    "crash_rename": {"kind": "crash_rename",
                     "match": "ckpt-00000006.msgpack", "keep_bytes": 5},
}


def _fault_run(side: str, d, script: dict):
    """Save 3, arm ``script`` at step 6 (``at_step``), save 6 and 9,
    then restore: what each op raised, the journal and the restore."""
    mod, _ = SIDES[side]
    d.mkdir()
    _save(side, d, 3, keep=2)
    mod.arm_faults(0, [dict(script, at_step=6)], d / "storage_faults.jsonl")
    outcomes = []
    for v in (6, 9):
        mod.note_step(v)
        try:
            _save(side, d, v, keep=2)
            outcomes.append(None)
        except OSError as e:
            outcomes.append((e.errno, str(e)))
    restored = _restore(side, d)
    mod.clear_faults()  # closes the journal
    return outcomes, _fault_records(d / "storage_faults.jsonl"), restored


@pytest.mark.parametrize("name", sorted(FAULT_SCRIPTS))
def test_fault_kind_matches_reference(tmp_path, monkeypatch, name):
    monkeypatch.setattr(time, "time", lambda: 1_800_000_000.0)
    script = FAULT_SCRIPTS[name]
    got = {side: _fault_run(side, tmp_path / side, script)
           for side in SIDES}
    assert got["port"] == got["ref"]
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    outcomes, records, (step, value, events) = got["port"]
    assert records and all(r["event"] == "fault" and r["worker"] == 0
                           and r["action"].startswith("disk_")
                           for r in records)
    if name in ("enospc_after_bytes", "torn_write_at_byte"):
        want = errno.ENOSPC if name.startswith("enospc") else errno.EIO
        assert outcomes[0][0] == want and outcomes[1] is None
        assert len(records) == ckpt._IO_ATTEMPTS
    if name == "crash_rename":
        assert outcomes == [None, None]
        assert (step, value) == (9, 9.0)  # the hollow step 6 was GC'd
    if name == "eio_read":
        assert [r["op"] for r in records] == ["read"]
        assert (step, value, events) == (9, 9.0, [])


def test_disk_faults_env_arming(tmp_path, monkeypatch):
    """``DMT_DISK_FAULTS`` arms the injector at the first shim op, with
    the worker ordinal and journal it names; a malformed value is
    ignored with a warning."""
    records = {}
    for side, (mod, _) in SIDES.items():
        d = tmp_path / side
        d.mkdir()
        spec = {"worker": 2, "journal": str(d / "storage_faults.jsonl"),
                "faults": [{"kind": "eio", "op": "write", "nth": 1,
                            "match": ".msgpack", "at_step": 4}]}
        monkeypatch.setenv(mod.DISK_FAULTS_ENV, json.dumps(spec))
        monkeypatch.setattr(mod, "_INJECTOR", None)
        monkeypatch.setattr(mod, "_ENV_CHECKED", False)
        _save(side, d, 2)       # before at_step: quiet
        mod.note_step(4)
        _save(side, d, 4)       # one EIO, absorbed by the retries
        mod.clear_faults()
        records[side] = _fault_records(d / "storage_faults.jsonl")
        assert _restore(side, d)[:2] == (4, 4.0)
    assert records["port"] == records["ref"]
    assert [(r["worker"], r["action"], r["at_step"])
            for r in records["port"]] == [(2, "disk_eio", 4)]
    monkeypatch.setenv(storage.DISK_FAULTS_ENV, "{not json")
    monkeypatch.setattr(storage, "_INJECTOR", None)
    monkeypatch.setattr(storage, "_ENV_CHECKED", False)
    storage.note_step(1)
    assert storage._INJECTOR is None


@pytest.mark.parametrize("script,match", [
    ({"kind": "enospc"}, "unknown disk fault kind"),
    ({"kind": "eio", "bogus": 1}, "unknown field"),
    ({"kind": "crash_rename", "keep": 3}, "unknown field"),
])
def test_disk_fault_script_validation(script, match):
    with pytest.raises(ValueError, match=match) as port_err:
        storage.DiskFaultInjector(0, [script])
    with pytest.raises(ValueError) as ref_err:
        ref_storage.DiskFaultInjector(0, [script])
    assert str(port_err.value) == str(ref_err.value)
    assert set(storage.DISK_FAULT_KINDS) == set(ref_storage.DISK_FAULT_KINDS)
