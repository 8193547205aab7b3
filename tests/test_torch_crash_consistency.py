"""The reference's crash-point matrix (``tests/test_crash_consistency.py``)
over the port's atomic save (``distributedmnist_tpu_torch/train/
checkpoint.py`` through ``train/storage.py``): tmp write → data rename
→ digest sidecar → pointer, each crash leaving a directory that
restores on the last durable step.

* Each crash point is played by the port's writer and restored by the
  port, by the reference, and — the other way round — played by the
  reference's writer and restored by the port: all three land on the
  same step and value, with the same fallback records.
* A crash lands either through the shim's disk faults or as a
  ``SimulatedCrash`` (not an ``OSError``, so the retries pass it on as a
  process death would) between shim ops.
* The reference's own replay checks (``obsv/invariants.py``
  ``check_storage_faults``, ``check_checkpoint_dir``,
  ``storage_exempt_targets``) run green over a port trial directory.
"""

import errno
import json

import numpy as np
import pytest

from distributedmnist_tpu.obsv.invariants import (
    check_checkpoint_dir, check_storage_faults, load_storage_faults,
    storage_exempt_targets)
from distributedmnist_tpu.train import checkpoint as ref_ckpt
from distributedmnist_tpu.train import storage as ref_storage
from distributedmnist_tpu_torch.train import checkpoint as ckpt
from distributedmnist_tpu_torch.train import storage

MODULES = {"port": (storage, ckpt), "ref": (ref_storage, ref_ckpt)}


class SimulatedCrash(Exception):
    """A process death between shim ops."""


@pytest.fixture(autouse=True)
def _disarmed():
    for mod, _ in MODULES.values():
        mod.clear_faults()
    yield
    for mod, _ in MODULES.values():
        mod.clear_faults()


def _state(v: int) -> dict:
    return {"params": {"w": np.full((4, 3), float(v), np.float32)},
            "step": np.int32(v)}


def _save(side, d, v):
    if side == "port":
        ckpt.save_state(d, _state(v), v)
    else:
        ref_ckpt.save_checkpoint(d, _state(v), v)


def _restored(side, d):
    """(step, value, fallback actions) of the newest loadable step."""
    events = []
    if side == "port":
        st, _, step = ckpt.restore_state(d, on_event=events.append)
    else:
        st, _, step = ref_ckpt.restore_checkpoint(d, _state(0),
                                                  on_event=events.append)
    return (step, float(st["params"]["w"][0, 0]),
            [(e["action"], e.get("bad_step", e.get("step")))
             for e in events])


def _crash_in(monkeypatch, mod, fn_name, role):
    """Crash the first shim call of ``fn_name`` made with ``role``."""
    real = getattr(mod, fn_name)

    def boom(*args, **kwargs):
        if kwargs.get("role", args[2] if len(args) > 2 else None) == role:
            raise SimulatedCrash(f"{fn_name}(role={role})")
        return real(*args, **kwargs)

    monkeypatch.setattr(mod, fn_name, boom)


def _fault(script):
    def arm(monkeypatch, mod, d):
        mod.arm_faults(0, [script], d / "storage_faults.jsonl")
    return arm


def _crash(fn_name, role):
    def arm(monkeypatch, mod, d):
        _crash_in(monkeypatch, mod, fn_name, role)
    return arm


ATTEMPTS = ckpt._IO_ATTEMPTS
# crash point → (how it is armed, the error the save of step 6 raises
# (None: it "succeeds"), the restore that must follow, files that must
# exist / must not after the crash)
POINTS = {
    "torn_tmp_write": (
        _fault({"kind": "torn_write_at_byte", "at_byte": 37,
                "match": ".msgpack", "times": ATTEMPTS}),
        errno.EIO, (3, 3.0, []), ["ckpt-00000006.msgpack.tmp"],
        ["ckpt-00000006.msgpack"]),
    "post_tmp_pre_rename": (
        _crash("replace", "data"), SimulatedCrash, (3, 3.0, []),
        ["ckpt-00000006.msgpack.tmp"], ["ckpt-00000006.msgpack"]),
    "post_rename_pre_digest": (
        _crash("write_text", "sidecar"), SimulatedCrash, (6, 6.0, []),
        ["ckpt-00000006.msgpack"], ["ckpt-00000006.msgpack.sha256"]),
    "post_digest_pre_pointer": (
        _crash("write_text", "pointer"), SimulatedCrash, (6, 6.0, []),
        ["ckpt-00000006.msgpack.sha256"], []),
    "mid_pointer": (
        _crash("replace", "pointer"), SimulatedCrash, (6, 6.0, []),
        ["checkpoint.json.tmp"], []),
    "enospc_all_retries": (
        _fault({"kind": "enospc_after_bytes", "bytes": 0,
                "match": ".msgpack", "times": ATTEMPTS}),
        errno.ENOSPC, (3, 3.0, []), [], ["ckpt-00000006.msgpack"]),
    "transient_eio": (
        _fault({"kind": "eio", "op": "write", "nth": 1,
                "match": ".msgpack", "times": 1}),
        None, (6, 6.0, []), [], []),
    "crash_rename": (
        _fault({"kind": "crash_rename", "match": "ckpt-00000006.msgpack"}),
        None, (3, 3.0, [("corrupt_checkpoint_fallback", 6),
                        ("fallback_restore", 3)]), [], []),
    "at_step_gated": (
        _fault({"kind": "eio", "op": "write", "nth": 1, "at_step": 10,
                "match": ".msgpack", "times": ATTEMPTS}),
        None, (6, 6.0, []), [], []),
}

PAIRS = [("port", "port"), ("port", "ref"), ("ref", "port")]


@pytest.mark.parametrize("writer,reader", PAIRS,
                         ids=[f"{w}-writes-{r}-restores" for w, r in PAIRS])
@pytest.mark.parametrize("point", sorted(POINTS))
def test_crash_point_restores_last_durable_step(tmp_path, monkeypatch,
                                                point, writer, reader):
    arm, raises, want, present, absent = POINTS[point]
    mod, _ = MODULES[writer]
    _save(writer, tmp_path, 3)
    arm(monkeypatch, mod, tmp_path)
    if raises is None:
        _save(writer, tmp_path, 6)
    elif raises is SimulatedCrash:
        with pytest.raises(SimulatedCrash):
            _save(writer, tmp_path, 6)
    else:
        with pytest.raises(OSError) as ei:
            _save(writer, tmp_path, 6)
        assert ei.value.errno == raises
    monkeypatch.undo()
    mod.clear_faults()
    for name in present:
        assert (tmp_path / name).exists(), name
    for name in absent:
        assert not (tmp_path / name).exists(), name
    assert _restored(reader, tmp_path) == want
    if point == "at_step_gated":
        # past at_step the same script makes every retry fail
        _save(writer, tmp_path, 7)
        arm(monkeypatch, mod, tmp_path)
        mod.note_step(10)
        with pytest.raises(OSError):
            _save(writer, tmp_path, 10)
        mod.clear_faults()
        assert _restored(reader, tmp_path)[:2] == (7, 7.0)


def test_torn_pointer_body_falls_back_to_scan(tmp_path):
    ckpt.save_state(tmp_path, _state(3), 3)
    ckpt.save_state(tmp_path, _state(6), 6)
    (tmp_path / "checkpoint.json").write_text('{"latest_step": 6, "la')
    assert ckpt.latest_checkpoint_step(tmp_path) == 6
    assert ref_ckpt.latest_checkpoint_step(tmp_path) == 6


def _recovery(d, records):
    with open(d / "recovery_journal.jsonl", "a") as fh:
        for r in records:
            fh.write(json.dumps({"event": "recovery", **r}) + "\n")


def test_reference_invariants_pass_over_a_port_trial(tmp_path):
    """A crash_rename trial written by the port: the injector journal,
    the hollow artifact and the fallback records replay green under the
    reference's invariant 14, and invariant 5 accepts the damaged
    artifact only through the storage exemption."""
    d = tmp_path / "worker0"
    d.mkdir()
    ckpt.save_state(d, _state(3), 3)
    storage.arm_faults(0, [{"kind": "crash_rename",
                            "match": "ckpt-00000006.msgpack"}],
                       d / "storage_faults.jsonl")
    ckpt.save_state(d, _state(6), 6)
    events = []
    ckpt.restore_state(d, on_event=events.append)
    storage.clear_faults()
    _recovery(d, [{"layer": "checkpoint", **e} for e in events])
    sf = load_storage_faults(tmp_path)
    assert [r["action"] for r in sf[0]] == ["disk_crash_rename"]
    violations, applicable = check_storage_faults(tmp_path, [])
    assert applicable and violations == []
    exempt = storage_exempt_targets(sf)
    assert exempt == {0: {"ckpt-00000006.msgpack"}}
    assert check_checkpoint_dir(d, exempt[0], worker=0) == []
    assert any(v.invariant == "checkpoint_integrity"
               for v in check_checkpoint_dir(d, set(), worker=0))


def test_reference_invariants_license_a_port_save_failed(tmp_path):
    """A skipped save journaled by the port after an injected ENOSPC is
    licensed; the same record with no injected fault is a violation."""
    d = tmp_path / "worker0"
    d.mkdir()
    ckpt.save_state(d, _state(3), 3)
    storage.arm_faults(0, [{"kind": "enospc_after_bytes", "bytes": 0,
                            "match": ".msgpack", "times": ATTEMPTS}],
                       d / "storage_faults.jsonl")
    storage.note_step(6)
    with pytest.raises(OSError) as ei:
        ckpt.save_state(d, _state(6), 6)
    storage.clear_faults()
    _recovery(d, [{"layer": "train", "action": "save_failed", "step": 6,
                   "error": f"OSError: {ei.value}",
                   "errno": ei.value.errno, "where": "sync"}])
    assert check_storage_faults(tmp_path, []) == ([], True)
    assert check_checkpoint_dir(d, set(), worker=0) == []
    (d / "storage_faults.jsonl").unlink()
    violations, _ = check_storage_faults(tmp_path, [])
    assert [v.invariant for v in violations] == ["storage_faults"]
