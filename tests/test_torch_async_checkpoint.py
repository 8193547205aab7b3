"""The port's asynchronous checkpoint writer and the Trainer's save arms
(``distributedmnist_tpu_torch/train/checkpoint.py`` ``AsyncCheckpointer``,
``train/loop.py``) on the CPU, against the reference's:

* a state written synchronously, by the writer thread from a host
  state, and by the writer thread from a snapshot (``prepare`` on the
  thread) is byte for byte the artifact the reference writes for it;
  the Trainer's three arms write the same states;
* latest wins, a failed write surfaces on ``wait`` and the writer goes
  on, three failures in a row stop ``save``, ``prepare`` runs on the
  writer's thread and its failure is a failed write;
* a Trainer run with asynchronous saves that dies and is resumed ends
  where an uninterrupted run ends (equal params digests);
* a save that fails on the disk is journaled as ``save_failed`` and the
  run goes on: the same ``eio`` / ``enospc_after_bytes`` scripts on a
  port run and a reference run give the same ``save_failed`` records
  (apart from ``time``), in both the synchronous and asynchronous arm;
* a snapshot that cannot be taken is a failed write, never a fall back
  to the synchronous path.
"""

import json
import threading

import numpy as np
import pytest

from distributedmnist_tpu.core.config import ExperimentConfig as RefConfig
from distributedmnist_tpu.train import checkpoint as ref_ckpt
from distributedmnist_tpu.train import storage as ref_storage
from distributedmnist_tpu.train.loop import Trainer as RefTrainer
from distributedmnist_tpu_torch.core.config import ExperimentConfig
from distributedmnist_tpu_torch.models.convert import state_to_reference
from distributedmnist_tpu_torch.train import checkpoint as ckpt
from distributedmnist_tpu_torch.train import loop, storage
from distributedmnist_tpu_torch.train.loop import Trainer

from _torch_threads import one_torch_thread  # noqa: F401

CNN = {"data": {"dataset": "synthetic", "batch_size": 64,
                "synthetic_train_size": 1024, "synthetic_test_size": 256,
                "use_native_pipeline": False},
       "model": {"compute_dtype": "float32"},
       "optim": {"momentum": 0.9}, "mesh": {"num_replicas": 1}}


@pytest.fixture(autouse=True)
def _disarmed():
    for mod in (storage, ref_storage):
        mod.clear_faults()
    yield
    for mod in (storage, ref_storage):
        mod.clear_faults()


def _cfg(train_dir, cls=ExperimentConfig, **train):
    t = {"max_steps": 6, "log_every_steps": 2, "save_interval_steps": 2,
         "save_results_period": 0, "summary_every_steps": 0,
         "keep_checkpoints": 0, "train_dir": str(train_dir)}
    return cls.from_dict(dict(CNN, train=dict(t, **train)))


def _records(path, kind=None):
    if not path.exists():
        return []
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    return [r for r in recs if kind is None or r.get("event") == kind]


def _state_bytes(d, step):
    """The msgpack bytes of a step's saved state (the ``extra`` differs
    between runs whose configs differ)."""
    data = (d / f"ckpt-{step:08d}.msgpack").read_bytes()
    return ckpt.msgpack_serialize(ckpt.to_state_dict(
        ckpt.msgpack_restore(data)["state"]))


def test_every_write_path_gives_the_reference_bytes(tmp_path):
    tr = Trainer(_cfg(tmp_path / "run"), device="cpu")
    host = state_to_reference(tr.state)
    extra = {"config": tr.cfg.to_dict(), "k": 1}
    ckpt.save_state(tmp_path / "sync", host, 7, extra=extra)
    ac = ckpt.AsyncCheckpointer()
    ac.save(tmp_path / "host", host, 7, extra=extra)
    # latest wins: a save queued before the writer picks up the one
    # before it replaces it, so drain between the two arms
    ac.wait()
    ac.save(tmp_path / "snap", loop.device_snapshot(tr.state), 7,
            extra=extra, prepare=loop.snapshot_to_host)
    ac.close()
    ref_ckpt.save_checkpoint(tmp_path / "ref", host, 7, extra=extra)
    want = (tmp_path / "ref" / "ckpt-00000007.msgpack").read_bytes()
    for arm in ("sync", "host", "snap"):
        d = tmp_path / arm
        assert (d / "ckpt-00000007.msgpack").read_bytes() == want, arm
        assert ((d / "ckpt-00000007.msgpack.sha256").read_text()
                == (tmp_path / "ref" / "ckpt-00000007.msgpack.sha256"
                    ).read_text())


def test_trainer_arms_write_the_same_states(tmp_path):
    arms = {"sync": {"async_checkpoint": False},
            "fetch": {"async_snapshot": False}, "snapshot": {}}
    saves = {}
    for arm, over in arms.items():
        d = tmp_path / arm
        Trainer(_cfg(d, max_steps=4, **over), device="cpu").run()
        saves[arm] = _records(d / "train_log.jsonl", "save")
        assert ckpt.loadable_steps(d) == [2, 4]
    for step in (2, 4):
        got = {arm: _state_bytes(tmp_path / arm, step) for arm in arms}
        assert got["sync"] == got["fetch"] == got["snapshot"], step
    assert [r["async_snapshot"] for r in saves["snapshot"]] == [True] * 3
    assert [r["async_snapshot"] for r in saves["fetch"]] == [False] * 3
    assert all(set(r) == {"event", "time", "at_step", "save_stall_ms",
                          "async_snapshot", "ts"}
               for rs in saves.values() for r in rs)


def test_latest_wins_and_final_step_durable(tmp_path):
    ac = ckpt.AsyncCheckpointer()
    for step in range(1, 30):
        ac.save(tmp_path, {"params": {"w": np.full(4, float(step))}}, step,
                keep=50)
    ac.wait()
    assert ac._pending is None and not ac._busy
    assert ckpt.latest_checkpoint_step(tmp_path) == 29
    state, _, _ = ckpt.restore_state(tmp_path)
    np.testing.assert_array_equal(state["params"]["w"], np.full(4, 29.0))
    ac.close()


def test_worker_error_surfaces_and_the_writer_goes_on(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("a file, not a directory")
    failed = []
    ac = ckpt.AsyncCheckpointer(on_error=lambda s, e: failed.append(s))
    ac.save(blocker, {"w": np.zeros(2)}, 1)
    with pytest.raises(RuntimeError, match="async checkpoint"):
        ac.wait()
    assert failed == [1]
    ac.save(tmp_path, {"w": np.zeros(2)}, 2)
    ac.close()
    assert ckpt.latest_checkpoint_step(tmp_path) == 2
    with pytest.raises(RuntimeError, match="closed"):
        ac.save(tmp_path, {"w": np.zeros(2)}, 3)


def test_consecutive_failures_stop_save(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    failed = []
    ac = ckpt.AsyncCheckpointer(on_error=lambda s, e: failed.append(s))
    for step in (1, 2, 3):
        ac.save(blocker, {"w": np.zeros(2)}, step)
        with pytest.raises(RuntimeError):
            ac.wait()
    assert failed == [1, 2, 3]
    with pytest.raises(RuntimeError, match="3 consecutive"):
        ac.save(tmp_path, {"w": np.zeros(2)}, 4)
    ac.close()


def test_prepare_runs_on_the_writer_thread_and_fails_like_a_write(tmp_path):
    threads = []

    def prepare(s):
        threads.append(threading.current_thread().name)
        return {"params": {"w": s * 2}}

    ac = ckpt.AsyncCheckpointer()
    ac.save(tmp_path, np.arange(3.0), 1, prepare=prepare)
    ac.wait()
    assert threads == ["ckpt-writer"]
    state, _, _ = ckpt.restore_state(tmp_path)
    np.testing.assert_array_equal(state["params"]["w"], [0.0, 2.0, 4.0])

    def broken(s):
        raise MemoryError("no room for the host copy")

    ac.save(tmp_path, None, 2, prepare=broken)
    with pytest.raises(RuntimeError) as ei:
        ac.wait()
    assert isinstance(ei.value.__cause__, MemoryError)
    assert ckpt.latest_checkpoint_step(tmp_path) == 1
    ac.close()


class _Killed(Exception):
    pass


def test_async_run_killed_and_resumed_equals_uninterrupted(tmp_path):
    whole = Trainer(_cfg(tmp_path / "whole", max_steps=10,
                         save_interval_steps=3, log_every_steps=1),
                    device="cpu").run()

    def die(step, record):
        if step == 8:
            raise _Killed()

    d = tmp_path / "killed"
    cfg = _cfg(d, max_steps=10, save_interval_steps=3, log_every_steps=1)
    tr = Trainer(cfg, device="cpu")
    with pytest.raises(_Killed):
        tr.run(step_callback=die)
    assert tr._checkpointer is None  # the writer was drained and joined
    assert ckpt.latest_checkpoint_step(d) == 6
    resumed = Trainer(cfg, device="cpu")
    assert resumed._start_step == 6
    got = resumed.run()
    assert got["final_step"] == 10
    assert got["params_digest"] == whole["params_digest"]


# one EIO save and one ENOSPC save, each through every retry; the steps
# are paced so that the asynchronous writer finishes (and fails) each
# before the next save is queued and nothing is coalesced
SAVE_FAULTS = [
    {"kind": "eio", "op": "write", "nth": 1, "times": 3,
     "match": "ckpt-00000002.msgpack"},
    {"kind": "enospc_after_bytes", "bytes": 0, "times": 3,
     "match": "ckpt-00000004.msgpack"},
]


def _strip(records, drop=("time", "ts")):
    return [{k: v for k, v in r.items() if k not in drop} for r in records]


@pytest.mark.parametrize("arm", ["sync", "async"])
def test_save_failed_is_journaled_and_the_run_goes_on(tmp_path, arm):
    """Queue C item 4: a cadence save that fails on the disk is
    journaled and skipped; both packages finish and journal the same
    records."""
    over = dict(async_checkpoint=arm == "async",
                step_pace_ms=400.0 if arm == "async" else 0.0)
    out = {}
    for side, mod, cls, trainer in (
            ("port", storage, ExperimentConfig,
             lambda c: Trainer(c, device="cpu")),
            ("ref", ref_storage, RefConfig, RefTrainer)):
        d = tmp_path / side
        cfg = _cfg(d, cls=cls, **over)
        tr = trainer(cfg)
        mod.arm_faults(0, SAVE_FAULTS, d / "storage_faults.jsonl")
        summary = tr.run()
        mod.clear_faults()
        assert summary["final_step"] == 6
        out[side] = {
            "recovery": _strip(_records(d / "recovery_journal.jsonl")),
            "faults": _strip(_records(d / "storage_faults.jsonl")),
            "saves": [(r["at_step"], r["async_snapshot"])
                      for r in _records(d / "train_log.jsonl", "save")],
            "steps": ckpt.loadable_steps(d)}
    assert out["port"] == out["ref"]
    failed = out["port"]["recovery"]
    assert [(r["action"], r["step"], r["errno"], r["where"])
            for r in failed] == [("save_failed", 2, 5, arm),
                                 ("save_failed", 4, 28, arm)]
    assert out["port"]["steps"] == [6]
    assert [r["action"] for r in out["port"]["faults"]] == (
        ["disk_eio"] * 3 + ["disk_enospc"] * 3)


def test_a_snapshot_that_fails_is_a_failed_write(tmp_path, monkeypatch):
    real = loop.device_snapshot
    calls = []

    def flaky(state):
        calls.append(state.step)
        if len(calls) == 1:
            raise RuntimeError("CUDA out of memory (simulated)")
        return real(state)

    monkeypatch.setattr(loop, "device_snapshot", flaky)
    d = tmp_path / "run"
    summary = Trainer(_cfg(d, max_steps=4), device="cpu").run()
    assert summary["final_step"] == 4
    failed = _records(d / "recovery_journal.jsonl")
    assert [(r["action"], r["step"], r["where"], r["error"])
            for r in failed] == [
        ("save_failed", 2, "async",
         "RuntimeError: CUDA out of memory (simulated)")]
    assert ckpt.loadable_steps(d) == [4]
