"""The port's own observability (``distributedmnist_tpu_torch/obsv/
schema.py``, ``journal.py``, ``invariants.py``, ``report.py``,
``launch/sweep.py`` and the ``sweep``/``report``/``devices`` verbs)
against the reference's modules of the same names.

The same artifacts go through both packages' checkers and summaries:
one port run and one reference run of the adaptive quorum CNN on 8
replicas (``tests/test_torch_discipline.py``'s spike profile, which
journals discipline changes; a save every 7 steps; the series dumps),
and hand-written trial directories and journals that break each
invariant on purpose. Verdicts, violations (``to_dict``), summaries and
``stats.json`` are equal — exactly, since both read the same bytes with
the same arithmetic.
"""

import json
import math
import shutil

import numpy as np
import pytest

from conftest import base_config
from distributedmnist_tpu.obsv import invariants as ref_inv
from distributedmnist_tpu.obsv import journal as ref_journal
from distributedmnist_tpu.obsv import report as ref_report
from distributedmnist_tpu.obsv import schema as ref_schema
from distributedmnist_tpu.train.loop import Trainer as RefTrainer
from distributedmnist_tpu_torch.core.config import ExperimentConfig
from distributedmnist_tpu_torch.core.log import JsonlSink
from distributedmnist_tpu_torch.launch.__main__ import main
from distributedmnist_tpu_torch.obsv import invariants as inv
from distributedmnist_tpu_torch.obsv import journal, report, schema
from distributedmnist_tpu_torch.train.loop import Trainer

from _torch_threads import one_torch_thread  # noqa: F401

RUN = {"sync": {"mode": "quorum", "adaptive": True,
                "adaptive_window_steps": 4, "adaptive_cooldown_steps": 4,
                "straggler_profile": "spike", "straggler_spike_prob": 0.25,
                "straggler_spike_scale": 8.0},
       "train": {"max_steps": 14, "log_every_steps": 1,
                 "save_interval_steps": 7, "save_results_period": 7}}
DATA = {"dataset": "synthetic", "batch_size": 64,
        "synthetic_train_size": 1024, "synthetic_test_size": 256,
        "use_native_pipeline": False}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{"port": trial dir, "ref": trial dir}``, each holding its run's
    train_dir as ``worker0``."""
    root = tmp_path_factory.mktemp("obsv")
    port, ref = root / "port" / "worker0", root / "ref" / "worker0"
    Trainer(ExperimentConfig.from_dict({
        "data": DATA, "model": {"compute_dtype": "float32"},
        "mesh": {"num_replicas": 8}, "sync": RUN["sync"],
        "train": {**RUN["train"], "train_dir": str(port)}}),
        device="cpu").run()
    RefTrainer(base_config(sync=RUN["sync"], train={
        **RUN["train"], "train_dir": str(ref)})).run()
    return {"port": port.parent, "ref": ref.parent}


def _vs(violations) -> list:
    return [v.to_dict() for v in violations]


def _checks(mod, trial) -> dict:
    """Every single-run checker of ``mod`` over one trial dir."""
    w = trial / "worker0"
    log = mod.load_jsonl(w / "train_log.jsonl")
    steps = [r for r in log if r.get("event") == "step"]
    disc, applicable = mod.check_discipline(steps, log, worker=0)
    serving = mod.check_serving(trial, {}, [])
    storage = mod.check_storage_faults(trial, [])
    return {"metrics": _vs(mod.check_metrics_log(steps, 0, worker=0)),
            "ckpt": _vs(mod.check_checkpoint_dir(w, worker=0)),
            "discipline": (_vs(disc), applicable),
            "serving": (_vs(serving[0]), *serving[1:]),
            "storage": (_vs(storage[0]), storage[1]),
            "splice": mod.splice_rollbacks(steps)[1]}


@pytest.mark.parametrize("which", ["port", "ref"])
def test_checkers_agree_on_a_run(runs, which):
    """Both packages' checkers on one run's artifacts: the same
    verdicts (a clean run: no violations; discipline applicable with
    its licensed changes)."""
    got, want = _checks(inv, runs[which]), _checks(ref_inv, runs[which])
    assert got == want
    assert got["metrics"] == got["ckpt"] == [] and got["splice"] == 0
    assert got["discipline"] == ([], True)
    assert got["serving"][1] is False and got["storage"][1] is False


def test_determinism_verdict_agrees(runs, tmp_path):
    """A same-seed rerun of the port's run is bitwise its own (checked,
    no violation); the port's run against the reference's differs in
    its init, so both packages report the same two violations."""
    again = tmp_path / "worker0"
    Trainer(ExperimentConfig.from_dict({
        "data": DATA, "model": {"compute_dtype": "float32"},
        "mesh": {"num_replicas": 8}, "sync": RUN["sync"],
        "train": {**RUN["train"], "train_dir": str(again)}}),
        device="cpu").run()
    port = runs["port"] / "worker0"
    for mod in (inv, ref_inv):
        ok, vs = mod.determinism_verdict(again, port, worker=0)
        assert ok and vs == []
    got = inv.determinism_verdict(port, runs["ref"] / "worker0", worker=0)
    want = ref_inv.determinism_verdict(port, runs["ref"] / "worker0",
                                       worker=0)
    assert (got[0], _vs(got[1])) == (want[0], _vs(want[1]))
    assert got[0] and [v.invariant for v in got[1]] == ["determinism"]


def _broken_trial(root):
    """A trial dir that breaks each single-run invariant: a train log
    with a gap and an unexplained rewind, a torn checkpoint and a
    pointer to a missing one, an unlicensed discipline change, a
    serving replica that dropped a request and swapped backwards, a
    save_failed no disk fault licenses."""
    w = root / "worker0"
    w.mkdir(parents=True)
    steps = [{"event": "step", "step": s, "loss": 1.0, "train_acc": 0.5,
              "discipline": [4.0, 0.0] if s < 4 else [3.0, 0.0]}
             for s in (1, 2, 4, 3, 4, 5)]
    disc = [{"event": "discipline", "action": "begin", "at_step": 7,
             "value": 1.0, "op": ">=", "threshold": 2.0,
             "decision": "tighten_quorum", "trigger": "p99_over_p50",
             "new_k": 3, "new_timeout_ms": 0.0}]
    (w / "train_log.jsonl").write_text("".join(
        json.dumps(r) + "\n" for r in steps + disc))
    (w / "ckpt-00000005.msgpack").write_bytes(b"not the digest's bytes")
    (w / "ckpt-00000005.msgpack.sha256").write_text("0" * 64)
    (w / "checkpoint.json").write_text(json.dumps(
        {"latest_path": "ckpt-00000009.msgpack", "step": 9}))
    (w / "recovery_journal.jsonl").write_text(json.dumps(
        {"event": "recovery", "action": "save_failed", "step": 5,
         "layer": "train"}) + "\n")
    (w / "serve_log.jsonl").write_text("".join(json.dumps(r) + "\n" for r in (
        {"event": "serve", "action": "weight_swap", "step": 9, "time": 1.0},
        {"event": "serve", "action": "admit", "id": 1},
        {"event": "serve", "action": "weight_swap", "step": 5, "time": 2.0})))
    (root / "loadgen.jsonl").write_text("".join(json.dumps(r) + "\n" for r in (
        {"event": "load", "action": "issue", "id": 1},
        {"event": "load", "action": "issue", "id": 2},
        {"event": "load", "action": "outcome", "id": 1})))
    return root


def test_checkers_agree_on_broken_artifacts(tmp_path):
    """Every checker finds the same violations, in the same words, in
    both packages."""
    trial = _broken_trial(tmp_path / "trial")
    got, want = _checks(inv, trial), _checks(ref_inv, trial)
    assert got == want
    assert got["splice"] == 1
    assert got["metrics"] and got["ckpt"] and got["discipline"][0]
    assert got["serving"][0] and got["storage"][0]
    assert {v["invariant"] for v in got["serving"][0]} == {
        "serve_outcomes", "serve_monotone"}


def _journals(root):
    """A command journal, recovery, serve, discipline and reconfigure
    records, written through the port's sink (schema-checked)."""
    cmd = root / "command_journal.jsonl"
    with JsonlSink(cmd) as sink:
        for i, (verb, rc, retry) in enumerate(
                (("create", 0, False), ("run", 1, True), ("run", 0, False),
                 ("probe", 1, False))):
            sink.write({"event": "command", "verb": verb, "argv": [verb],
                        "rc": rc, "duration_ms": 10.0 * (i + 1),
                        "will_retry": retry, "check": verb != "probe",
                        "time": 100.0 + i})
        for r in ({"action": "detect", "worker": 1, "kind": "dead",
                   "time": 200.0},
                  {"action": "restart", "worker": 1, "attempt": 1,
                   "at_step": 10, "via": "respawn", "time": 201.0},
                  {"action": "resume", "worker": 1, "time": 203.5,
                   "step": 12, "mttr_s": 3.5},
                  {"action": "nan_rollback", "from_step": 9,
                   "to_step": 5, "loss": "nan"}):
            sink.write({"event": "recovery", **r})
        world = {"old_world": 3, "new_world": 2, "trigger": "below_quorum"}
        for r in ({"action": "begin", **world, "quorum": 3,
                   "effective_quorum": 2, "survivors": [0, 1]},
                  {"action": "resume", **world, "reconfigure_s": 4.0,
                   "worker": 0, "step": 20}):
            sink.write({"event": "reconfigure", "time": 300.0, **r})
    serve = [{"event": "serve", "action": "weight_swap", "step": 5,
              "tier": "int8"},
             {"event": "serve", "action": "weight_swap", "step": 10},
             {"event": "serve", "action": "follow_quant_sidecar_fallback"}]
    disc = [{"event": "discipline", "action": "begin",
             "decision": "tighten_quorum", "trigger": "p99_over_p50",
             "at_step": 8, "cooldown_steps": 4},
            {"event": "discipline", "action": "complete",
             "effective_step": 9, "k": 3, "timeout_ms": 0.0,
             "reaction_s": 0.01},
            {"event": "discipline", "action": "begin",
             "decision": "relax_quorum", "trigger": "p50_recovered",
             "at_step": 10, "cooldown_steps": 4}]
    return cmd, serve, disc


def test_journal_summaries_agree(tmp_path):
    cmd, serve, disc = _journals(tmp_path)
    for name in ("summarize_journal", "summarize_recovery",
                 "summarize_reconfigures"):
        assert getattr(journal, name)(cmd) == getattr(ref_journal, name)(cmd)
    assert journal.summarize_journal(cmd)["failures"] == 0
    assert journal.summarize_recovery(cmd)["mttr"]["episodes"] == 1
    assert journal.summarize_serving_swaps(serve) == \
        ref_journal.summarize_serving_swaps(serve)
    assert journal.summarize_discipline(disc) == \
        ref_journal.summarize_discipline(disc)
    assert journal.summarize_discipline(disc)["flaps"] == 1
    recs = [json.loads(x) for x in cmd.read_text().splitlines()]
    assert list(journal.tail_records(cmd)) == list(
        ref_journal.tail_records(cmd)) == recs[::-1]


def test_schema_is_the_reference_registry():
    """The copied registry declares the same kinds and fields, and the
    sink refuses what it refuses."""
    assert schema.event_kinds() == ref_schema.event_kinds()
    for kind in schema.event_kinds():
        assert schema.payload_fields(kind) == ref_schema.payload_fields(kind)
    bad = {"event": "step", "steps": 3}
    assert schema.validate_event(bad) == ref_schema.validate_event(bad)
    assert schema.validate_event(bad)


def test_sink_validates_under_the_switch(tmp_path, monkeypatch):
    monkeypatch.setenv("DMT_VALIDATE_EVENTS", "1")
    with JsonlSink(tmp_path / "a.jsonl") as sink:
        with pytest.raises(schema.EventSchemaError, match="undeclared"):
            sink.write({"event": "step", "step": 1, "bogus": 2})
        sink.write({"name": "a sweep row, no event"})
    monkeypatch.setenv("DMT_VALIDATE_EVENTS", "0")
    with JsonlSink(tmp_path / "b.jsonl") as sink:
        sink.write({"event": "step", "step": 1, "bogus": 2})


@pytest.mark.parametrize("which", ["port", "ref"])
def test_report_stats_agree(runs, which, tmp_path):
    """``experiment_stats`` and ``generate_report``'s ``stats.json`` on
    one run, by both packages; ``launch report`` through ``main``
    prints the same stats."""
    w = runs[which] / "worker0"
    data, ref_data = report.load_experiment(w), ref_report.load_experiment(w)
    assert report.experiment_stats(data) == ref_report.experiment_stats(
        ref_data)
    got = report.generate_report(w, None, tmp_path / "port")
    want = ref_report.generate_report(w, None, tmp_path / "ref")
    assert got == want
    assert json.loads((tmp_path / "port" / "stats.json").read_text()) == \
        json.loads((tmp_path / "ref" / "stats.json").read_text())
    assert got["num_steps"] == 14 and len(got["per_replica"]) == 8
    steps = report.load_jsonl(w / "train_log.jsonl", "step")
    st = np.load(w / "step_times.npy")
    np.testing.assert_array_equal(
        report.modeled_step_durations_ms(steps, st),
        ref_report.modeled_step_durations_ms(steps, st))
    assert report.steps_to_loss(steps, 2.0) == ref_report.steps_to_loss(
        steps, 2.0)
    main(["report", "--train_dir", str(w), "--out", str(tmp_path / "cli")])
    assert json.loads((tmp_path / "cli" / "stats.json").read_text()) == got


def test_sweep_and_devices_through_main(tmp_path, capsys):
    """``launch sweep`` on two tiny configs (fresh runs, one record
    each in ``sweep_results.jsonl``, ``report.md``, each run's
    ``stats.json``), ``--only`` picking one; ``launch devices --device
    cpu`` naming this process and the CPU."""
    cfgs = tmp_path / "cfgs"
    cfgs.mkdir()
    for name, sync in (("quorum_small", {"mode": "quorum",
                                         "num_replicas_to_aggregate": 2}),
                       ("interval_small", {"mode": "interval",
                                           "interval_ms": 300.0})):
        (cfgs / f"{name}.json").write_text(json.dumps({
            "name": name, "data": dict(DATA, synthetic_train_size=256,
                                       synthetic_test_size=64),
            "model": {"compute_dtype": "float32"},
            "mesh": {"num_replicas": 4},
            "sync": {**sync, "straggler_profile": "lognormal",
                     "straggler_mean_ms": 100.0},
            "train": {"max_steps": 4, "log_every_steps": 2}}))
    out = tmp_path / "results"
    main(["sweep", "--configs", str(cfgs), "--results", str(out),
          "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["name"] for r in printed] == ["interval_small", "quorum_small"]
    rows = [json.loads(x) for x in
            (out / "sweep_results.jsonl").read_text().splitlines()]
    assert [r["name"] for r in rows] == ["interval_small", "quorum_small"]
    assert all(r["steps"] == 4 and math.isfinite(r["final_loss"])
               for r in rows)
    assert (out / "report.md").read_text().count("_small |") == 2
    for r in rows:
        stats = json.loads((out / r["name"] / "figures" / "stats.json")
                           .read_text())
        assert stats["num_steps"] == 4
    shutil.rmtree(out)
    main(["sweep", "--configs", str(cfgs), "--results", str(out),
          "--only", "quorum_small", "--device", "cpu"])
    assert [json.loads(x)["name"] for x in (out / "sweep_results.jsonl")
            .read_text().splitlines()] == ["quorum_small"]
    capsys.readouterr()
    main(["devices", "--device", "cpu"])
    info = json.loads(capsys.readouterr().out)
    assert info == {"process_index": 0, "process_count": 1,
                    "devices": [{"id": 0, "platform": "cpu",
                                 "kind": "cpu"}]}
