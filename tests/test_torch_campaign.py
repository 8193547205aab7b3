"""The port's flagship campaign (``distributedmnist_tpu_torch/launch/
campaign.py``, the ``launch campaign`` verb) against the reference's
``distributedmnist_tpu/launch/campaign.py``, on the CPU.

* The grid is the reference's: ``GROUPS``, ``DEFAULT_GROUPS``,
  ``OVERRIDES``, ``EVALUATED_RUN(S)`` and ``SUMMARY_NOTES`` equal, and
  every name resolves under ``configs/``.
* ``finalize``: the same hand-written ``sweep_results.jsonl`` files (a
  rerun name; a ``long`` group, so a note fires) through both packages
  give the same ``campaign_summary.json`` bytes and prune the same
  files; a second finalize changes nothing.
* The ``cdf`` group through both packages' ``run_group``: tiny copies of
  its four configs (batch 16, 3 steps, float32, the native pipeline on
  for both sides: each batches in the C++ loader's permutation where the
  host has a spare core, C15) on a small idx fixture.
  The records' discrete fields are equal, ``final_loss`` agrees at
  float32's ``rtol 1e-5`` (``tests/test_torch_sync_modes.py``), and
  ``test_accuracy`` is within one test example.
* The ambient mesh: a config that names no mesh runs 8 replicas, one
  with ``mesh.simulate_devices=2`` runs 2, and neither is recorded as an
  override.
* ``repro_mnist99`` on the CPU with a real ``launch eval`` child: the
  evaluator journals the final checkpoint's step, at the record's
  ``test_accuracy``.
* C12, a reference fault fixed in the port's copy: the reference's
  ``stop_evaluator`` sleeps a fixed 8 s whatever the evaluator is
  doing; the port's waits until the run's newest checkpoint is
  evaluated, the child exits, or its bound passes. No test here takes
  the reference's stop timing as ground truth.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from distributedmnist_tpu.core.config import ExperimentConfig as RefConfig
from distributedmnist_tpu.launch import campaign as ref_campaign
from distributedmnist_tpu_torch.core.config import ExperimentConfig
from distributedmnist_tpu_torch.data.fixtures import materialize_idx_fixture
from distributedmnist_tpu_torch.launch import campaign
from distributedmnist_tpu_torch.launch.__main__ import main as cli_main

from _torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "configs"
# the record fields a run decides without floating-point arithmetic
DISCRETE = ("name", "mode", "num_replicas", "aggregate_k", "interval_ms",
            "straggler_profile", "steps", "updates_applied", "overrides",
            "group")
TEST_EXAMPLES = 64


@pytest.mark.parametrize("name", ["GROUPS", "DEFAULT_GROUPS", "OVERRIDES",
                                  "EVALUATED_RUN", "EVALUATED_RUNS",
                                  "SUMMARY_NOTES"])
def test_grid_is_the_reference_grid(name):
    assert getattr(campaign, name) == getattr(ref_campaign, name)


def test_every_name_resolves_under_configs():
    names = {n for group in campaign.GROUPS.values() for n in group}
    for name in names:
        path = campaign.resolve_config_path(CONFIGS, name)
        assert path == ref_campaign.resolve_config_path(CONFIGS, name)
        assert ExperimentConfig.from_file(path).name == name
    assert "mnist_99" in names and campaign.EVALUATED_RUNS <= names
    with pytest.raises(FileNotFoundError):
        campaign.resolve_config_path(CONFIGS, "no_such_run")


# -- finalize ------------------------------------------------------------

def _record(name, acc, group, steps=10):
    return {"name": name, "mode": "quorum", "num_replicas": 8,
            "aggregate_k": 4, "interval_ms": 1000.0,
            "straggler_profile": "lognormal", "steps": steps,
            "updates_applied": steps - 1, "wall_seconds": 1.5,
            "examples_per_sec": 1234.5, "final_loss": 0.5,
            "final_train_acc": 0.9, "test_accuracy": acc, "test_loss": 0.4,
            "timing": {"barrier": {"p50": 1.0, "p99": 2.0}},
            "overrides": {"train.max_steps": steps}, "group": group}


# group -> records in file order ("quorum_k4_of_8" is a rerun: the
# latest record wins)
FINALIZE_GROUPS = {
    "quorum": [_record("quorum_k4_of_8", 0.5, "quorum"),
               _record("quorum_k8_of_8", 0.75, "quorum"),
               _record("quorum_k4_of_8", 0.625, "quorum", steps=12)],
    "interval": [_record("interval_3000ms", 0.875, "interval")],
    "cdf50": [_record("cdf50_spike", 0.25, "cdf50")],
    "long": [_record("interval_long", 1.0, "long")],
}


def _write_results(root: Path) -> None:
    for group, recs in FINALIZE_GROUPS.items():
        gdir = root / group
        gdir.mkdir(parents=True)
        (gdir / "sweep_results.jsonl").write_text(
            "".join(json.dumps(r) + "\n" for r in recs))
        for r in recs:
            train = gdir / r["name"] / "train"
            train.mkdir(parents=True, exist_ok=True)
            for f in ("ckpt-00000005.msgpack", "ckpt-00000005.msgpack.sha256",
                      "CHECKPOINT", "checkpoint.json"):
                (train / f).write_text("x")
    (root / "loose").mkdir()  # a directory with no sweep results


def _ckpt_files(root: Path) -> set:
    return {p.relative_to(root).as_posix() for p in root.rglob("*")
            if p.name.startswith(("ckpt-", "CHECKPOINT", "checkpoint"))}


def test_finalize_writes_the_reference_summary(tmp_path):
    port, ref = tmp_path / "port", tmp_path / "ref"
    _write_results(port)
    _write_results(ref)
    campaign.finalize(port)
    ref_campaign.finalize(ref)
    got = (port / "campaign_summary.json").read_bytes()
    assert got == (ref / "campaign_summary.json").read_bytes()
    summary = json.loads(got)
    assert sorted(summary["groups"]) == sorted(FINALIZE_GROUPS)
    assert summary["groups"]["quorum"] == [
        {"name": "quorum_k4_of_8", "test_accuracy": 0.625,
         "examples_per_sec": 1234.5, "updates_applied": 11},
        {"name": "quorum_k8_of_8", "test_accuracy": 0.75,
         "examples_per_sec": 1234.5, "updates_applied": 9}]
    # interval_long exists, cdf50_long does not
    assert list(summary["notes"]) == ["interval"]
    kept = _ckpt_files(port)
    assert kept == _ckpt_files(ref)
    assert kept and not any(p.endswith((".msgpack", "CHECKPOINT"))
                            for p in kept)
    for group in FINALIZE_GROUPS:
        assert (port / group / "report.md").exists()
    before = {p: p.read_bytes() for p in port.rglob("*")
              if p.is_file() and p.suffix != ".png"}
    campaign.finalize(port)
    after = {p: p.read_bytes() for p in port.rglob("*")
             if p.is_file() and p.suffix != ".png"}
    assert after == before


# -- runs ----------------------------------------------------------------

@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """A small MNIST idx fixture (the reference's bytes for the same
    arguments) in the campaign's ``<cache>/<dataset>`` layout."""
    root = tmp_path_factory.mktemp("data")
    materialize_idx_fixture(root / "mnist", "mnist", num_train=512,
                            num_test=TEST_EXAMPLES)
    return root


def _tiny_configs(root: Path, names, **sections) -> Path:
    """Copies of ``configs/`` entries under their own names, each
    section's keys updated from ``sections``."""
    root.mkdir(parents=True, exist_ok=True)
    for name in names:
        d = json.loads(campaign.resolve_config_path(CONFIGS, name)
                       .read_text())
        for sec, vals in sections.items():
            d[sec] = {**d.get(sec, {}), **vals}
        (root / f"{name}.json").write_text(json.dumps(d))
    return root


@pytest.fixture(scope="module")
def cdf_runs(tmp_path_factory, data_dir):
    root = tmp_path_factory.mktemp("cdf")
    names = campaign.GROUPS["cdf"]
    # use_native_pipeline on: the reference batches in its C++ loader's
    # permutation on a host with a spare core, and so does the port's
    # iterator since C15 was repaired
    cfgs = _tiny_configs(root / "configs", names,
                         data={"batch_size": 16,
                               "use_native_pipeline": True},
                         model={"compute_dtype": "float32"},
                         train={"max_steps": 3, "log_every_steps": 1})
    port = campaign.run_group("cdf", names, root / "port", cfgs, data_dir,
                              quick=False, device="cpu")
    ref = ref_campaign.run_group("cdf", names, root / "ref", cfgs, data_dir,
                                 quick=False)
    return port, ref, root


@pytest.mark.parametrize("i", range(4))
def test_cdf_group_matches_the_reference(cdf_runs, i):
    port, ref = cdf_runs[0][i], cdf_runs[1][i]
    assert set(port) == set(ref)
    assert {k: port[k] for k in DISCRETE} == {k: ref[k] for k in DISCRETE}
    assert port["num_replicas"] == 8 and port["steps"] == 3
    assert port["final_loss"] == pytest.approx(ref["final_loss"], rel=1e-5)
    assert abs(port["test_accuracy"] - ref["test_accuracy"]) \
        <= 1 / TEST_EXAMPLES + 1e-12


def test_cdf_group_files(cdf_runs):
    """The port's group dir: one record a run in ``sweep_results.jsonl``
    in the group's order, and ``report.md`` naming every run."""
    port, _, root = cdf_runs
    gdir = root / "port" / "cdf"
    rows = [json.loads(line) for line in
            (gdir / "sweep_results.jsonl").read_text().splitlines()]
    assert [r["name"] for r in rows] == campaign.GROUPS["cdf"]
    assert rows == json.loads(json.dumps(port))
    report = (gdir / "report.md").read_text()
    assert all(f"| {n} |" in report for n in campaign.GROUPS["cdf"])


@pytest.mark.parametrize("mesh,want", [({}, 8), ({"simulate_devices": 2}, 2)])
def test_ambient_mesh(tmp_path, data_dir, mesh, want):
    name = "quorum_k2_of_8"
    cfgs = _tiny_configs(tmp_path / "configs", [name],
                         data={"batch_size": 16},
                         model={"compute_dtype": "float32"},
                         train={"max_steps": 2, "log_every_steps": 1},
                         mesh=mesh)
    rec, = campaign.run_group("quorum", [name], tmp_path / "results", cfgs,
                              data_dir, quick=False, device="cpu")
    assert rec["num_replicas"] == want
    assert rec["overrides"] == {
        "data.data_dir": str(data_dir / "mnist"), "data.download": False}
    saved = ExperimentConfig.from_file(
        tmp_path / "results" / "quorum" / name / "config.json")
    assert saved.mesh.simulate_devices == want
    assert RefConfig.from_file(cfgs / f"{name}.json").mesh.simulate_devices \
        == mesh.get("simulate_devices", 0)


def test_repro_mnist99_with_a_live_evaluator(tmp_path, data_dir):
    """The evaluated group on the CPU, end to end: the ``launch eval``
    child journals the final checkpoint, and its precision there is the
    record's test accuracy (the same checkpoint and split)."""
    cfgs = _tiny_configs(tmp_path / "configs", ["mnist_99"],
                         data={"batch_size": 16},
                         model={"compute_dtype": "float32"},
                         train={"max_steps": 4, "log_every_steps": 2,
                                "save_interval_steps": 2},
                         eval={"eval_batch_size": 32})
    results = tmp_path / "results"
    rec, = campaign.run_group("repro_mnist99", ["mnist_99"], results, cfgs,
                              data_dir, quick=False, device="cpu")
    assert rec["steps"] == 4 and rec["num_replicas"] == 8
    assert rec["overrides"]["train.save_interval_secs"] == 60.0
    run = results / "repro_mnist99" / "mnist_99"
    evals = [json.loads(line) for line in
             (run / "eval" / "eval_log.jsonl").read_text().splitlines()]
    final = [e for e in evals if e["step"] == 4]
    assert final, evals
    assert final[-1]["precision_at_1"] == rec["test_accuracy"]
    assert final[-1]["num_examples"] == TEST_EXAMPLES
    assert (run / "figures" / "stats.json").exists()
    assert "Precision @ 1" in (run / "evaluator_stdout.log").read_text()


# -- C12: stop_evaluator -------------------------------------------------

def _run_dir(root: Path, step: int = 7) -> Path:
    """A run dir whose newest checkpoint is ``step`` (the pointer and
    the file it names)."""
    train = root / "train"
    train.mkdir(parents=True)
    path = f"ckpt-{step:08d}.msgpack"
    (train / path).write_bytes(b"")
    (train / "checkpoint.json").write_text(json.dumps(
        {"latest_step": step, "latest_path": path, "written_at": 0.0}))
    return root


_WRITE_LATER = """
import json, os, sys, time
time.sleep(0.5)
os.makedirs(sys.argv[1], exist_ok=True)
with open(os.path.join(sys.argv[1], "eval_log.jsonl"), "a") as f:
    f.write(json.dumps({"event": "eval", "step": 3}) + "\\n")
    f.write(json.dumps({"event": "eval", "step": 7}) + "\\n")
time.sleep(600)
"""


def _child(code: str, *args) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", code, *map(str, args)])


def test_c12_stop_waits_for_the_final_evaluation(tmp_path):
    run = _run_dir(tmp_path)
    proc = _child(_WRITE_LATER, run / "eval")
    t0 = time.monotonic()
    got = campaign.stop_evaluator(proc, run)
    took = time.monotonic() - t0
    assert got["ended_by"] == "evaluated" and got["step"] == 7
    assert 0.4 < got["waited_s"] < 5.0 and took < 8.0
    assert proc.returncode is not None


def test_c12_stop_gives_up_at_its_bound(tmp_path, monkeypatch):
    monkeypatch.setattr(campaign, "STOP_BOUND_S", 0.6)
    run = _run_dir(tmp_path)
    proc = _child("import time; time.sleep(600)")
    got = campaign.stop_evaluator(proc, run)
    assert got["ended_by"] == "bound" and 0.6 <= got["waited_s"] < 3.0
    assert proc.returncode is not None


def test_c12_stop_returns_when_the_child_exits(tmp_path):
    run = _run_dir(tmp_path)
    proc = _child("pass")
    proc.wait()
    got = campaign.stop_evaluator(proc, run, bound_s=60.0)
    assert got["ended_by"] == "exited" and got["waited_s"] < 1.0


def test_c12_the_reference_sleeps_a_fixed_8s(tmp_path, monkeypatch):
    """The divergence the port's copy fixes: the reference's stop sleeps
    8.0 s before it terminates, whatever the evaluator has done."""
    slept = []
    monkeypatch.setattr(ref_campaign.time, "sleep", slept.append)
    proc = _child("import time; time.sleep(600)")
    ref_campaign.stop_evaluator(proc, _run_dir(tmp_path))
    # the first sleep is the stop's own; Popen.wait polls through the
    # same (patched) time.sleep after it
    assert slept[0] == 8.0 and proc.returncode is not None


# -- the CLI -------------------------------------------------------------

def test_unknown_group_is_a_usage_error(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        cli_main(["campaign", "--groups", "quorum,nope",
                  "--results", str(tmp_path / "r"), "--device", "cpu"])
    assert e.value.code == 2
    assert "unknown groups ['nope']" in capsys.readouterr().err


def test_cuda_wanted_without_cuda_is_an_error(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        campaign.campaign_device(None)
    assert campaign.campaign_device("cpu") == "cpu"


def test_finalize_only_through_the_cli(tmp_path):
    _write_results(tmp_path / "r")
    cli_main(["campaign", "--finalize-only", "--results",
              str(tmp_path / "r")])
    summary = json.loads((tmp_path / "r" / "campaign_summary.json")
                         .read_text())
    assert sorted(summary["groups"]) == sorted(FINALIZE_GROUPS)


def test_chip_smoke_record_keys_are_the_references(cdf_runs):
    """``chip_smoke.py`` holds the reference's record keys as a literal
    (the card has no JAX): they are the keys the reference's campaign
    writes to ``sweep_results.jsonl``."""
    import chip_smoke
    _, _, root = cdf_runs
    rows = [json.loads(line) for line in
            (root / "ref" / "cdf" / "sweep_results.jsonl").read_text()
            .splitlines()]
    assert all(set(r) == chip_smoke.CAMPAIGN_RECORD_KEYS for r in rows)
