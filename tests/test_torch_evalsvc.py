"""The port's continuous evaluator (``distributedmnist_tpu_torch/
evalsvc``, ``launch eval``) on the CPU, against the reference's
(``distributedmnist_tpu/evalsvc``), over checkpoints written directly
(no training):

* the port's and the reference's ``Evaluator`` over the same directory
  adopt the same config and give equal ``num_examples`` and
  ``precision_at_1`` and a ``loss`` within 1e-6 relative, and print the
  same line up to the loss (``eval_line`` is the reference's format);
* a corrupt newest artifact is skipped and retried (a ``follow_skip``
  record), then evaluated once the publish lands;
* ``run_once`` and ``max_evals`` end the loop; ``eval_log.jsonl``
  records pass the reference's schema; TensorBoard gets the validation
  scalars;
* ``launch eval --device cpu`` as a subprocess evaluates the newest
  step; without ``--device`` it wants CUDA and fails without it;
  ``--single_device`` refuses a pipeline-stacked config.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distributedmnist_tpu.core.config import EvalConfig as RefEvalConfig
from distributedmnist_tpu.core.log import eval_line as ref_eval_line
from distributedmnist_tpu.evalsvc import Evaluator as RefEvaluator
from distributedmnist_tpu.obsv.schema import validate_event
from distributedmnist_tpu_torch.core.config import EvalConfig, ExperimentConfig
from distributedmnist_tpu_torch.core.log import eval_line
from distributedmnist_tpu_torch.evalsvc import Evaluator
from distributedmnist_tpu_torch.models.convert import state_to_reference
from distributedmnist_tpu_torch.models.registry import get_model
from distributedmnist_tpu_torch.parallel.api import (init_train_state,
                                                     tree_map)
from distributedmnist_tpu_torch.train import checkpoint as ckpt

from _torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
CNN = {"data": {"dataset": "synthetic", "batch_size": 64,
                "synthetic_train_size": 256, "synthetic_test_size": 200,
                "use_native_pipeline": False},
       "model": {"compute_dtype": "float32"},
       "optim": {"momentum": 0.9}, "mesh": {"num_replicas": 1}}
LINE = re.compile(r"^Num examples: (\d+) Precision @ 1: ([0-9.]+) "
                  r"Loss: ([0-9.]+) Time: ([0-9.]+)$")


def _publish(d, steps=(10, 20)) -> ExperimentConfig:
    """One checkpoint per step, each a differently scaled init state,
    with the run config saved in it as the Trainer saves it."""
    cfg = ExperimentConfig.from_dict(dict(CNN, train={"train_dir": str(d)}))
    state = init_train_state(get_model(cfg.model), cfg, torch.device("cpu"))
    for i, step in enumerate(steps):
        scaled = tree_map(lambda t: t * (1.0 + 0.5 * i), state.params)
        host = state_to_reference(state)
        host["params"] = state_to_reference(
            type(state)(**{**state.__dict__, "params": scaled}))["params"]
        host["step"] = np.asarray(step, np.int32)
        ckpt.save_state(d, host, step, extra={"config": cfg.to_dict()})
    return cfg


def test_port_and_reference_evaluators_agree(tmp_path, capsys):
    d = tmp_path / "train"
    cfg = _publish(d)
    port = Evaluator(d, EvalConfig(eval_dir=str(tmp_path / "pe"),
                                   run_once=True, eval_interval_secs=0.01),
                     single_device=True, device="cpu")
    ref = RefEvaluator(d, RefEvalConfig(eval_dir=str(tmp_path / "re"),
                                        run_once=True,
                                        eval_interval_secs=0.01),
                       single_device=True)
    assert port.cfg.to_dict() == cfg.to_dict() == ref.cfg.to_dict()
    capsys.readouterr()
    got = {}
    for name, ev in (("port", port), ("ref", ref)):
        got[name] = {s: ev.evaluate_checkpoint(s) for s in (10, 20)}
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4 and all(LINE.match(x) for x in lines)
    for s in (10, 20):
        a, b = got["port"][s], got["ref"][s]
        assert a["step"] == b["step"] == s
        assert a["num_examples"] == b["num_examples"] == 200
        assert a["precision_at_1"] == b["precision_at_1"]
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-6)
    # the printed lines agree up to the loss (which agrees to 1e-6)
    strip = lambda x: x.rsplit(" Loss:", 1)[0]  # noqa: E731
    assert [strip(x) for x in lines[:2]] == [strip(x) for x in lines[2:]]
    assert got["port"][10]["precision_at_1"] != got["port"][20][
        "precision_at_1"] or got["port"][10]["loss"] != got["port"][20][
        "loss"]
    for args in ((10000, 0.9876, 0.0421, 3.5), (7, 1.0, 2.302585, 0.01)):
        assert eval_line(*args) == ref_eval_line(*args)


def test_corrupt_newest_artifact_is_skipped_and_retried(tmp_path):
    d = tmp_path / "train"
    cfg = _publish(d)
    newest = d / "ckpt-00000020.msgpack"
    good = newest.read_bytes()
    newest.write_bytes(good[: len(good) // 2])  # its sidecar stays
    ev = Evaluator(d, EvalConfig(eval_dir=str(tmp_path / "e")), cfg=cfg,
                   device="cpu")
    assert ev.poll_once() is None
    assert ev.last_step_evaluated == -1
    assert ev.follower.skips == 1 and ev.follower.last_error[0] == 20
    assert "sha256 mismatch" in ev.follower.last_error[1]
    assert ev.poll_once() is None and ev.follower.skips == 2
    newest.write_bytes(good)  # the publish lands
    out = ev.poll_once()
    assert out is not None and out["step"] == 20
    assert ev.last_step_evaluated == 20
    assert ev.poll_once() is None  # nothing new: not evaluated again


def test_run_once_max_evals_and_journals(tmp_path):
    d = tmp_path / "train"
    cfg = _publish(d, steps=(10,))
    e = tmp_path / "eval"
    ev = Evaluator(d, EvalConfig(eval_dir=str(e), run_once=True,
                                 eval_interval_secs=0.01), device="cpu")
    assert [r["step"] for r in ev.run()] == [10]
    # a follower with max_evals=2 whose first read of step 20 finds it
    # torn: the skip is journaled, the publish lands, 20 is evaluated,
    # then 30 is published and evaluated, and the loop ends
    _publish(d, steps=(10, 20))
    art = d / "ckpt-00000020.msgpack"
    good = art.read_bytes()
    art.write_bytes(good[:100])
    # (the config comes from the caller: adopting it would read the
    # torn newest artifact)
    ev2 = Evaluator(d, EvalConfig(eval_dir=str(e), max_evals=2,
                                  eval_interval_secs=0.01), cfg=cfg,
                    device="cpu")
    journal = ev2.follower._on_event
    ev2.follower._on_event = lambda r: (journal(r), art.write_bytes(good))
    read = ev2._read_and_eval

    def read_then_publish(step):
        out = read(step)
        if step == 20:
            _publish(d, steps=(10, 20, 30))
        return out

    ev2._read_and_eval = read_then_publish
    assert [r["step"] for r in ev2.run()] == [20, 30]
    recs = [json.loads(x) for x in
            (e / "eval_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [10, 20, 30]
    for r in recs:
        assert validate_event(r, source="eval_log.jsonl") == []
    skips = [json.loads(x) for x in
             (e / "recovery_journal.jsonl").read_text().splitlines()]
    assert [(r["action"], r["step"]) for r in skips] == [("follow_skip", 20)]
    for r in skips:
        assert validate_event(r, source="recovery_journal.jsonl") == []
    events = sorted((e / "tb").glob("events.out.tfevents.*"))
    assert len(events) == 2
    assert all(b"Validation Accuracy" in p.read_bytes() for p in events)


def test_config_adoption_and_single_device_refusals(tmp_path):
    d = tmp_path / "train"
    cfg = _publish(d, steps=(10,))
    ev = Evaluator(d, EvalConfig(eval_dir=str(tmp_path / "e")),
                   device="cpu")
    assert ev.cfg.model == cfg.model and ev.cfg.data == cfg.data
    assert ev.topo.num_replicas == 1
    pp = cfg.override({"mesh.pipeline_parallelism": 2})
    with pytest.raises(ValueError, match="single_device"):
        Evaluator(d, EvalConfig(), cfg=pp, single_device=True, device="cpu")


def _launch_eval(d, e, *extra):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-m", "distributedmnist_tpu_torch.launch", "eval",
         "--train_dir", str(d), "--eval_dir", str(e), *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_launch_eval_subprocess(tmp_path):
    d = tmp_path / "train"
    _publish(d)
    p = _launch_eval(d, tmp_path / "eval", "--run_once",
                     "--eval_interval_secs", "0.01", "--device", "cpu")
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [x for x in p.stdout.splitlines() if x.startswith("Num ")]
    assert len(lines) == 1 and LINE.match(lines[0])
    rec = json.loads((tmp_path / "eval" / "eval_log.jsonl").read_text())
    assert rec["step"] == 20 and rec["num_examples"] == 200
    if torch.cuda.is_available():
        return
    p = _launch_eval(d, tmp_path / "eval2", "--run_once")
    assert p.returncode != 0
    assert "CUDA is not available" in p.stderr
