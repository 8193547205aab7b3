"""The Trainer's profiler windows (``distributedmnist_tpu_torch/train/
loop.py ProfilerWindows``) on the CPU, as the reference's
``tests/test_train_smoke.py`` holds its own: ``train.trace_every_steps``
writes one trace a cadence window under ``profile/step_<k>``, both
knobs set is refused when the run starts, and ``train.profile_steps``
traces its window into ``profile/``. A window's trace is a Chrome trace
(``trace.json``) whose events include the steps' operators."""

import json
from pathlib import Path

import pytest

from distributedmnist_tpu_torch.core.config import ExperimentConfig
from distributedmnist_tpu_torch.train.loop import Trainer

from _torch_threads import one_torch_thread  # noqa: F401

SMALL = {"data": {"dataset": "synthetic_lm", "batch_size": 8,
                  "synthetic_train_size": 40, "synthetic_test_size": 16,
                  "use_native_pipeline": False},
         "model": {"name": "transformer", "seq_len": 16, "model_dim": 32,
                   "num_heads": 2, "num_layers": 1, "vocab_size": 16,
                   "compute_dtype": "float32", "attention_impl": "flash"},
         "mesh": {"num_replicas": 1}}


def make_trainer(train_dir, **train):
    t = {"max_steps": 5, "log_every_steps": 5, "train_dir": str(train_dir),
         "save_interval_steps": 0, "save_results_period": 0,
         "summary_every_steps": 0, **train}
    return Trainer(ExperimentConfig.from_dict(dict(SMALL, train=t)),
                   device="cpu")


def trace_names(path: Path) -> set:
    return {e.get("name") for e in json.loads(path.read_text())
            ["traceEvents"]}


def test_trace_every_steps_dumps_per_window(tmp_path):
    """≙ the reference's ``test_trace_every_steps_dumps_per_window``:
    ``trace_every_steps=2`` over 5 steps gives exactly ``step_0``,
    ``step_2`` and ``step_4``, each holding a trace file."""
    make_trainer(tmp_path, trace_every_steps=2).run()
    profile = tmp_path / "profile"
    windows = sorted(p.name for p in profile.iterdir())
    assert windows == ["step_0", "step_2", "step_4"]
    for w in windows:
        files = [p for p in (profile / w).rglob("*") if p.is_file()]
        assert [p.name for p in files] == ["trace.json"], w
        assert any(n and n.startswith("aten::") for n in
                   trace_names(files[0])), w


def test_trace_and_profile_window_conflict(tmp_path):
    """≙ the reference's ``test_trace_and_profile_window_conflict``."""
    t = make_trainer(tmp_path, max_steps=3, profile_steps=(1, 2),
                     trace_every_steps=2)
    with pytest.raises(ValueError, match="not both"):
        t.run()


def test_profile_steps_window(tmp_path):
    """``profile_steps=(1, 3)``: one trace in ``profile/`` holding the
    steps' operators (the flash attention's Functions among them), the
    run itself unchanged."""
    s = make_trainer(tmp_path, profile_steps=(1, 3)).run()
    assert s["final_step"] == 5
    profile = tmp_path / "profile"
    assert sorted(p.name for p in profile.iterdir()) == ["trace.json"]
    names = trace_names(profile / "trace.json")
    assert "FlashAttention" in names and "FlashAttentionBackward" in names, \
        sorted(n for n in names if n and "Flash" in n)
