"""The port's adaptive straggler discipline
(``distributedmnist_tpu_torch/train/discipline.py``) and its wiring in
the Trainer (``train/loop.py``), against the reference's.

* ``decide`` equals the reference's ``decide`` — the same ``Decision``
  or None — on a seeded grid of configs (quorum and timeout, marks,
  window, cooldown, quorum floor) and ``WindowStats`` (ratios in and
  around the dead band, short and degenerate windows, inside and past
  the cooldown, at the floor and at the static ceiling);
  ``static_params``, ``quorum_floor``, ``threshold_holds`` and
  ``discipline_trace`` agree too.
* The controller's journal equals the reference controller's on the
  same sequence of windows, but for the clock's own fields (``time``,
  ``reaction_s``).
* A Trainer run of 14 steps on 8 simulated replicas under the spike
  profile with ``sync.adaptive`` (``tests/test_discipline.py``'s
  end-to-end case): its discipline records (without ``time``,
  ``reaction_s`` and the sink's ``ts``) and its step flags equal the
  reference Trainer's, and its ``train_log.jsonl`` replays green under
  the reference's ``obsv/invariants.py check_discipline``.
* ``sync.measure_device_skew`` on the CPU: a float32 ``a@a@a`` on
  ``[640, 640]`` dispatched for replica 3 after every step costs it its
  quorum seat (``tests/test_train_smoke.py``'s injection case).
"""

import dataclasses
import itertools
import json

import numpy as np
import pytest
import torch

from conftest import base_config
from distributedmnist_tpu.core.config import SyncConfig as RefSync
from distributedmnist_tpu.obsv import invariants as inv
from distributedmnist_tpu.train import discipline as ref_disc
from distributedmnist_tpu.train.loop import Trainer as RefTrainer
from distributedmnist_tpu_torch.core.config import (ExperimentConfig,
                                                    SyncConfig)
from distributedmnist_tpu_torch.parallel.api import make_discipline_vector
from distributedmnist_tpu_torch.train import discipline as disc
from distributedmnist_tpu_torch.train.loop import Trainer

from _torch_threads import one_torch_thread  # noqa: F401

N = 8
_CLOCK_FIELDS = ("time", "reaction_s", "ts")

# the config grid: mode × marks × window/cooldown × quorum floor
CONFIGS = [
    dict(mode=mode, adaptive=True, adaptive_window_steps=w,
         adaptive_cooldown_steps=c, adaptive_tail_high=hi,
         adaptive_tail_low=lo, adaptive_min_quorum_frac=frac,
         timeout_ms=400.0)
    for mode, (w, c), (hi, lo), frac in itertools.product(
        ("quorum", "timeout"), ((4, 4), (3, 10)), ((2.0, 1.3), (1.5, 1.1)),
        (0.5, 0.25))]


def _windows(seed: int) -> list[tuple]:
    """(WindowStats kwargs, k, timeout_ms, last_change, now)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(60):
        base = float(rng.choice([0.0, 10.0, 50.0, 120.0]))
        ratio = float(rng.choice([0.5, 1.0, 1.1, 1.3, 1.31, 1.6, 1.99, 2.0,
                                  3.0, 9.0]))
        fast = float(rng.choice([0.0, base, base * 0.5]))
        stats = dict(p50_ms=base, p90_ms=base * 1.2, p99_ms=base * ratio,
                     n_samples=int(rng.integers(1, 12)), fast_p50_ms=fast)
        out.append((stats, int(rng.integers(1, N + 1)),
                    float(rng.choice([400.0, 75.0, 75.2, 1.0, 600.0])),
                    rng.choice([None, 0.0, 5.0, 9.0]),
                    float(rng.integers(5, 30))))
    return out


def _decision(d):
    return None if d is None else dataclasses.asdict(d)


@pytest.mark.parametrize("ci", range(len(CONFIGS)))
def test_decide_matches_reference(ci):
    kw = CONFIGS[ci]
    port_cfg, ref_cfg = SyncConfig(**kw), RefSync(**kw)
    assert dataclasses.asdict(disc.static_params(port_cfg, N)) == \
        dataclasses.asdict(ref_disc.static_params(ref_cfg, N))
    floor = disc.quorum_floor(port_cfg, N)
    assert floor == ref_disc.quorum_floor(ref_cfg, N)
    decided = 0
    for stats, k, tmo, last, now in _windows(ci):
        k = max(k, floor)  # the controller never goes below its floor
        cur = disc.DisciplineParams(k=k, timeout_ms=tmo, interval_ms=1000.0,
                                    num_replicas=N)
        ref_cur = ref_disc.DisciplineParams(k=k, timeout_ms=tmo,
                                            interval_ms=1000.0,
                                            num_replicas=N)
        got = disc.decide(port_cfg, disc.WindowStats(**stats), cur, last,
                          now)
        want = ref_disc.decide(ref_cfg, ref_disc.WindowStats(**stats),
                               ref_cur, last, now)
        assert _decision(got) == _decision(want), (kw, stats, k, tmo,
                                                   last, now)
        decided += got is not None
    assert decided > 0
    # adaptive off, or no window: never a decision
    off = SyncConfig(**dict(kw, adaptive=False))
    assert disc.decide(off, disc.WindowStats(50.0, 50.0, 500.0, 20, 50.0),
                       disc.static_params(port_cfg, N), None, 50) is None
    assert disc.decide(port_cfg, None, disc.static_params(port_cfg, N),
                       None, 50) is None


def test_threshold_holds_and_trace_match_reference():
    for value, op, thr in itertools.product((1.2, 1.3, 2.0, 2.1),
                                            (">=", "<="), (1.3, 2.0)):
        assert disc.threshold_holds(value, op, thr) == \
            ref_disc.threshold_holds(value, op, thr)
    recs = [{"event": "discipline", "action": "complete",
             "effective_step": 5, "k": 7, "timeout_ms": 100.0},
            {"event": "step", "step": 5},
            {"event": "discipline", "action": "complete", "k": 6},
            {"event": "discipline", "action": "begin"}]
    assert disc.discipline_trace(recs) == ref_disc.discipline_trace(recs)


def test_controller_journal_matches_reference():
    kw = dict(mode="quorum", adaptive=True, adaptive_window_steps=4,
              adaptive_cooldown_steps=4)
    logs = {"port": [], "ref": []}
    port = disc.DisciplineController(SyncConfig(**kw), N,
                                     logs["port"].append,
                                     make_discipline_vector)
    ref = ref_disc.DisciplineController(RefSync(**kw), N, logs["ref"].append,
                                        lambda *a: np.asarray(a))
    rng = np.random.default_rng(3)
    for step in range(4, 80, 2):
        ratio = float(rng.choice([1.0, 1.6, 3.0, 9.0]))
        stats = dict(p50_ms=50.0, p90_ms=60.0, p99_ms=50.0 * ratio,
                     n_samples=4, fast_p50_ms=50.0)
        port.maybe_adapt(step, disc.WindowStats(**stats))
        ref.maybe_adapt(step, ref_disc.WindowStats(**stats))
        assert port.vector.tolist() == [float(port.current.k),
                                        port.current.timeout_ms,
                                        port.current.interval_ms]
    strip = lambda recs: [{k: v for k, v in r.items()
                           if k not in _CLOCK_FIELDS} for r in recs]
    assert port.changes >= 2
    assert strip(logs["port"]) == strip(logs["ref"])
    assert port.summary() == ref.summary()
    assert port.params_list() == ref.params_list()


# -- the Trainer under the spike profile --------------------------------------

SPIKE = {"sync": {"mode": "quorum", "adaptive": True,
                  "adaptive_window_steps": 4, "adaptive_cooldown_steps": 4,
                  "straggler_profile": "spike",
                  "straggler_spike_prob": 0.25,
                  "straggler_spike_scale": 8.0},
         "mesh": {"num_replicas": N}}


def _log(path):
    return [json.loads(x) for x in path.read_text().splitlines()]


def _port_cfg(train_dir, **over) -> ExperimentConfig:
    d = {"data": {"dataset": "synthetic", "batch_size": 64,
                  "synthetic_train_size": 1024, "synthetic_test_size": 256,
                  "use_native_pipeline": False},
         "model": {"compute_dtype": "float32"},
         "train": {"max_steps": 14, "log_every_steps": 1,
                   "save_interval_steps": 0, "save_results_period": 0,
                   "train_dir": str(train_dir)}}
    for sec, vals in over.items():
        d[sec] = {**d.get(sec, {}), **vals}
    return ExperimentConfig.from_dict(d)


def test_adaptive_trainer_run_matches_reference(tmp_path):
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    s = Trainer(_port_cfg(port_dir, **SPIKE), device="cpu").run()
    ref_s = RefTrainer(base_config(
        sync=SPIKE["sync"], train={"max_steps": 14, "log_every_steps": 1,
                                   "train_dir": str(ref_dir)})).run()
    assert s["discipline"]["changes"] >= 1
    assert s["discipline"] == ref_s["discipline"]
    log, ref_log = _log(port_dir / "train_log.jsonl"), _log(
        ref_dir / "train_log.jsonl")
    strip = lambda recs: [{k: v for k, v in r.items()
                           if k not in _CLOCK_FIELDS} for r in recs
                          if r.get("event") == "discipline"]
    assert strip(log) and strip(log) == strip(ref_log)
    steps = [r for r in log if r.get("event") == "step"]
    ref_steps = [r for r in ref_log if r.get("event") == "step"]
    assert [r["flags"] for r in steps] == [r["flags"] for r in ref_steps]
    assert [r["discipline"] for r in steps] == \
        [r["discipline"] for r in ref_steps]
    violations, applicable = inv.check_discipline(steps, log)
    assert applicable and violations == []
    # the reference's device-prefetch gauge is absent with the feature,
    # which the port does not have
    assert set(s["timing"]) == set(ref_s["timing"]) - {
        "prefetch_queue_depth"}
    assert s["timing"]["rolling_cdf"] == ref_s["timing"]["rolling_cdf"]


def test_device_skew_costs_the_loaded_replica_its_seat(tmp_path):
    cfg = _port_cfg(tmp_path, sync={"mode": "quorum",
                                    "num_replicas_to_aggregate": 7,
                                    "straggler_profile": "none",
                                    "measure_device_skew": True},
                    mesh={"num_replicas": N},
                    train={"max_steps": 6, "log_every_steps": 6})
    t = Trainer(cfg, device="cpu")
    assert t._device_probe is not None
    a = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (640, 640)).astype(np.float32))
    t.device_work_injection = {3: (lambda x: x @ x @ x, a)}
    flags = t.run()["last_metrics"]["flags"]
    assert flags[3] == 0 and sum(flags) == 7, flags
