"""The port's resource broker (``distributedmnist_tpu_torch/launch/
broker.py``) held to the reference's, case for case of the reference's
``tests/test_broker.py``: ``decide`` bitwise over a seeded grid of
configs, rosters, signal subsets and cooldown times; ``collect_signals``
and ``tail_heartbeat`` on the same windows, heartbeats and torn tails;
``ResourceBroker`` over a scripted roster (a real ``LocalClusterConfig``
of each package) under one fixed clock, its autoscale journal equal to
the reference's but for ``time`` and passed alike by both packages'
``check_autoscale``; the autoscale invariant and summary; the chaos
campaign's broker knobs, donor roster and diurnal trace.

Two reference faults are fixed in the port, and their tests name the
divergence: C10 (each diurnal leg numbered its requests from 0, so a
later leg repeated ids the replicas' dedup caches had answered) and C11
(``read_latest_window`` read one 64 KiB tail and then answered None)."""

import dataclasses
import json
import os
import random
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from distributedmnist_tpu.core import config as ref_config
from distributedmnist_tpu.launch import broker as ref_broker
from distributedmnist_tpu.launch import chaos as ref_chaos
from distributedmnist_tpu.launch import cluster as ref_cluster
from distributedmnist_tpu.launch import supervisor as ref_supervisor
from distributedmnist_tpu.obsv import invariants as ref_inv
from distributedmnist_tpu.obsv import journal as ref_journal
from distributedmnist_tpu.obsv import schema as ref_schema
from distributedmnist_tpu.servesvc import client as ref_client
from distributedmnist_tpu.servesvc import loadgen as ref_loadgen
from distributedmnist_tpu_torch.core import config as pt_config
from distributedmnist_tpu_torch.launch import broker as pt_broker
from distributedmnist_tpu_torch.launch import chaos as pt_chaos
from distributedmnist_tpu_torch.launch import cluster as pt_cluster
from distributedmnist_tpu_torch.launch import supervisor as pt_supervisor
from distributedmnist_tpu_torch.obsv import invariants as pt_inv
from distributedmnist_tpu_torch.obsv import journal as pt_journal
from distributedmnist_tpu_torch.obsv import schema as pt_schema
from distributedmnist_tpu_torch.servesvc import client as pt_client
from distributedmnist_tpu_torch.servesvc import loadgen as pt_loadgen

PORT = SimpleNamespace(
    name="port", config=pt_config, broker=pt_broker, chaos=pt_chaos,
    cluster=pt_cluster, supervisor=pt_supervisor, inv=pt_inv,
    journal=pt_journal, schema=pt_schema, client=pt_client,
    loadgen=pt_loadgen)
REF = SimpleNamespace(
    name="ref", config=ref_config, broker=ref_broker, chaos=ref_chaos,
    cluster=ref_cluster, supervisor=ref_supervisor, inv=ref_inv,
    journal=ref_journal, schema=ref_schema, client=ref_client,
    loadgen=ref_loadgen)
BOTH = (PORT, REF)

_CFG_KW = dict(cooldown_s=10.0, min_serve_replicas=1, max_serve_replicas=3,
               min_train_workers=1, max_train_workers=4)
_CFG = pt_config.BrokerConfig(**_CFG_KW)
_REF_CFG = ref_config.BrokerConfig(**_CFG_KW)
_SIGNALS = ("p99_ms", "reject_rate", "ttft_p99_ms", "queue_frac",
            "kv_free_frac", "train_steps_per_s")


def _on_port(cmd: str) -> str:
    return cmd.replace("distributedmnist_tpu.launch",
                       "distributedmnist_tpu_torch.launch")


def _bits(x):
    """A value with every float spelled exactly (``float.hex``): two
    decisions compare equal only when they are the same bits."""
    if dataclasses.is_dataclass(x):
        x = dataclasses.astuple(x)
    if isinstance(x, float):
        return ("f", x.hex())
    if isinstance(x, (tuple, list)):
        return tuple(_bits(v) for v in x)
    return (type(x).__name__, x)


def _decide_both(cfg_kw, *args):
    got = pt_broker.decide(pt_config.BrokerConfig(**cfg_kw), *args)
    want = ref_broker.decide(ref_config.BrokerConfig(**cfg_kw), *args)
    return got, want


# ---------------------------------------------------------------------------
# decide(): the pure core, bitwise over a seeded grid
# ---------------------------------------------------------------------------

def _grid_config(rng: random.Random) -> dict:
    kw = {}
    for lo_name, hi_name, scale in (("p99_low_ms", "p99_high_ms", 800.0),
                                    ("reject_low", "reject_high", 0.3),
                                    ("ttft_low_ms", "ttft_high_ms", 800.0),
                                    ("queue_low", "queue_high", 0.9)):
        lo = round(rng.uniform(0, scale / 2), rng.choice((0, 3, 6)))
        kw[lo_name] = lo
        kw[hi_name] = lo + round(rng.uniform(1e-3, scale / 2), 4)
    kv_lo = round(rng.uniform(0, 0.5), 3)
    kw["kv_free_low"] = kv_lo
    kw["kv_free_high"] = min(1.0, kv_lo + round(rng.uniform(1e-3, 0.5), 3))
    kw["cooldown_s"] = rng.choice((0.0, 2.5, 10.0, 15.0))
    kw["min_serve_replicas"] = rng.randint(1, 2)
    kw["max_serve_replicas"] = kw["min_serve_replicas"] + rng.randint(0, 3)
    kw["min_train_workers"] = rng.randint(1, 2)
    kw["max_train_workers"] = kw["min_train_workers"] + rng.randint(0, 4)
    return kw


def _grid_signals(rng: random.Random, cfg_kw: dict) -> dict:
    marks = {"p99_ms": ("p99_low_ms", "p99_high_ms"),
             "reject_rate": ("reject_low", "reject_high"),
             "ttft_p99_ms": ("ttft_low_ms", "ttft_high_ms"),
             "queue_frac": ("queue_low", "queue_high"),
             "kv_free_frac": ("kv_free_low", "kv_free_high")}
    sig = {}
    for name in _SIGNALS:
        if rng.random() < 0.45:
            continue
        if name == "train_steps_per_s":
            sig[name] = rng.choice((0.0, 3.5, 1e9))
            continue
        lo, hi = (cfg_kw[m] for m in marks[name])
        # the marks themselves, either side of each, the dead band, ints
        sig[name] = rng.choice((
            lo, hi, lo - 1e-9, hi + 1e-9, (lo + hi) / 2,
            rng.uniform(0, 2 * hi + 1), int(hi) + 1, 0,
            rng.uniform(lo, hi) * 1.0000001))
    if rng.random() < 0.05:
        sig["p99_ms"] = None  # a non-number is not a signal
    return sig


@pytest.mark.parametrize("seed", range(20))
def test_decide_is_the_reference_bitwise(seed):
    """120 cases a seed, 2,400 in all: every argument of ``decide``
    varied — the marks, cooldown and bounds, both tenants' counts on
    and past the bounds, any subset of the signals (at, beside and
    between the marks), no change yet or one inside or past the
    cooldown."""
    rng = random.Random(f"broker-grid:{seed}")
    decided = 0
    for _ in range(120):
        cfg_kw = _grid_config(rng)
        serve_n = rng.randint(0, cfg_kw["max_serve_replicas"] + 1)
        train_n = rng.randint(0, cfg_kw["max_train_workers"] + 1)
        sig = _grid_signals(rng, cfg_kw)
        now = round(rng.uniform(0, 1000), 3)
        last = rng.choice((None, now, now - cfg_kw["cooldown_s"],
                           now - cfg_kw["cooldown_s"] + 1e-6,
                           now - rng.uniform(0, 30)))
        got, want = _decide_both(cfg_kw, serve_n, train_n, sig, last, now)
        assert _bits(got) == _bits(want), (cfg_kw, serve_n, train_n, sig,
                                           last, now)
        decided += want is not None
    assert decided >= 5  # the grid reaches decisions, not only None


def test_decide_is_deterministic():
    args = (1, 2, {"p99_ms": 900.0, "reject_rate": 0.0}, None, 100.0)
    assert pt_broker.decide(_CFG, *args) == pt_broker.decide(_CFG, *args)
    assert pt_broker.decide(_CFG, *args) == pt_broker.Decision(
        pt_broker.SCALE_UP, "p99_ms", 900.0, _CFG.p99_high_ms, ">=", 1, 2,
        2, 1)
    assert _bits(pt_broker.decide(_CFG, *args)) == \
        _bits(ref_broker.decide(_REF_CFG, *args))


def test_decide_no_signals_no_decision():
    assert pt_broker.decide(_CFG, 2, 2, {}, None, 100.0) is None
    assert ref_broker.decide(_REF_CFG, 2, 2, {}, None, 100.0) is None


def test_decide_dead_band_is_hysteresis():
    mid = (_CFG.p99_low_ms + _CFG.p99_high_ms) / 2
    for mod, cfg in ((pt_broker, _CFG), (ref_broker, _REF_CFG)):
        assert mod.decide(cfg, 2, 2, {"p99_ms": mid}, None, 100.0) is None


def test_decide_cooldown_suppresses_everything():
    hot = {"p99_ms": 2 * _CFG.p99_high_ms}
    assert pt_broker.decide(_CFG, 1, 2, hot, last_change_t=95.0,
                            now=100.0) is None
    got = pt_broker.decide(_CFG, 1, 2, hot, last_change_t=95.0,
                           now=95.0 + _CFG.cooldown_s)
    assert got is not None and got.decision == pt_broker.SCALE_UP
    assert _bits(got) == _bits(ref_broker.decide(
        _REF_CFG, 1, 2, hot, last_change_t=95.0, now=95.0 + 10.0))


def test_decide_scale_up_respects_both_bounds():
    hot = {"reject_rate": 1.0}
    assert pt_broker.decide(_CFG, _CFG.max_serve_replicas, 2, hot, None,
                            0.0) is None
    assert pt_broker.decide(_CFG, 1, _CFG.min_train_workers, hot, None,
                            0.0) is None


def test_decide_scale_down_needs_every_signal_calm():
    calm_but_one = {"p99_ms": _CFG.p99_low_ms,
                    "reject_rate": _CFG.reject_high}
    assert pt_broker.decide(_CFG, 2, 1, calm_but_one, None, 0.0) is None
    calm = {"p99_ms": _CFG.p99_low_ms, "reject_rate": 0.0}
    got = pt_broker.decide(_CFG, 2, 1, calm, None, 0.0)
    assert got is not None and got.decision == pt_broker.SCALE_DOWN
    assert got.new_serve == 1 and got.new_train == 2
    assert pt_broker.decide(_CFG, _CFG.min_serve_replicas, 1, calm, None,
                            0.0) is None
    assert _bits(got) == _bits(ref_broker.decide(_REF_CFG, 2, 1, calm,
                                                 None, 0.0))


def test_decide_kv_pressure_is_inverted():
    got = pt_broker.decide(_CFG, 1, 2, {"kv_free_frac": 0.02}, None, 0.0)
    assert got is not None and got.decision == pt_broker.SCALE_UP
    assert got.trigger == "kv_free_frac" and got.op == "<="


def test_decide_scale_down_caps_train_growth():
    got = pt_broker.decide(_CFG, 2, _CFG.max_train_workers,
                           {"p99_ms": 0.0}, None, 0.0)
    assert got is not None and got.decision == pt_broker.SCALE_DOWN
    assert got.new_train == _CFG.max_train_workers


def test_decide_train_rate_never_triggers():
    assert pt_broker.decide(_CFG, 1, 2, {"train_steps_per_s": 1e9}, None,
                            0.0) is None


@pytest.mark.parametrize("trial", range(20))
def test_decide_property_bounds_and_no_flap(trial):
    """The reference's property (seeded traces replayed through the
    cooldown loop: the roster never leaves its bounds, no two changes
    closer than the cooldown), on the port, with every decision along
    the trace bitwise the reference's."""
    rng = random.Random(1000 + trial)
    serve, train = 1, 3
    last_t = None
    changes = []
    for step in range(200):
        now = step * 1.0
        sig = {}
        if rng.random() < 0.9:
            sig["p99_ms"] = rng.uniform(0, 2 * _CFG.p99_high_ms)
        if rng.random() < 0.5:
            sig["queue_frac"] = rng.random()
        if rng.random() < 0.3:
            sig["kv_free_frac"] = rng.random()
        d = pt_broker.decide(_CFG, serve, train, sig, last_t, now)
        assert _bits(d) == _bits(ref_broker.decide(_REF_CFG, serve, train,
                                                   sig, last_t, now))
        if d is None:
            continue
        assert d.old_serve == serve and d.old_train == train
        serve, train = d.new_serve, d.new_train
        last_t = now
        changes.append(now)
        assert _CFG.min_serve_replicas <= serve <= _CFG.max_serve_replicas
        assert _CFG.min_train_workers <= train <= _CFG.max_train_workers
    assert all(b - a >= _CFG.cooldown_s for a, b in zip(changes,
                                                        changes[1:]))


# ---------------------------------------------------------------------------
# signal collection
# ---------------------------------------------------------------------------

def test_threshold_holds_both_ops():
    for mod in (pt_broker, ref_broker):
        assert mod.threshold_holds(5.0, ">=", 5.0)
        assert not mod.threshold_holds(4.9, ">=", 5.0)
        assert mod.threshold_holds(0.1, "<=", 0.1)
        assert not mod.threshold_holds(0.2, "<=", 0.1)
    assert pt_broker._THRESHOLDS == ref_broker._THRESHOLDS
    assert (pt_broker.SCALE_UP, pt_broker.SCALE_DOWN) == \
        (ref_broker.SCALE_UP, ref_broker.SCALE_DOWN)


def test_collect_signals_folds_window_and_heartbeats():
    window = {"time": 100.0, "p99_ms": 321.0, "reject_rate": 0.25,
              "ttft_p99_ms": 42.0}
    hbs = [{"queue_depth": 2, "queue_limit": 8,
            "kv_blocks_free": 10, "kv_blocks_total": 100},
           {"queue_depth": 7, "queue_limit": 8,
            "kv_blocks_free": 90, "kv_blocks_total": 100}]
    sig = pt_broker.collect_signals(window, hbs, train_steps_per_s=3.5,
                                    now=101.0, window_s=10.0)
    assert sig == {"p99_ms": 321.0, "reject_rate": 0.25,
                   "ttft_p99_ms": 42.0, "queue_frac": 7 / 8,
                   "kv_free_frac": 10 / 100, "train_steps_per_s": 3.5}
    assert _bits(sorted(sig.items())) == _bits(sorted(
        ref_broker.collect_signals(window, hbs, train_steps_per_s=3.5,
                                   now=101.0, window_s=10.0).items()))


def test_collect_signals_drops_stale_window():
    window = {"time": 100.0, "p99_ms": 999.0}
    for mod in (pt_broker, ref_broker):
        assert "p99_ms" not in mod.collect_signals(window, [],
                                                   now=160.0, window_s=10.0)
        # fresh for two windows, or 5 s, whichever is longer
        assert "p99_ms" in mod.collect_signals(window, [], now=105.0,
                                               window_s=1.0)
        assert "p99_ms" not in mod.collect_signals(window, [], now=105.01,
                                                   window_s=1.0)


@pytest.mark.parametrize("seed", range(8))
def test_collect_signals_is_the_reference(seed):
    """Windows with and without a time, fresh and stale, fields missing
    or not numbers; heartbeats with zero or missing limits and pools."""
    rng = random.Random(f"signals:{seed}")
    for _ in range(100):
        now = rng.choice((None, 100.0, rng.uniform(0, 200)))
        window = rng.choice((None, {}, {
            "time": rng.choice((None, "x", rng.uniform(0, 200), 100.0)),
            "p99_ms": rng.choice((None, rng.uniform(0, 900), 12)),
            "reject_rate": rng.choice((None, rng.random())),
            "ttft_p99_ms": rng.choice((None, "slow", rng.uniform(0, 90)))}))
        hbs = []
        for _ in range(rng.randint(0, 4)):
            hb = {}
            for k in ("queue_depth", "queue_limit", "kv_blocks_free",
                      "kv_blocks_total"):
                v = rng.choice((None, 0, rng.randint(1, 64),
                                rng.uniform(0, 64)))
                if v is not None:
                    hb[k] = v
            hbs.append(hb if rng.random() < 0.9 else "torn")
        rate = rng.choice((None, 0.0, rng.uniform(0, 9)))
        window_s = rng.choice((0.5, 3.0, 10.0))
        got = pt_broker.collect_signals(window, hbs, rate, now=now,
                                        window_s=window_s)
        want = ref_broker.collect_signals(window, hbs, rate, now=now,
                                          window_s=window_s)
        assert _bits(sorted(got.items())) == _bits(sorted(want.items()))


_HB = json.dumps({"event": "heartbeat", "step": 3, "queue_depth": 1})
_STEP = json.dumps({"event": "step", "step": 9})


@pytest.mark.parametrize("text, step", [
    (_HB + "\n" + _STEP + "\n" + '{"event": "heartbeat", "step": 4, "q',
     3),
    ("", None),
    ('{"event": "heartbeat", "st\n{"event": "heartbeat"', None),
    (_HB + "\n\n[1, 2]\n" + _STEP, 3),
    (_HB + "\n" + json.dumps({"event": "heartbeat", "step": 5}) + "\n",
     5),
    (_STEP + "\n", None),
])
def test_tail_heartbeat_is_the_reference(tmp_path, text, step):
    """The torn-tail cases of the reference's tests (a torn last line,
    an empty log, every line torn) and more, in both packages."""
    (tmp_path / "train_log.jsonl").write_text(text)
    got = pt_broker.tail_heartbeat(tmp_path)
    assert got == ref_broker.tail_heartbeat(tmp_path)
    assert (got or {}).get("step") == step
    assert pt_broker.tail_heartbeat(tmp_path / "missing") is None


def test_tail_heartbeat_reads_only_its_tail(tmp_path):
    """A heartbeat further back than ``tail_bytes`` is not seen, in
    either package (the heartbeat channel is written every request; the
    C11 widening is the loadgen window's alone)."""
    (tmp_path / "train_log.jsonl").write_text(
        _HB + "\n" + (_STEP + "\n") * 2000)
    assert pt_broker.tail_heartbeat(tmp_path) is None
    assert ref_broker.tail_heartbeat(tmp_path) is None
    assert pt_broker.tail_heartbeat(tmp_path, tail_bytes=1 << 20)["step"] \
        == 3


# ---------------------------------------------------------------------------
# ResourceBroker over a scripted roster, one fixed clock for both packages
# ---------------------------------------------------------------------------

class _Clock:
    """``time`` for a broker module: a fixed clock that moves only when
    told (``sleep`` moves it too)."""

    def __init__(self, now: float = 1_000_000.0):
        self.now = now

    def time(self) -> float:
        return self.now

    def monotonic(self) -> float:
        return self.now

    def sleep(self, s: float) -> None:
        self.now += s


class _FakeRoster:
    """The backend surface the broker drives (the reference test's
    ``_FakeRoster``), over an in-memory roster with a real
    ``LocalClusterConfig`` of the package under test; its reshapes land
    in the supervisor's event stream, so the stream is the journal the
    autoscale invariant replays."""

    def __init__(self, pkg, root, num_workers, worker_commands,
                 standby_command=""):
        self.cfg = pkg.cluster.LocalClusterConfig(
            name="fake", workdir=str(root), num_workers=num_workers,
            train_command="train-payload",
            worker_commands=worker_commands,
            standby_command=standby_command)
        self.ids = list(range(num_workers))
        self.alive = {k: True for k in self.ids}
        self.reshapes, self.restarted, self.stopped = [], [], []
        self.promoted = []
        self.promote_ok = False
        self.journal = None
        for k in self.ids:
            self.cfg.worker_dir(k).mkdir(parents=True, exist_ok=True)

    def workers(self):
        return [{"worker": k, "pid": 1000 + k,
                 "alive": self.alive.get(k, False),
                 "logdir": str(self.cfg.worker_dir(k))} for k in self.ids]

    def status(self):
        return {"state": "running", "workers": self.workers(), "idle": []}

    def stop_all(self, worker="all"):
        self.stopped.append(worker)
        if worker != "all":
            self.alive[int(worker)] = False

    def reconfigure(self, new_num_workers, survivors=None):
        old = list(self.ids)
        keep = sorted(survivors if survivors is not None else old)
        nxt = max(old) + 1
        grown = []
        while len(keep) < new_num_workers:
            grown.append(nxt)
            keep.append(nxt)
            nxt += 1
        self.ids = sorted(keep)
        for k in grown:
            self.alive[k] = True
            self.cfg.worker_dir(k).mkdir(parents=True, exist_ok=True)
        self.cfg = dataclasses.replace(self.cfg, num_workers=new_num_workers)
        rec = {"event": "reconfigure", "layer": "cluster",
               "action": "reshape", "old_world": len(old),
               "new_world": new_num_workers, "old_workers": old,
               "workers": list(self.ids), "grown": grown}
        self.reshapes.append(rec)
        if self.journal is not None:
            self.journal(rec)
        return rec

    def restart_worker(self, k):
        self.restarted.append(k)
        self.alive[k] = True

    def promote_standby(self, k):
        self.promoted.append(k)
        self.alive[k] = self.promote_ok or self.alive.get(k, False)
        return self.promote_ok

    def kill_all(self, worker="all"):
        pass


_SERVE_CMD = "serve-payload"


def _brokered(pkg, root, monkeypatch, num_workers=3, serve_ids=(1,),
              standby="", **cfg_kw):
    clock = _Clock()
    monkeypatch.setattr(pkg.broker, "time", clock)
    backend = _FakeRoster(pkg, root, num_workers,
                          {str(k): _SERVE_CMD for k in serve_ids},
                          standby_command=standby)
    sup = pkg.supervisor.ClusterSupervisor(
        backend, pkg.supervisor.SupervisorConfig(seed=7))
    backend.journal = sup._record
    kw = {"cooldown_s": 0.0, "settle_timeout_s": 5.0, **cfg_kw}
    broker = pkg.broker.ResourceBroker(
        sup, pkg.config.BrokerConfig(**kw), serve_command=_SERVE_CMD,
        loadgen_journal=root / "loadgen.jsonl")
    return backend, sup, broker, clock


def _touch(path, t: float, text: str = "{}") -> None:
    """Write ``path`` and stamp its mtime ``t`` on the fixed clock."""
    path.write_text(text)
    os.utime(path, (t, t))


def _journal(sup) -> list:
    return [{k: v for k, v in r.items() if k != "time"} for r in sup.events]


def _scale_up(pkg, root, monkeypatch):
    backend, sup, broker, clock = _brokered(pkg, root, monkeypatch)
    changed = broker.tick({"workers": backend.workers(),
                           "worker_progress": {0: 5, 2: 5}})
    assert changed is False and backend.reshapes == []
    d = pkg.broker.decide(broker.cfg, 1, 2, {"p99_ms": 900.0}, None,
                          clock.now)
    assert broker.execute(d, [1], [0, 2], clock.now) is True
    assert backend.stopped == ["2"]
    assert backend.reshapes[0]["workers"] == [0, 1, 3]
    assert backend.cfg.worker_commands["3"] == _SERVE_CMD
    assert backend.restarted == [3]
    clock.now += 2.5
    _touch(backend.cfg.worker_dir(3) / "serve.json", clock.now - 0.5)
    assert broker.tick({"workers": backend.workers()}) is False
    complete = [r for r in sup.events if r.get("action") == "complete"][0]
    assert complete["serve"] == 2 and complete["train"] == 1
    assert complete["worker"] == 3 and complete["dropped"] == 2
    assert complete["reaction_s"] == 2.0
    assert broker.fired == 1
    return _journal(sup)


def _scale_down(pkg, root, monkeypatch):
    backend, sup, broker, clock = _brokered(pkg, root, monkeypatch,
                                            serve_ids=(1, 2))
    d = pkg.broker.decide(broker.cfg, 2, 1, {"p99_ms": 0.0}, None,
                          clock.now)
    assert d is not None and d.decision == pkg.broker.SCALE_DOWN
    assert broker.execute(d, [1, 2], [0], clock.now) is True
    assert backend.stopped == ["2"]
    assert "2" not in backend.cfg.worker_commands
    assert backend.cfg.worker_commands.get("1") == _SERVE_CMD
    assert backend.restarted == [3] and "3" not in backend.cfg.worker_commands
    clock.now += 4.0
    _touch(backend.cfg.worker_dir(3) / "train_log.jsonl", clock.now,
           json.dumps({"event": "step", "step": 1}) + "\n")
    broker.tick({"workers": backend.workers()})
    complete = [r for r in sup.events if r.get("action") == "complete"][0]
    assert complete["decision"] == pkg.broker.SCALE_DOWN
    assert complete["serve"] == 1 and complete["train"] == 2
    return _journal(sup)


def _promote(pkg, root, monkeypatch, standby, promoted):
    backend, sup, broker, clock = _brokered(pkg, root, monkeypatch,
                                            standby=standby)
    backend.promote_ok = True
    d = pkg.broker.decide(broker.cfg, 1, 2, {"p99_ms": 900.0}, None,
                          clock.now)
    broker.execute(d, [1], [0, 2], clock.now)
    assert backend.promoted == ([3] if promoted else [])
    assert backend.restarted == ([] if promoted else [3])
    assert backend.cfg.worker_commands["3"] == _SERVE_CMD
    return _journal(sup)


def _settle_timeout(pkg, root, monkeypatch):
    backend, sup, broker, clock = _brokered(pkg, root, monkeypatch)
    # a zero budget (validate refuses it at construction, as in the
    # reference's test)
    broker.cfg = pkg.config.BrokerConfig(cooldown_s=0.0,
                                         settle_timeout_s=0.0)
    d = pkg.broker.decide(broker.cfg, 1, 2, {"p99_ms": 900.0}, None,
                          clock.now)
    broker.execute(d, [1], [0, 2], clock.now)
    clock.now += 0.02  # past the zero settle budget; no serve.json ever
    broker.tick({"workers": backend.workers()})
    assert [r["action"] for r in sup.events
            if r.get("event") == "autoscale"] == ["begin", "error"]
    assert broker.fired == 0
    return _journal(sup)


def _window(root, t: float, **fields) -> None:
    with open(root / "loadgen.jsonl", "a") as f:
        f.write(json.dumps({"event": "load", "action": "window",
                            "time": t, "window_s": 3.0, **fields}) + "\n")


def _cycle(pkg, root, monkeypatch):
    """A full up→down cycle through ``tick`` alone: pressure in the
    loadgen window, the new replica's card, the cooldown, calm, the
    grown trainer's log."""
    backend, sup, broker, clock = _brokered(pkg, root, monkeypatch,
                                            cooldown_s=10.0,
                                            window_s=3.0)
    _window(root, clock.now, p99_ms=900.0, reject_rate=0.0)
    assert broker.tick({"workers": backend.workers(),
                        "worker_progress": {0: 5, 2: 5}}) is True
    clock.now += 1.0
    assert broker.tick({"workers": backend.workers()}) is False  # pending
    _touch(backend.cfg.worker_dir(3) / "serve.json", clock.now)
    clock.now += 1.0
    broker.tick({"workers": backend.workers()})
    clock.now += 5.0
    _window(root, clock.now, p99_ms=10.0, reject_rate=0.0)
    assert broker.tick({"workers": backend.workers()}) is False  # cooldown
    clock.now += 15.0  # the reversal lands past twice the cooldown: no flap
    _window(root, clock.now, p99_ms=10.0, reject_rate=0.0)
    assert broker.tick({"workers": backend.workers()}) is True
    assert backend.stopped == ["2", "3"] and backend.restarted == [3, 4]
    clock.now += 3.0
    _touch(backend.cfg.worker_dir(4) / "train_log.jsonl", clock.now - 1.0)
    broker.tick({"workers": backend.workers()})
    assert broker.fired == 2
    summary = broker.summary()
    assert summary["by_direction"] == {pkg.broker.SCALE_UP: 1,
                                       pkg.broker.SCALE_DOWN: 1}
    assert summary["flaps"] == 0 and summary["fired"] == 2
    return _journal(sup), summary


_SCENARIOS = {
    "scale_up": _scale_up,
    "scale_down": _scale_down,
    "standby_matching_pool": lambda pkg, root, mp: _promote(
        pkg, root, mp, _SERVE_CMD, True),
    "standby_wrong_payload": lambda pkg, root, mp: _promote(
        pkg, root, mp, "other-payload", False),
    "settle_timeout": _settle_timeout,
    "up_down_cycle": lambda pkg, root, mp: _cycle(pkg, root, mp)[0],
}


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_broker_journal_is_the_reference(name, tmp_path, monkeypatch):
    """Each scenario of the reference's executor tests on both packages
    under the same fixed clock: the supervisor's event stream (the
    broker's ``autoscale`` records, the roster's reshapes) equals the
    reference's but for ``time``, every record passes the port's schema,
    and both packages' ``check_autoscale`` give the same verdict on
    both streams — green, except that a settle timeout leaves a reshape
    that no completed change licenses the same way in both."""
    got = _SCENARIOS[name](PORT, tmp_path / "port", monkeypatch)
    want = _SCENARIOS[name](REF, tmp_path / "ref", monkeypatch)
    assert got == want
    for rec in got:
        if rec.get("event") == "autoscale":
            pt_schema.validate_event({**rec, "time": 0.0}, source="test")
    verdicts = []
    for journal in (got, want):
        for inv in (pt_inv, ref_inv):
            v, applicable = inv.check_autoscale({"broker": True}, journal)
            verdicts.append((applicable, sorted(x.detail for x in v)))
    assert all(v == verdicts[0] for v in verdicts), verdicts
    assert verdicts[0][0]


def test_broker_cycle_summary_is_the_reference(tmp_path, monkeypatch):
    _, got = _cycle(PORT, tmp_path / "port", monkeypatch)
    _, want = _cycle(REF, tmp_path / "ref", monkeypatch)
    assert got == want


def test_broker_requires_serve_command(tmp_path):
    for pkg in BOTH:
        backend = _FakeRoster(pkg, tmp_path / pkg.name, 2,
                              {"1": _SERVE_CMD})
        sup = pkg.supervisor.ClusterSupervisor(
            backend, pkg.supervisor.SupervisorConfig())
        with pytest.raises(ValueError):
            pkg.broker.ResourceBroker(sup)


def test_broker_promotes_a_pool_parked_with_the_device(tmp_path,
                                                       monkeypatch):
    """The port's one change to the reference's broker: its cluster
    appends ``--device`` to every port-verb payload it spawns, the
    parked pool's too, so the pool is compared with the slot's payload
    as spawned. A pool on the serving payload promotes on a ``--device
    cpu`` roster; one on the train payload does not."""
    serve = "python -m distributedmnist_tpu_torch.launch serve --decode"
    for standby, promoted in ((serve, True), ("", False)):
        clock = _Clock()
        monkeypatch.setattr(pt_broker, "time", clock)
        root = tmp_path / f"dev{promoted}"
        backend = _FakeRoster(PORT, root, 3, {"1": serve},
                              standby_command=standby)
        backend.cfg = dataclasses.replace(backend.cfg, device="cpu")
        assert backend.cfg.resolved_standby_command().endswith(
            "--device cpu") == promoted
        backend.promote_ok = True
        sup = pt_supervisor.ClusterSupervisor(
            backend, pt_supervisor.SupervisorConfig())
        broker = pt_broker.ResourceBroker(
            sup, pt_config.BrokerConfig(cooldown_s=0.0), serve_command=serve)
        d = pt_broker.decide(broker.cfg, 1, 2, {"p99_ms": 900.0}, None,
                             clock.now)
        broker.execute(d, [1], [0, 2], clock.now)
        assert backend.promoted == ([3] if promoted else [])


def test_broker_start_provisions_the_pool_once(tmp_path, monkeypatch):
    calls = []
    for pkg in BOTH:
        backend, sup, broker, _ = _brokered(pkg, tmp_path / pkg.name,
                                            monkeypatch)
        backend.ensure_standbys = lambda n, pkg=pkg: calls.append(
            (pkg.name, n))
        broker.warm_standbys = 2
        broker.start()
        broker.start()
        broker.tick({"workers": backend.workers()})
    assert calls == [("port", 2), ("ref", 2)]


# ---------------------------------------------------------------------------
# the autoscale replay invariant and the summaries, both packages
# ---------------------------------------------------------------------------

def _begin(decision="scale_up_serving", value=900.0, threshold=500.0,
           op=">=", t=100.0, **kw):
    return {"event": "autoscale", "layer": "broker", "action": "begin",
            "decision": decision, "trigger": "p99_ms", "value": value,
            "threshold": threshold, "op": op, "old_serve": 1,
            "new_serve": 2, "old_train": 2, "new_train": 1,
            "cooldown_s": 10.0, "time": t, **kw}


def _complete(decision="scale_up_serving", t=105.0):
    return {"event": "autoscale", "layer": "broker", "action": "complete",
            "decision": decision, "trigger": "p99_ms", "reaction_s": 2.0,
            "serve": 2, "train": 1, "time": t}


def _reshape(new_world=3, **kw):
    return {"event": "reconfigure", "layer": "cluster",
            "action": "reshape", "old_world": 3, "new_world": new_world,
            **kw}


_JOURNALS = {
    "no_broker": ({}, [_reshape()], None),
    "licensed": ({"broker": True}, [_begin(), _reshape(), _complete()],
                 None),
    "unlicensed": ({"broker": True}, [_reshape()], "unlicensed"),
    "never_crossed": ({"broker": True},
                      [_begin(value=100.0), _reshape(), _complete()],
                      "never crossed"),
    "world_mismatch": ({"broker": True},
                       [_begin(), _reshape(new_world=7), _complete()],
                       "lands on world 7"),
    "dangling": ({"broker": True}, [_begin()], "never closed"),
    "overlapping": ({"broker": True},
                    [_begin(t=100.0),
                     _begin(t=101.0, decision="scale_down_serving")],
                    "overlapping"),
    "supervisor_license": ({"broker": True}, [
        {"event": "reconfigure", "layer": "supervisor", "action": "begin",
         "old_world": 3, "new_world": 2}, _reshape(new_world=2)], None),
}


@pytest.mark.parametrize("name", sorted(_JOURNALS))
def test_check_autoscale_is_the_reference(name):
    outcome, journal, want_detail = _JOURNALS[name]
    got_v, got_app = pt_inv.check_autoscale(outcome, journal)
    ref_v, ref_app = ref_inv.check_autoscale(outcome, journal)
    assert got_app == ref_app == (name != "no_broker")
    assert [(v.invariant, v.detail) for v in got_v] == \
        [(v.invariant, v.detail) for v in ref_v]
    if want_detail is None:
        assert got_v == []
    else:
        assert any(want_detail in v.detail for v in got_v)


@pytest.mark.parametrize("recs", [
    [_begin(t=100.0), _complete(t=102.0),
     _begin(decision="scale_down_serving", value=1.0, threshold=150.0,
            op="<=", t=105.0),
     _complete(decision="scale_down_serving", t=106.0),
     {"event": "autoscale", "action": "error",
      "decision": "scale_up_serving", "error": "boom", "time": 107.0}],
    [_begin(t=100.0), _complete(t=101.0),
     _begin(decision="scale_down_serving", t=150.0)],
    [],
])
def test_summarize_autoscale_is_the_reference(recs):
    got = pt_journal.summarize_autoscale(recs)
    assert got == ref_journal.summarize_autoscale(recs)
    if len(recs) == 5:
        assert got["decisions"] == 2 and got["completed"] == 2
        assert got["errors"] == 1 and got["flaps"] == 1
        assert got["reaction_s"]["max"] == 2.0
    elif recs:
        assert got["flaps"] == 0


def test_merge_load_summaries_sums_counts_takes_worst_tails():
    a = {"issued": 10, "terminal": 10, "dropped": 0, "responses": 9,
         "rejected": 1, "errors": 0, "by_reason": {"rejected:overload": 1},
         "duration_s": 2.0, "model_steps_served": [3],
         "tiers_served": ["fp32"], "latency_ms": {"p50": 5.0, "p99": 20.0}}
    b = {"issued": 20, "terminal": 20, "dropped": 0, "responses": 20,
         "rejected": 0, "errors": 0, "by_reason": {}, "duration_s": 3.0,
         "model_steps_served": [3, 5], "tiers_served": ["fp32"],
         "latency_ms": {"p50": 4.0, "p99": 80.0}}
    got = pt_chaos._merge_load_summaries([a, None, b])
    assert got == ref_chaos._merge_load_summaries([a, None, b])
    assert got["issued"] == 30 and got["latency_ms"]["p99"] == 80.0
    assert got["phases_merged"] == 2
    assert pt_chaos._merge_load_summaries([None, None]) is None


# ---------------------------------------------------------------------------
# config surfaces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"p99_low_ms": 500.0, "p99_high_ms": 100.0},
    {"reject_low": 0.1, "reject_high": 0.1},
    {"kv_free_low": 0.6, "kv_free_high": 0.5},
    {"min_serve_replicas": 3, "max_serve_replicas": 1},
    {"min_serve_replicas": 0},
    {"min_train_workers": 0},
    {},
    {"kv_free_low": 0.0, "kv_free_high": 1.0, "cooldown_s": 0.0},
])
def test_broker_config_validate_is_the_reference(kw):
    errs = []
    for cfg_mod in (pt_config, ref_config):
        try:
            cfg_mod.BrokerConfig(**kw).validate()
            errs.append(None)
        except cfg_mod.ConfigError as e:
            errs.append(str(e))
    assert errs[0] == errs[1]
    assert (errs[0] is None) == (kw in ({}, {"kv_free_low": 0.0,
                                             "kv_free_high": 1.0,
                                             "cooldown_s": 0.0}))


@pytest.mark.parametrize("kw", [
    {"payload": "shell", "broker": True},
    {"payload": "train", "broker": True},
    {"payload": "serving", "broker": True, "broker_train_workers": 1},
    {"payload": "serving", "broker": True,
     "serve_precision_tiers": ("int8",)},
    {"payload": "serving", "broker": True,
     "serve_precision_tiers": ("fp32", "")},
    {"payload": "serving", "broker": True, "network": True,
     "serve_decode": True},
    {"payload": "serving", "broker": True},
])
def test_chaos_config_broker_validation_is_the_reference(kw):
    got = want = None
    try:
        got = pt_chaos.ChaosConfig(**kw)
    except pt_cluster.ClusterError as e:
        got = e
    try:
        want = ref_chaos.ChaosConfig(**kw)
    except ref_cluster.ClusterError as e:
        want = e
    if isinstance(want, Exception):
        assert isinstance(got, pt_cluster.ClusterError)
        assert str(got) == str(want)
    else:
        assert {k: v for k, v in vars(got).items() if k != "device"} \
            == vars(want)


@pytest.mark.parametrize("serve_replicas, train_workers, decode", [
    (1, 2, True), (2, 3, False), (1, 4, True), (3, 2, False)])
@pytest.mark.parametrize("boot", [None, 4.0, 30.0])
def test_chaos_broker_roster_is_the_reference(serve_replicas, train_workers,
                                              decode, boot):
    """Donor trainers after the replicas, on the publisher's payload
    with a 10× step budget; the roster size; plain rosters unchanged."""
    kw = dict(payload="serving", broker=True, serve_replicas=serve_replicas,
              broker_train_workers=train_workers, until_step=24,
              serve_decode=decode)
    got, want = pt_chaos.ChaosConfig(**kw), ref_chaos.ChaosConfig(**kw)
    n = 1 + serve_replicas + train_workers - 1
    assert got.trial_num_workers() == want.trial_num_workers() == n
    cmds = got.resolved_worker_commands(boot)
    assert cmds == {k: _on_port(c) for k, c in
                    want.resolved_worker_commands(boot).items()}
    assert got.resolved_donor_command(boot) == _on_port(
        want.resolved_donor_command(boot))
    serve = got.resolved_serve_command()
    for k in range(1, 1 + serve_replicas):
        assert cmds[str(k)] == serve
    for k in range(1 + serve_replicas, n):
        assert "train.max_steps=240" in cmds[str(k)]
        assert cmds[str(k)] == got.resolved_donor_command(boot)
    plain = pt_chaos.ChaosConfig(payload="serving",
                                 serve_replicas=serve_replicas)
    assert plain.trial_num_workers() == 1 + serve_replicas


# ---------------------------------------------------------------------------
# the diurnal trace; C10 and C11
# ---------------------------------------------------------------------------

class _FakeClient:
    """A decode replica that answers at once: enough for ``run_load``'s
    closed loop, so a trace's legs run as they would."""

    def __init__(self, *args, **kwargs):
        pass

    def meta(self, deadline_s=None):
        return {"decode": True, "vocab_size": 32, "max_prompt_len": 8}

    def generate(self, prompt, request_id=None, deadline_s=None, **kw):
        time.sleep(0.003)
        return {"status": "ok", "model_step": 1, "latency_ms": 3.0,
                "ttft_ms": 1.0, "itl_ms": 0.5, "tokens_streamed": 4,
                "attempts": 1, "endpoint": "fake"}


def _diurnal(pkg, root, monkeypatch, seed, phases):
    """Run the campaign's load thread over a fake replica through a
    short diurnal trace; returns ``load_result`` and the journal."""
    monkeypatch.setattr(pkg.client, "ServeClient", _FakeClient)
    cfg = pkg.chaos.ChaosConfig(
        workdir=str(root), payload="serving", serve_decode=True,
        broker=True, seed=seed, broker_phases=phases,
        broker_phase_secs=0.15, broker_window_s=1.5,
        broker_low_concurrency=1, broker_high_concurrency=3)
    lcfg = pkg.cluster.LocalClusterConfig(name="trial000",
                                          workdir=str(cfg.root))
    lcfg.root.mkdir(parents=True, exist_ok=True)
    result = {}
    thread, stop = pkg.chaos.ChaosCampaign(cfg)._start_loadgen(lcfg, result)
    time.sleep(0.3 * phases + 2.0)  # every leg ends; the last runs on
    stop.set()
    thread.join(timeout=30)
    assert not thread.is_alive()
    recs = [json.loads(line) for line in
            (lcfg.root / "loadgen.jsonl").read_text().splitlines()]
    return result, recs


@pytest.mark.parametrize("seed, phases", [(0, 2), (7, 3)])
def test_diurnal_trace_is_the_reference(seed, phases, tmp_path,
                                        monkeypatch):
    """The legs alternate trough and peak from
    ``random.Random(f"{seed}:{name}:diurnal")`` and end on a trough that
    lasts to the trial's end, as the reference's do; the merged summary
    counts every leg, and ``phases`` lands in the load result."""
    got, _ = _diurnal(PORT, tmp_path / "port", monkeypatch, seed, phases)
    want, _ = _diurnal(REF, tmp_path / "ref", monkeypatch, seed, phases)
    assert got["phases"] == want["phases"]
    rng = random.Random(f"{seed}:trial000:diurnal")
    durs = [round(0.15 * (0.8 + 0.4 * rng.random()), 3)
            for _ in range(phases)]
    assert [p["duration_s"] for p in got["phases"]] == durs + [None]
    assert [p["concurrency"] for p in got["phases"]] == \
        [1 if i % 2 == 0 else 3 for i in range(phases)] + [1]
    s = got["summary"]
    assert s["phases_merged"] == phases + 1
    assert s["issued"] > 0 and s["dropped"] == 0


def test_diurnal_ids_never_repeat_c10(tmp_path, monkeypatch):
    """C10, a reference fault fixed in the port. The reference numbers
    every leg's requests from 0, so its merged journal repeats ids that
    a replica's dedup cache has answered already (a repeat is served
    from the cache, and the serving books count it twice). The port's
    legs number on: no id repeats, every issue has one outcome, and the
    window snapshots the broker reads are journaled."""
    _, got = _diurnal(PORT, tmp_path / "port", monkeypatch, 3, 3)
    _, want = _diurnal(REF, tmp_path / "ref", monkeypatch, 3, 3)
    ref_ids = [r["id"] for r in want if r.get("action") == "issue"]
    assert len(ref_ids) != len(set(ref_ids))  # the reference's fault
    ids = [r["id"] for r in got if r.get("action") == "issue"]
    assert len(ids) == len(set(ids)) and sorted(ids) == list(range(len(ids)))
    assert sorted(r["id"] for r in got if r.get("action") == "outcome") \
        == sorted(ids)
    assert any(r.get("action") == "window" for r in got)


def test_run_load_first_id_defaults_to_zero(tmp_path):
    for first, want0 in ((None, 0), (40, 40)):
        kw = {} if first is None else {"first_id": first}
        path = tmp_path / f"l{first}.jsonl"
        s = pt_loadgen.run_load(_FakeClient(), 5, 2, lambda i: [i],
                                journal_path=path, decode=True, **kw)
        ids = sorted(json.loads(line)["id"]
                     for line in path.read_text().splitlines()
                     if '"issue"' in line)
        assert ids == list(range(want0, want0 + 5)) and s["issued"] == 5


def _loadgen_tail(path, window_t: float, outcome_bytes: int) -> None:
    with open(path, "w") as f:
        f.write(json.dumps({"event": "load", "action": "window",
                            "time": window_t, "p99_ms": 777.0}) + "\n")
        n = 0
        while n < outcome_bytes:
            line = json.dumps({"event": "load", "action": "outcome",
                               "id": n, "time": window_t + 1,
                               "status": "ok", "latency_ms": 5.0}) + "\n"
            f.write(line)
            n += len(line)
        f.write('{"event": "load", "action": "outc')  # torn tail


@pytest.mark.parametrize("outcome_kib", [100, 300])
def test_latest_window_behind_a_long_tail_c11(tmp_path, outcome_kib):
    """C11, a reference fault fixed in the port. With more than 64 KiB
    of outcomes journaled after the newest window, the reference's
    ``read_latest_window`` gives None; the port's reads further back and
    gives the snapshot. Whether that snapshot still counts is
    ``collect_signals``' freshness rule, the same in both: fresh, it is
    a signal; stale, it is dropped."""
    path = tmp_path / "loadgen.jsonl"
    _loadgen_tail(path, 500.0, outcome_kib << 10)
    assert ref_loadgen.read_latest_window(path) is None
    got = pt_loadgen.read_latest_window(path)
    assert got is not None and got["p99_ms"] == 777.0
    fresh = pt_broker.collect_signals(got, [], now=503.0, window_s=3.0)
    assert fresh == {"p99_ms": 777.0}
    assert pt_broker.collect_signals(got, [], now=507.0, window_s=3.0) == {}


def test_latest_window_agrees_where_the_reference_reads(tmp_path):
    """Inside the first tail, and on a journal with no window at all, a
    missing file or an empty one, both packages answer alike."""
    path = tmp_path / "loadgen.jsonl"
    _loadgen_tail(path, 10.0, 4 << 10)
    assert pt_loadgen.read_latest_window(path) == \
        ref_loadgen.read_latest_window(path)
    assert pt_loadgen.read_latest_window(path)["p99_ms"] == 777.0
    path.write_text("".join(
        json.dumps({"event": "load", "action": "issue", "id": i}) + "\n"
        for i in range(5000)))
    assert pt_loadgen.read_latest_window(path) is None
    assert ref_loadgen.read_latest_window(path) is None
    for p in (tmp_path / "missing.jsonl", tmp_path / "empty.jsonl"):
        if p.name == "empty.jsonl":
            p.write_text("")
        assert pt_loadgen.read_latest_window(p) is None
        assert ref_loadgen.read_latest_window(p) is None


def test_broker_reads_signals_through_the_port(tmp_path, monkeypatch):
    """``ResourceBroker.read_signals``: the loadgen window (found behind
    a long tail, C11), each serving slot's newest heartbeat, the train
    rate from two ticks' progress."""
    backend, sup, broker, clock = _brokered(PORT, tmp_path, monkeypatch,
                                            window_s=3.0)
    _loadgen_tail(tmp_path / "loadgen.jsonl", clock.now, 100 << 10)
    (backend.cfg.worker_dir(1) / "train_log.jsonl").write_text(
        json.dumps({"event": "heartbeat", "queue_depth": 3,
                    "queue_limit": 4, "kv_blocks_free": 8,
                    "kv_blocks_total": 64}) + "\n")
    sig = broker.read_signals(backend.workers(), {0: 4, 2: 6}, clock.now)
    assert sig == {"p99_ms": 777.0, "queue_frac": 0.75,
                   "kv_free_frac": 0.125}
    sig = broker.read_signals(backend.workers(), {0: 5, 2: 10},
                              clock.now + 2.0)
    assert sig["train_steps_per_s"] == 2.0


# ---------------------------------------------------------------------------
# the decode replica's KV pressure (C14)
# ---------------------------------------------------------------------------

def _stub_replica(pkg_decode, pkg_kv, num_blocks=9):
    """A decode replica's pressure state alone (no model, no socket):
    its paged cache's allocator, its queue and waiting deque."""
    import collections
    import queue

    rep = pkg_decode.DecodeReplica.__new__(pkg_decode.DecodeReplica)
    rep.cache = SimpleNamespace(allocator=pkg_kv.BlockAllocator(num_blocks))
    rep._queue = queue.Queue()
    rep.scfg = SimpleNamespace(queue_depth=32)
    rep._waiting = collections.deque()
    rep._kv_free_low = None
    return rep


def test_heartbeat_reports_the_pool_low_water_c14():
    """C14, a reference fault fixed in the port. A heartbeat lands after
    the step whose sequences finished freed their blocks; four sequences
    admitted in one pass finish in one step, so the reference's
    heartbeat reads the whole pool free however full it ran (its
    ``kv_free_frac`` misses a full pool, and a broker never sees the
    pressure). The port reports the fewest free blocks since the
    previous heartbeat: 0 of 8 here, then the pool as it stands."""
    from distributedmnist_tpu.servesvc import decode as ref_decode
    from distributedmnist_tpu.servesvc import kv_cache as ref_kv
    from distributedmnist_tpu_torch.servesvc import decode as pt_decode
    from distributedmnist_tpu_torch.servesvc import kv_cache as pt_kv

    rep = _stub_replica(pt_decode, pt_kv)
    ref = _stub_replica(ref_decode, ref_kv)
    for r in (rep, ref):
        alloc = r.cache.allocator
        held = [alloc.alloc(2) for _ in range(4)]  # one admission pass
        if r is rep:
            rep._note_kv_low()
        for blocks in held:  # one decode step finishes all four
            alloc.free(blocks)
    assert ref._pressure_fields()["kv_blocks_free"] == 8
    got = rep._pressure_fields()
    assert got["kv_blocks_free"] == 0 and got["kv_blocks_total"] == 8
    assert rep._pressure_fields()["kv_blocks_free"] == 8  # restarted
    one = rep.cache.allocator.alloc(2)  # a trough: one live sequence
    rep._note_kv_low()
    rep.cache.allocator.free(one)
    assert rep._pressure_fields()["kv_blocks_free"] == 6
    assert set(got) == set(ref._pressure_fields())


# ---------------------------------------------------------------------------
# slow: real processes on the CPU
# ---------------------------------------------------------------------------

# the brokered CPU trial's marks: only the KV pool's can be crossed (see
# test_heartbeat_reports_the_pool_low_water_c14: a trough heartbeat reads
# 6 of 8 blocks free, a peak one 0); latencies, TTFT, reject and queue
# fractions never reach theirs either way
_CPU_MARKS = {"window_s": 3.0, "cooldown_s": 2.0, "kv_free_low": 0.4,
              "kv_free_high": 0.6, "p99_high_ms": 2e6, "p99_low_ms": 1e6,
              "ttft_high_ms": 2e6, "ttft_low_ms": 1e6, "reject_high": 2.0,
              "reject_low": 1.0, "queue_high": 2.0, "queue_low": 1.0,
              "max_serve_replicas": 2, "max_train_workers": 2,
              "settle_timeout_s": 120.0}


def _cpu_publisher(until: int, pace_ms: float, save: int = 10) -> str:
    return (pt_chaos._DECODE_PUBLISHER_PAYLOAD.format(
        max_steps=until, pace=pace_ms, save=save) + " decode.num_blocks=9")


@pytest.mark.slow  # a publisher, a replica, a donor and a serving spare
def test_brokered_decode_trial_end_to_end(tmp_path):
    """``launch cluster chaos --payload serving --serve-decode`` with
    ``broker=true`` on the CPU: a fault-free trial of one decode replica,
    one donor trainer and one parked serving spare under a trough → peak
    → trough trace. All invariants green (``autoscale`` among them),
    nothing dropped, a scale-up licensed by the KV pool and a
    scale-back, the scale-up promoted from the spare."""
    cfg = pt_chaos.ChaosConfig(
        name="brokertrial", workdir=str(tmp_path), payload="serving",
        serve_decode=True, serve_replicas=1, trials=1, seed=0,
        until_step=60, save_interval_steps=10, max_faults=0, min_faults=0,
        shrink=False, broker=True, broker_train_workers=2,
        broker_standbys=1, broker_phases=2, broker_low_concurrency=1,
        broker_high_concurrency=8, broker_phase_secs=10.0,
        broker_window_s=3.0, broker_config=_CPU_MARKS,
        train_command=_cpu_publisher(60, 2500.0), stall_timeout_s=150.0,
        trial_timeout_s=600.0, device="cpu")
    summary = pt_chaos.run_campaign(cfg)
    assert summary["all_green"], summary
    for name in ("autoscale", "serve_outcomes", "serve_digest",
                 "serve_monotone"):
        assert summary["invariants"][name]["pass"] == 1, summary
    assert summary["serving"]["issued"] > 0
    assert summary["serving"]["dropped"] == 0
    trial = tmp_path / "brokertrial" / "trial000"
    recs = [json.loads(line) for line in
            (trial / "command_journal.jsonl").read_text().splitlines()]
    begins = [r for r in recs if r.get("event") == "autoscale"
              and r["action"] == "begin"]
    assert [r["decision"] for r in begins][:1] == [pt_broker.SCALE_UP]
    assert begins[0]["trigger"] == "kv_free_frac"
    assert pt_broker.SCALE_DOWN in [r["decision"] for r in begins]
    up = next(r for r in recs if r.get("event") == "autoscale"
              and r["action"] == "complete")
    assert any(r.get("action") == "promote_standby"
               and r.get("worker") == up["worker"] for r in recs)
    outcome = json.loads((trial / "outcome.json").read_text())
    assert up["worker"] in outcome["serve_workers"]
    ids = [json.loads(line)["id"] for line in
           (trial / "loadgen.jsonl").read_text().splitlines()
           if '"issue"' in line]
    assert len(ids) == len(set(ids))  # C10


def _publish_cpu_checkpoint(root) -> None:
    root.mkdir(parents=True)
    import subprocess
    import sys
    repo = str(Path(__file__).resolve().parent.parent)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    p = subprocess.run(
        [sys.executable, "-m", "distributedmnist_tpu_torch.launch",
         *_cpu_publisher(10, 0.0).split()[3:], "--device", "cpu"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]


@pytest.mark.slow  # a parked `launch serve --decode` promoted into a slot
def test_parked_serving_spare_promoted_into_a_slot(tmp_path):
    """The serving half of the warm-standby protocol: a ``launch serve
    --decode`` spare parked by ``LocalProcessCluster.ensure_standbys``
    is promoted by ``promote_standby`` into a slot whose serving payload
    is registered after the promotion (as the broker does), adopts the
    slot's logdir as its serve_dir, binds there and answers."""
    from distributedmnist_tpu_torch.launch.exec import CommandExecutor
    from distributedmnist_tpu_torch.servesvc import ServeClient
    from distributedmnist_tpu_torch.servesvc.client import (
        discover_endpoints)

    _publish_cpu_checkpoint(tmp_path / "c" / "worker0")
    serve = pt_chaos.ChaosConfig(payload="serving", serve_decode=True
                                 ).resolved_serve_command()
    lcfg = pt_cluster.LocalClusterConfig(
        name="c", workdir=str(tmp_path), num_workers=2,
        train_command="sleep 600", standby_command=serve, device="cpu")
    cluster = pt_cluster.LocalProcessCluster(
        lcfg, CommandExecutor(journal=lcfg.root / "command_journal.jsonl"))
    try:
        cluster.create()
        cluster.ensure_standbys(1)
        deadline = time.time() + 240
        while time.time() < deadline and not any(
                cluster._standby_ready(sb)
                for sb in cluster._read_state().get("standbys", [])):
            time.sleep(0.5)
        ready = json.loads(next(lcfg.root.glob("standby0/*.ready"))
                           .read_text())
        assert ready["warm_s"] == 0.0  # the CPU: no context, no library
        assert cluster.promote_standby(1) is True
        cluster.cfg = dataclasses.replace(cluster.cfg,
                                          worker_commands={"1": serve})
        card = lcfg.worker_dir(1) / "serve.json"
        while time.time() < deadline and not card.exists():
            time.sleep(0.2)
        eps = discover_endpoints(lcfg.root)
        assert [e["worker"] for e in eps] == [1]
        got = ServeClient([(eps[0]["host"], eps[0]["port"])],
                          deadline_s=30.0).generate([3, 7, 1], max_tokens=4)
        assert got["status"] == "ok" and len(got["tokens"]) == 4
        # the process that answers is the promoted spare's (its group)
        assert os.getpgid(json.loads(card.read_text())["pid"]) == \
            cluster._read_state()["workers"][1]["pid"]
    finally:
        cluster.kill_all()


@pytest.mark.slow  # `cluster broker` over a publisher, a replica, a donor
def test_cluster_broker_on_a_local_roster(tmp_path, capsys):
    """``launch cluster broker`` on a small local roster of the shell
    payload (the supervisor tests' resuming loop) with one slot
    registered as serving: a journaled window past the p99 mark trades
    the donor for a replica, and the command prints the run's
    ``autoscale`` summary beside the supervisor's result."""
    serve = ("i=0; echo '{\"port\": 1}' > serve.json; while true; do "
             "i=$((i+1)); echo \"{\\\"event\\\": \\\"heartbeat\\\", "
             "\\\"step\\\": $i}\" >> train_log.jsonl; sleep 0.2; done")
    train = pt_chaos._SHELL_PAYLOAD.format(limit=400)
    cfg_path = tmp_path / "c.json"
    cfg_path.write_text(json.dumps({
        "name": "c", "workdir": str(tmp_path), "num_workers": 3,
        "train_command": train, "worker_commands": {"1": serve}}))
    (tmp_path / "bc.json").write_text(json.dumps(
        {"window_s": 30.0, "cooldown_s": 600.0, "max_serve_replicas": 2,
         "settle_timeout_s": 30.0}))
    journal = tmp_path / "c" / "loadgen.jsonl"
    journal.parent.mkdir(parents=True)
    pt_cluster.main(["create", "--config", str(cfg_path)])
    try:
        def pressure():
            time.sleep(2.0)
            with open(journal, "a") as f:
                f.write(json.dumps({"event": "load", "action": "window",
                                    "time": time.time(),
                                    "p99_ms": 900.0}) + "\n")

        import threading
        threading.Thread(target=pressure, daemon=True).start()
        pt_cluster.main(["broker", "--config", str(cfg_path),
                         "--until-step", "200", "--poll-secs", "0.5",
                         "--serve-command", serve, "--broker-config",
                         str(tmp_path / "bc.json"), "--target-worker",
                         "0"])
    finally:
        pt_cluster.main(["kill-all", "--config", str(cfg_path)])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["step"] >= 200
    auto = got["autoscale"]
    assert auto["by_direction"] == {pt_broker.SCALE_UP: 1}
    assert auto["completed"] == 1 and auto["fired"] == 1
    recs = [json.loads(line) for line in
            (tmp_path / "c" / "command_journal.jsonl").read_text()
            .splitlines()]
    assert [r["action"] for r in recs if r.get("event") == "autoscale"] \
        == ["begin", "complete"]
    v, applicable = pt_inv.check_autoscale({"broker": True}, recs)
    assert applicable and v == []
