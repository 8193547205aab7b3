"""The serving chaos trial of the port (``distributedmnist_tpu_torch/
launch/chaos.py`` with ``payload="serving"``) held to the reference's:
``ChaosConfig`` over the serving, decode and network knobs refuses what
the reference's refuses, with its message, and resolves the rest to the
reference's payloads on the port's verbs (the publisher's pace adapted
to a measured boot, the replicas' commands, the quant sidecar tiers,
the roster size, with ``broker`` its donor trainers, with
``serve_tp_ranks`` > 1 its ``--tp-ranks``); ``_merge_load_summaries``
folds as the
reference's does; the reference's wiring tests
(``tests/test_servesvc.py:563``, ``tests/test_decode.py:614``) on the
port; and (``slow``) the reference's three real trials
(``test_servesvc.py:761``, ``:783``; ``test_decode.py:637``) on the
port's ``launch train`` and ``launch serve`` workers with ``--device
cpu``."""

import dataclasses
import itertools
import json

import pytest

from distributedmnist_tpu.launch import chaos as ref_chaos
from distributedmnist_tpu.launch import cluster as ref_cluster
from distributedmnist_tpu_torch.launch import chaos as pt_chaos
from distributedmnist_tpu_torch.launch.chaos import (ChaosConfig,
                                                     _merge_load_summaries,
                                                     run_campaign)
from distributedmnist_tpu_torch.launch.cluster import ClusterError

BOOTS = (None, 0.0, 3.0, 12.5, 80.0)


def _on_port(cmd: str) -> str:
    return cmd.replace("distributedmnist_tpu.launch",
                       "distributedmnist_tpu_torch.launch")


def _both(**kw):
    """Each package's ChaosConfig of ``kw``, or the ClusterError it
    raises."""
    out = []
    for cls, err in ((ChaosConfig, ClusterError),
                     (ref_chaos.ChaosConfig, ref_cluster.ClusterError)):
        try:
            out.append(cls(**kw))
        except err as e:
            out.append(e)
    return out


def _assert_resolves_alike(got, want):
    assert got.trial_num_workers() == want.trial_num_workers()
    assert got.resolved_quant_publish_tiers() == \
        want.resolved_quant_publish_tiers()
    assert got.resolved_serve_command() == \
        _on_port(want.resolved_serve_command())
    assert got.resolved_worker_commands() == {
        k: _on_port(c) for k, c in want.resolved_worker_commands().items()}
    assert got.resolved_poll_secs() == want.resolved_poll_secs()
    assert got.step_window() == want.step_window()
    for boot in BOOTS:
        assert got.resolved_train_command(boot) == \
            _on_port(want.resolved_train_command(boot))
        assert got.resolved_stall_timeout_s(boot) == \
            want.resolved_stall_timeout_s(boot)


_GRID = list(itertools.product(
    ("train", "shell", "serving"), (False, True), (False, True),
    (None, ("int8",), ("bf16", "fp32"), ("fp32",), ("in8",))))


@pytest.mark.parametrize("payload, decode, network, tiers", _GRID)
def test_config_over_serving_knobs_is_the_reference(payload, decode,
                                                    network, tiers):
    kw = {"payload": payload, "serve_decode": decode, "network": network,
          "serve_precision_tiers": tiers}
    got, want = _both(**kw)
    if isinstance(want, Exception):
        assert isinstance(got, ClusterError), got
        assert str(got) == str(want)
        return
    assert not isinstance(got, Exception), got
    _assert_resolves_alike(got, want)


@pytest.mark.parametrize("kw", [
    {"payload": "serving", "serve_replicas": 3, "until_step": 60,
     "save_interval_steps": 10, "publisher_pace_ms": 400.0},
    {"payload": "serving", "serve_replicas": 1, "serve_queue_depth": 7,
     "serve_precision_tiers": ("int8", "bf16", "int8")},
    {"payload": "serving", "serve_decode": True, "decode_slots": 2,
     "decode_max_new_tokens": 9, "decode_max_prompt_len": 20,
     "until_step": 10},
    {"payload": "serving", "serve_decode": True, "network": True,
     "serve_replicas": 4, "max_faults": 4},
    {"payload": "serving", "train_command": "echo publisher"},
    {"payload": "serving", "disk": True},
    {"payload": "serving", "discipline_controller": True},
    {"payload": "train", "serve_decode": True, "serve_replicas": 5},
])
def test_serving_resolvers_are_the_reference(kw):
    got, want = _both(**kw)
    if isinstance(want, Exception):
        assert str(got) == str(want)
        return
    _assert_resolves_alike(got, want)


@pytest.mark.parametrize("kw", [
    {"broker": True},
    {"broker": True, "payload": "serving"},
    {"broker": True, "payload": "serving", "broker_train_workers": 3,
     "broker_standbys": 1},
])
def test_broker_is_refused_naming_slice_10(kw):
    """Once refused naming slice 10, the port's broker knobs are now
    taken or refused as the reference's ``ChaosConfig`` takes or
    refuses them, with its message, and resolve to the reference's
    roster (donor trainers included)."""
    got, want = _both(**kw)
    if isinstance(want, Exception):
        assert isinstance(got, ClusterError) and str(got) == str(want)
        return
    _assert_resolves_alike(got, want)
    for boot in BOOTS:
        assert got.resolved_worker_commands(boot) == {
            k: _on_port(c)
            for k, c in want.resolved_worker_commands(boot).items()}


@pytest.mark.parametrize("ranks", [2, 4])
def test_tp_ranks_above_one_are_refused_naming_item_9(ranks):
    """Once refused naming Queue A item 9, ``serve_tp_ranks`` > 1 now
    resolves as the reference's does: every serving replica's command
    (decode or not) ends in ``--tp-ranks N`` on the port's verb."""
    for decode in (False, True):
        got, want = _both(payload="serving", serve_tp_ranks=ranks,
                          serve_decode=decode)
        assert not isinstance(got, Exception), got
        _assert_resolves_alike(got, want)
        assert got.resolved_serve_command().endswith(f" --tp-ranks {ranks}")


def test_every_reference_key_parses(tmp_path):
    """A reference config file (every field, the broker's too) loads,
    list-valued fields as the reference's tuples."""
    d = dataclasses.asdict(ref_chaos.ChaosConfig(
        payload="serving", serve_decode=True,
        serve_fault_window=(3, 20), serve_precision_tiers=("fp32",),
        broker_config={"scale_up_p99_ms": 50.0}))
    assert set(d) <= {f.name for f in dataclasses.fields(ChaosConfig)}
    p = tmp_path / "chaos.json"
    p.write_text(json.dumps(d))
    got = ChaosConfig.from_file(p)
    want = ref_chaos.ChaosConfig.from_file(p)
    assert {k: v for k, v in vars(got).items() if k != "device"} \
        == vars(want)
    assert got.serve_fault_window == (3, 20)
    got = ChaosConfig.from_file(p, overrides={"broker": True})
    want = ref_chaos.ChaosConfig.from_file(p, overrides={"broker": True})
    assert {k: v for k, v in vars(got).items() if k != "device"} \
        == vars(want)
    assert got.trial_num_workers() == want.trial_num_workers()


@pytest.mark.parametrize("boot", [None, 1.0, 4.0, 30.0, 200.0])
def test_publisher_pace_is_the_reference_rule(boot):
    cfg = ChaosConfig(payload="serving", until_step=60)
    want = ref_chaos.ChaosConfig(payload="serving", until_step=60)
    pace = cfg.resolved_publisher_pace_ms(boot)
    assert f"train.step_pace_ms={pace} " in cfg.resolved_train_command(boot)
    assert f"train.step_pace_ms={pace} " in \
        want.resolved_train_command(boot)


# ---------------------------------------------------------------------------
# _merge_load_summaries
# ---------------------------------------------------------------------------

def _summary(i, decode=False):
    s = {"issued": 10 + i, "terminal": 9 + i, "dropped": i % 2,
         "responses": 8 + i, "rejected": 1, "errors": 0,
         "by_reason": {"overloaded": 1} if i % 2 else {"deadline": 1},
         "duration_s": 2.5 + i, "model_steps_served": [10 * i, 10 * i + 5],
         "tiers_served": ["fp32"] if i else ["int8"],
         "latency_ms": {"p50": 3.0 + i, "p99": 40.0 - i}}
    if decode:
        s.update(tokens_streamed=100 * i, ttft_ms={"p50": 1.0 * i,
                                                   "p99": 9.0},
                 inter_token_ms={"p50": 0.5, "p99": 2.0 + i})
    return s


@pytest.mark.parametrize("summaries", [
    [], [None], [None, None],
    [_summary(0)], [_summary(0), None, _summary(1), _summary(2)],
    [_summary(1, decode=True), _summary(3, decode=True)],
    [_summary(0, decode=True), None, _summary(2)],
])
def test_merge_load_summaries_is_the_reference(summaries):
    assert _merge_load_summaries(summaries) == \
        ref_chaos._merge_load_summaries(summaries)


# ---------------------------------------------------------------------------
# the reference's wiring tests on the port
# ---------------------------------------------------------------------------

def test_chaos_serving_tier_payload_wiring():
    """serve_precision_tiers pins replica tiers AND arms the publisher
    with the matching quant.publish_tiers; tier-less configs keep the
    plain payloads (``tests/test_servesvc.py:563``)."""
    cfg = ChaosConfig(payload="serving", serve_replicas=2,
                      serve_precision_tiers=("int8",))
    cmds = cfg.resolved_worker_commands()
    assert "--precision-tier int8" in cmds["1"]
    assert "--precision-tier" not in cmds["2"]
    assert all("distributedmnist_tpu_torch.launch serve" in c
               for c in cmds.values())
    assert "quant.publish_tiers=int8" in cfg.resolved_train_command()
    plain = ChaosConfig(payload="serving", serve_replicas=2)
    assert "--precision-tier" not in plain.resolved_worker_commands()["1"]
    assert "quant.publish_tiers" not in plain.resolved_train_command()
    # a typo'd tier fails typed at config build, naming the valid set
    with pytest.raises(ClusterError, match="in8.*valid tiers"):
        ChaosConfig(payload="serving", serve_precision_tiers=("in8",))


def test_chaos_decode_payload_wiring():
    """``tests/test_decode.py:614`` on the port."""
    cfg = ChaosConfig(payload="serving", serve_decode=True,
                      serve_replicas=2)
    cmd = cfg.resolved_train_command()
    assert "model.name=transformer" in cmd
    assert "data.dataset=synthetic_lm" in cmd
    assert cmd.startswith("python -m distributedmnist_tpu_torch.launch train")
    wc = cfg.resolved_worker_commands()
    assert set(wc) == {"1", "2"}
    assert all("--decode" in c for c in wc.values())
    assert all("--max-new-tokens 16" in c for c in wc.values())
    # prompt + generation must fit the compact LM's position table
    assert all("--max-prompt-len 16" in c for c in wc.values())
    with pytest.raises(ClusterError, match="fp32"):
        ChaosConfig(payload="serving", serve_decode=True,
                    serve_precision_tiers=("int8",))


def test_device_reaches_publisher_and_replicas(tmp_path):
    """``device="cpu"`` appends ``--device cpu`` to the publisher's and
    every replica's command, through the trial's cluster config."""
    from distributedmnist_tpu_torch.launch.cluster import LocalClusterConfig
    cfg = ChaosConfig(payload="serving", serve_decode=True, device="cpu",
                      workdir=str(tmp_path))
    lcfg = LocalClusterConfig(
        num_workers=cfg.trial_num_workers(),
        train_command=cfg.resolved_train_command(),
        worker_commands=cfg.resolved_worker_commands(), device=cfg.device)
    cmds = [lcfg.command_for(k) for k in range(cfg.trial_num_workers())]
    assert "launch train" in cmds[0]
    assert all("launch serve" in c for c in cmds[1:])
    assert all(c.endswith("--device cpu") for c in cmds)


def test_serving_trial_signature_and_schedules(tmp_path, monkeypatch):
    """The campaign hands the serving roster to ``_run_trial`` with
    ``serving=True`` and each mode's schedule: serving faults on the
    replicas, or the network schedule with its mandatory reset and
    partition (the generators themselves are held bitwise in
    ``test_torch_chaos.py``)."""
    calls = []

    def fake_trial(self, rel, plan, seed, num_workers,
                   measured_boot_s=None, serving=False):
        calls.append((rel, plan, num_workers, serving))
        (self.cfg.root / rel).mkdir(parents=True, exist_ok=True)
        return {"outcome": "completed", "step": self.cfg.until_step,
                "duration_s": 0.0, "boot_s": 1.0}

    monkeypatch.setattr(pt_chaos.ChaosCampaign, "_run_trial", fake_trial)
    monkeypatch.setattr(pt_chaos, "check_run",
                        lambda *a, **k: {"verdicts": {}, "violations": []})
    for name, kw in (("net", {"serve_decode": True, "network": True}),
                     ("cls", {})):
        calls.clear()
        run_campaign(ChaosConfig(name=name, workdir=str(tmp_path),
                                 payload="serving", trials=2, seed=5,
                                 serve_replicas=2, **kw))
        assert [c[0] for c in calls] == ["reference", "trial000",
                                         "trial001"]
        assert calls[0][2:] == (1, False)
        for t, (_, plan, nw, serving) in enumerate(calls[1:]):
            assert nw == 3 and serving
            if name == "net":
                want = ref_chaos.generate_network_schedule(
                    5, t, [1, 2], max_faults=3, min_faults=2)
            else:
                want = ref_chaos.generate_serving_schedule(
                    5, t, [1, 2], (5, 40), (6, 20), max_faults=3,
                    min_faults=1, stall_ms_range=(2000.0, 8000.0))
            assert plan.to_json_dict() == \
                want.to_fault_plan().to_json_dict()


# ---------------------------------------------------------------------------
# the reference's three real trials, on the port's workers on the CPU
# ---------------------------------------------------------------------------

# _ONE_THREAD: the decode trials' publisher is a transformer. Its CPU
# backward once took index_put_'s threaded, atomic accumulation (the
# embedding lookup's gradient), which is not bitwise run to run, and
# these tests ran the workers on one thread each to get round it; a
# `launch train --device cpu` process now takes torch's deterministic
# kernels itself (launch/__main__.py _deterministic_cpu), so the trials
# run on the machine's default thread count, and the network trial is
# run once more with OMP_NUM_THREADS and MKL_NUM_THREADS unset.

@pytest.mark.slow  # boots a publisher + 2 serving replicas + reference
def test_serving_chaos_trial_end_to_end(tmp_path):
    """Replica kill + corrupt published checkpoint under live load:
    the trial completes with all three serving invariants passing and
    the load generator reporting zero dropped requests
    (``tests/test_servesvc.py:761``)."""
    cfg = ChaosConfig(name="servetrial", workdir=str(tmp_path),
                      payload="serving", trials=1, seed=0,
                      until_step=60, save_interval_steps=10,
                      serve_replicas=2, shrink=False,
                      trial_timeout_s=420.0, device="cpu")
    summary = run_campaign(cfg)
    assert summary["trials"] == 1
    assert summary["all_green"], summary
    inv = summary["invariants"]
    for name in ("serve_outcomes", "serve_digest", "serve_monotone"):
        assert inv[name]["pass"] == 1, (name, inv)
    sv = summary["serving"]
    assert sv["issued"] > 0 and sv["dropped"] == 0, sv
    assert summary["faults"]["fired"] >= 1, summary["faults"]


@pytest.mark.slow  # boots a publisher + 2 decode replicas + proxies
def test_network_chaos_trial_end_to_end(tmp_path):
    """Transport faults (chaos proxies) under live decode load: every
    scheduled net fault fires, the mandatory reset cuts a token stream
    MID-generation, the partition opens under live traffic, zero
    requests are dropped, and invariant 13 holds the exactly-once books
    (``tests/test_servesvc.py:783``)."""
    cfg = ChaosConfig(name="nettrial", workdir=str(tmp_path),
                      payload="serving", trials=1, seed=0,
                      until_step=60, save_interval_steps=10,
                      serve_replicas=2, serve_decode=True, network=True,
                      shrink=False, trial_timeout_s=420.0, device="cpu")
    summary = run_campaign(cfg)
    assert summary["trials"] == 1
    assert summary["all_green"], summary
    inv = summary["invariants"]
    assert inv["net_faults"]["pass"] == 1, inv
    for name in ("serve_outcomes", "serve_digest", "serve_monotone",
                 "decode_swap"):
        assert inv[name]["pass"] == 1, (name, inv)
    sv = summary["serving"]
    assert sv["issued"] > 0 and sv["dropped"] == 0, sv
    assert summary["faults"]["never_fired"] == 0, summary["faults"]
    net = summary["net"]
    assert net["fired"] >= 2, net
    assert net["faults_by_kind"].get("net_reset") == 1, net
    assert net["faults_by_kind"].get("net_partition") == 1, net
    recs = [json.loads(line) for line in
            (tmp_path / "nettrial" / "trial000"
             / "command_journal.jsonl").read_text().splitlines()]
    rst = [r for r in recs if r.get("action") == "net_reset"]
    assert rst and rst[0]["mid_stream"] and rst[0]["bytes_passed"] > 0


@pytest.mark.slow  # boots an LM publisher + 2 decode replicas + reference
def test_decode_chaos_trial_end_to_end(tmp_path):
    """A seeded decode-mode serving trial — replica killed
    mid-generation, published checkpoint torn, live generate load
    throughout — completes with dropped == 0 and every serving
    invariant (decode_swap too) passing (``tests/test_decode.py:637``).
    """
    cfg = ChaosConfig(
        name="decodetrial", workdir=str(tmp_path), payload="serving",
        serve_decode=True, trials=1, seed=0, until_step=60,
        save_interval_steps=10, serve_replicas=2,
        request_deadline_s=10.0, serve_fault_window=(3, 20),
        shrink=False, trial_timeout_s=420.0, device="cpu")
    summary = run_campaign(cfg)
    assert summary["all_green"], summary
    assert summary["faults"]["fired"] > 0, summary["faults"]
    sv = summary["serving"]
    assert sv["issued"] > 0 and sv["dropped"] == 0, sv
    assert sv["tokens_streamed"] > 0
    assert sv["ttft_p99_ms"] is not None
    inv = summary["invariants"]
    assert inv["decode_swap"]["fail"] == 0
    assert (inv["decode_swap"]["pass"]
            + inv["decode_swap"]["skipped"]) == 1


@pytest.mark.slow  # boots a publisher + 2 decode replicas + proxies
def test_network_trial_is_bitwise_on_every_thread(tmp_path, monkeypatch):
    """C13: the decode network trial with ``OMP_NUM_THREADS`` and
    ``MKL_NUM_THREADS`` unset, so the transformer publisher and its
    fault-free reference run each compute on the machine's default
    thread count while the trial's processes share the cores; the
    determinism invariant holds the trial's final params bitwise to the
    reference run's (see _ONE_THREAD)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        monkeypatch.delenv(var, raising=False)
    cfg = ChaosConfig(name="c13", workdir=str(tmp_path), payload="serving",
                      trials=1, seed=0, until_step=60,
                      save_interval_steps=10, serve_replicas=2,
                      serve_decode=True, network=True, shrink=False,
                      trial_timeout_s=420.0, device="cpu")
    summary = run_campaign(cfg)
    assert summary["all_green"], summary
    report = [json.loads(line) for line in
              open(summary["report_path"]).read().splitlines()]
    assert report[0]["verdicts"]["determinism"] == "pass", report[0]
