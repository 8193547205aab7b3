"""The port's network chaos proxy (``distributedmnist_tpu_torch/launch/
netchaos.py``) held to the reference's (``distributedmnist_tpu/launch/
netchaos.py``): the reference's proxy scenarios (``tests/
test_netchaos.py``) on the port's proxy — latency journaled once, the
one-shot reset cut at exactly ``after_bytes``, a blackholed connection
beside one that flows, a partition armed by the first connection, the
``serve.json`` resolver following a restart; both proxies journaling
equal records for the same scripts and traffic; the seeded jitter
drawing the reference's values; and invariant 13 (``check_net_faults``)
over records the port's proxy journaled, passing a clean retry and
failing a leaked duplicate terminal in both packages' checkers."""

import json
import socket
import time

import pytest

from distributedmnist_tpu.launch import netchaos as ref_netchaos
from distributedmnist_tpu.obsv import invariants as ref_inv
from distributedmnist_tpu_torch.launch import netchaos as pt_netchaos
from distributedmnist_tpu_torch.launch.netchaos import (NET_FAULT_KINDS,
                                                        ChaosProxy,
                                                        NetChaosError,
                                                        start_proxies)
from distributedmnist_tpu_torch.obsv import invariants as pt_inv
from distributedmnist_tpu_torch.obsv import schema

from test_netchaos import EchoUpstream, _exchange, _net_trial

PACKAGES = {"port": pt_netchaos, "reference": ref_netchaos}


def _conforming(records):
    for r in records:
        assert schema.validate_event(r) == [], r


def _run(module, scripts, exchanges, reply=None, worker=1, seed=0):
    """Drive ``exchanges`` (each a zero-argument callable taking the
    proxy port) through one proxy of ``module``; returns the exchanges'
    results and the journal."""
    up = EchoUpstream(reply=reply)
    journal: list[dict] = []
    proxy = module.ChaosProxy(("127.0.0.1", up.port), scripts,
                              worker=worker, journal=journal.append,
                              seed=seed)
    try:
        port = proxy.start()
        got = [ex(port) for ex in exchanges]
    finally:
        proxy.stop()
        up.close()
    return got, journal


def _timeless(records):
    return [{k: v for k, v in r.items() if k != "time"} for r in records]


def test_module_surface_is_the_reference():
    assert NET_FAULT_KINDS == ref_netchaos.NET_FAULT_KINDS
    assert pt_netchaos._TICK_S == ref_netchaos._TICK_S
    assert pt_netchaos._CHUNK == ref_netchaos._CHUNK


@pytest.mark.parametrize("scripts", [[{"kind": "wormhole"}],
                                     [{"delay_ms": 5.0}]])
def test_unknown_script_kind_rejected(scripts):
    with pytest.raises(NetChaosError, match="unknown net fault kind"):
        ChaosProxy(("127.0.0.1", 1), scripts, worker=0)
    with pytest.raises(ref_netchaos.NetChaosError):
        ref_netchaos.ChaosProxy(("127.0.0.1", 1), scripts, worker=0)


def test_passthrough_latency_delays_and_journals_once():
    t0 = []

    def timed(port):
        t0.append(time.monotonic())
        out = _exchange(port)
        return out, time.monotonic() - t0[-1]

    (first, second), journal = _run(
        pt_netchaos, [{"kind": "latency", "delay_ms": 80.0,
                       "jitter_ms": 20.0}], [timed, timed], worker=3,
        seed=7)
    assert first[0] == b"ping\n" and first[1] >= 0.08
    assert second[0] == b"ping\n" and second[1] >= 0.08
    lats = [r for r in journal if r["action"] == "net_latency"]
    assert len(lats) == 1 and lats[0]["worker"] == 3
    assert lats[0]["delay_ms"] == 80.0 and lats[0]["conn"] == 0
    _conforming(journal)


def test_reset_cuts_at_exact_byte_once_then_heals():
    (cut, healed), journal = _run(
        pt_netchaos, [{"kind": "reset", "after_bytes": 100}],
        [_exchange, _exchange], reply=b"x" * 512)
    # mid-stream and byte-exact: some of the response, not all of it
    assert len(cut) == 100
    assert healed == b"x" * 512
    rst = [r for r in journal if r["action"] == "net_reset"]
    assert len(rst) == 1
    assert rst[0]["bytes_passed"] == 100 and rst[0]["mid_stream"]
    _conforming(journal)


def test_blackhole_holds_one_conn_while_sibling_flows():
    def victim_then_sibling(port):
        victim = socket.create_connection(("127.0.0.1", port), timeout=5.0)
        victim.settimeout(0.4)
        victim.sendall(b"ping\n")
        with pytest.raises(TimeoutError):
            victim.recv(4096)
        # a half-open peer must not wedge the proxy: conn 1 flows
        sibling = _exchange(port)
        victim.close()
        return sibling

    (sibling,), journal = _run(
        pt_netchaos, [{"kind": "blackhole", "conn": 0, "hold_s": 1.5}],
        [victim_then_sibling])
    assert sibling == b"ping\n"
    bh = [r for r in journal if r["action"] == "net_blackhole"]
    assert len(bh) == 1 and bh[0]["conn"] == 0 and bh[0]["hold_s"] == 1.5
    _conforming(journal)


def test_partition_arms_on_first_conn_cuts_then_heals():
    up = EchoUpstream()
    journal: list[dict] = []
    proxy = ChaosProxy(("127.0.0.1", up.port),
                       [{"kind": "partition", "start_s": 0.4,
                         "duration_s": 0.6}],
                       worker=1, journal=journal.append)
    try:
        port = proxy.start()
        # idle well past start_s: the window must NOT have opened — its
        # clock arms at the first accepted connection
        time.sleep(0.6)
        t0 = time.monotonic()
        assert _exchange(port) == b"ping\n"
        assert journal == []
        # inside [t0+0.4, t0+1.0): the link is down with an RST
        time.sleep(max(0.0, t0 + 0.7 - time.monotonic()))
        assert _exchange(port) == b""
        part = [r for r in journal if r["action"] == "net_partition"]
        assert len(part) == 1 and part[0]["duration_s"] == 0.6
        assert part[0]["start_s"] == 0.4
        # after the window: healed
        time.sleep(max(0.0, t0 + 1.2 - time.monotonic()))
        assert _exchange(port) == b"ping\n"
        _conforming(journal)
    finally:
        proxy.stop()
        up.close()


def test_serve_json_resolver_follows_restart(tmp_path):
    up = EchoUpstream()
    ep = tmp_path / "serve.json"
    ep.write_text('{"host": "127.0.0.1", "po')  # torn ready-file
    proxy = ChaosProxy(ep, [], worker=1)
    try:
        port = proxy.start()
        # unresolvable upstream: the connection is refused (RST)
        assert _exchange(port) == b""
        # the replica "restarts" onto a new port; re-resolved per conn
        ep.write_text(json.dumps({"host": "127.0.0.1", "port": up.port}))
        assert _exchange(port) == b"ping\n"
    finally:
        proxy.stop()
        up.close()


@pytest.mark.parametrize("scripts, reply", [
    ([{"kind": "latency", "delay_ms": 5.0, "jitter_ms": 3.0},
      {"kind": "bandwidth", "bytes_per_s": 1_000_000},
      {"kind": "reset", "after_bytes": 100}], b"x" * 512),
    ([{"kind": "reset", "after_bytes": 700}], b"y" * 1500),
    ([{"kind": "blackhole", "conn": 1, "hold_s": 0.3}], None),
])
def test_both_proxies_journal_equal_records(scripts, reply):
    """The same scripts and the same three requests, one after another,
    through each package's proxy: equal answers and equal journals but
    for the wall-clock stamps."""
    def short(port):
        return _exchange(port, timeout=0.6)

    runs = {name: _run(m, scripts, [short, short, short], reply=reply,
                       worker=2, seed=11)
            for name, m in PACKAGES.items()}
    assert runs["port"][0] == runs["reference"][0]
    assert _timeless(runs["port"][1]) == _timeless(runs["reference"][1])
    assert runs["port"][1], "no fault fired"
    _conforming(runs["port"][1])


@pytest.mark.parametrize("seed", [0, 7, 7_000_004, 123_456_789])
def test_seeded_jitter_draws_the_reference_values(seed):
    """The jitter stream is ``random.Random(seed)`` in both proxies, and
    ``start_proxies`` seeds worker ``w``'s proxy ``seed * 7_000_003 + w``
    in both."""
    script = [{"kind": "latency", "delay_ms": 10.0, "jitter_ms": 50.0}]
    got = ChaosProxy(("127.0.0.1", 1), script, worker=0, seed=seed)
    want = ref_netchaos.ChaosProxy(("127.0.0.1", 1), script, worker=0,
                                   seed=seed)
    assert ([got._rng.random() for _ in range(64)]
            == [want._rng.random() for _ in range(64)])


def test_start_proxies_seeds_and_routes_like_the_reference(tmp_path):
    plans = {1: [{"kind": "latency", "delay_ms": 1.0, "jitter_ms": 9.0}],
             2: [{"kind": "reset", "after_bytes": 500}]}
    got = start_proxies(tmp_path, plans, seed=3)
    want = ref_netchaos.start_proxies(tmp_path, plans, seed=3)
    try:
        assert sorted(got) == sorted(want) == [1, 2]
        for w in got:
            assert got[w].worker == want[w].worker == w
            assert got[w].scripts == want[w].scripts
            assert got[w]._rng.getstate() == want[w]._rng.getstate()
            assert got[w].bound_port and got[w].bound_port != \
                want[w].bound_port
    finally:
        for p in (*got.values(), *want.values()):
            p.stop()


# ---------------------------------------------------------------------------
# invariant 13 over what the port's proxy journaled
# ---------------------------------------------------------------------------

def _proxied_trial(tmp_path, **doctor):
    """The reference test's handcrafted network trial (id 1 reset
    mid-response, retried, absorbed as a dedup hit), with its command
    journal replaced by what the port's proxy journaled cutting a live
    response of worker 1 at byte 500."""
    (cut, _), journal = _run(pt_netchaos,
                             [{"kind": "reset", "after_bytes": 500}],
                             [_exchange, _exchange], reply=b"z" * 900,
                             worker=1)
    assert len(cut) == 500
    trial, _ = _net_trial(tmp_path, **doctor)
    (trial / "command_journal.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in journal))
    return trial, journal


@pytest.mark.parametrize("doctor, detail", [
    ({}, None),
    ({"leak_terminal": True}, "duplicate terminal"),
    ({"dishonest_dedup": True}, "never computed"),
    ({"double_exec": True}, "unlicensed double execution"),
])
def test_invariant13_over_the_port_proxy_records(tmp_path, doctor, detail):
    trial, journal = _proxied_trial(tmp_path, **doctor)
    assert [r["action"] for r in journal] == ["net_reset"]
    for check in (pt_inv.check_net_faults, ref_inv.check_net_faults):
        violations, applicable = check(trial, {}, journal)
        assert applicable
        if detail is None:
            assert violations == []
        else:
            assert any(detail in v.detail for v in violations), violations
