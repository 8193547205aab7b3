"""``Trainer.precompile`` and the train step's device body over static
buffers (``distributedmnist_tpu_torch/train/loop.py``,
``parallel/api.py TrainStep``), and the decode replica's per-version
decode steps (``servesvc/decode.py DecodeStep``), on the CPU, where
nothing is captured and the same bodies run eagerly.

* The reference's ``test_precompile_first_step_bitwise_equals_cold``:
  one ``compile`` record before the first ``step`` record (valid under
  both packages' schema checkers), ``precompile()`` idempotent, losses
  and the params digest equal with and without it, ``summary
  ["compile"]`` None without it; on the CPU the record says ``source:
  "eager"`` with the reason.
* Replay emulation: a prepared state's stages called with no arguments
  over its static buffers, the host's counters and root key overwritten
  with garbage while they run (a graph replay cannot read them), for 10
  steps in all five sync modes with dropout and drop-connect on — LAMB
  under a staircase lr in ``sync``, momentum under one in ``quorum``
  with the discipline swapped mid-run, a step masked to a no-op in
  ``timeout``, the window firing at least twice in ``interval`` — each
  step loaded in place from the reference's state before it and held to
  the reference's next state at ``tests/test_torch_sync_modes.py``'s
  tolerances (LAMB's params to 1e-5 of each leaf's norm, as
  ``tests/test_torch_optim_trust.py`` holds them: its update is
  sign-like where a summed gradient is within a few eps of zero). With
  ``train.grad_accum_steps`` 2, where the reference's accumulation
  cannot run with this JAX, the emulation is bitwise the eager call.
* A NaN rollback through ``_adopt`` loads the checkpoint into the
  prepared tensors in place and the run ends where the same run without
  precompile does.
* Decode: under ``pin`` with two live versions, every streamed line the
  reference's, greedy and sampled (``tests/test_torch_decode_swap.py``'s
  schedule), each version with its own decode step, dropped with it.
"""

import contextlib
import json

import numpy as np
import pytest
import torch

from distributedmnist_tpu.core.config import ExperimentConfig as RefConfig
from distributedmnist_tpu.obsv.schema import validate_event as ref_validate
from distributedmnist_tpu_torch.core.config import ExperimentConfig
from distributedmnist_tpu_torch.core.mesh import make_topology
from distributedmnist_tpu_torch.models.convert import (params_to_reference,
                                                       state_from_reference)
from distributedmnist_tpu_torch.models.registry import get_model
from distributedmnist_tpu_torch.obsv.schema import validate_event
from distributedmnist_tpu_torch.parallel import api
from distributedmnist_tpu_torch.train.loop import Trainer

from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_decode_swap import _run_both, staged  # noqa: F401
from test_torch_sync_modes import (LOGNORMAL, MOMENTUM, N, _batches,
                                   _cfg_dict, _close,
                                   _forwards_branch_differently, _ref_run,
                                   _schedules)

STEPS = 10
DECAY = {"learning_rate_decay_factor": 0.5, "num_epochs_per_decay": 0.5}
DROP_CONNECT = {"drop_connect": True}
LAMB = {"name": "lamb", "weight_decay": 1e-3, **DECAY}

# name -> (config overrides, {step: (k, timeout_ms, interval_ms)} swaps);
# dropout is on in every case (the CNN's default rate)
CASES = {
    "sync": ({"sync": {"mode": "sync", **DROP_CONNECT}, "optim": LAMB}, {}),
    "quorum": ({"sync": {"mode": "quorum", "num_replicas_to_aggregate": 4,
                         **LOGNORMAL, **DROP_CONNECT},
                "optim": {**MOMENTUM, **DECAY}},
               {5: (2.0, 0.0, 1000.0)}),
    "timeout": ({"sync": {"mode": "timeout", "timeout_ms": 60.0,
                          **LOGNORMAL, **DROP_CONNECT},
                 "optim": MOMENTUM},
                {3: (8.0, 0.0, 1000.0), 4: (8.0, 60.0, 1000.0)}),
    "interval": ({"sync": {"mode": "interval", "interval_ms": 120.0,
                           **LOGNORMAL, **DROP_CONNECT}}, {}),
    "cdf": ({"sync": {"mode": "cdf", **DROP_CONNECT}}, {}),
}


def _tiny_cfg(train_dir, precompile: bool) -> ExperimentConfig:
    """The reference test's config: the CNN on synthetic data, float32,
    2 replicas, 2 steps, a record a step."""
    return ExperimentConfig.from_dict({
        "data": {"dataset": "synthetic", "batch_size": 32,
                 "synthetic_train_size": 256, "synthetic_test_size": 64,
                 "use_native_pipeline": False},
        "model": {"compute_dtype": "float32"},
        "mesh": {"num_replicas": 2},
        "compile": {"precompile": precompile},
        "train": {"max_steps": 2, "train_dir": str(train_dir),
                  "log_every_steps": 1, "save_interval_steps": 0,
                  "save_results_period": 0, "async_checkpoint": False,
                  "summary_every_steps": 0}})


def _log(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_precompile_first_step_bitwise_equals_cold(tmp_path):
    t_pre = Trainer(_tiny_cfg(tmp_path / "pre", True), device="cpu")
    info = t_pre.precompile()
    assert info["compile_s"] is not None and info["source"] == "eager"
    assert info["reason"].startswith("cpu") and info["serialized"] is False
    assert t_pre.precompile() is info  # idempotent per Trainer
    s_pre = t_pre.run()
    t_cold = Trainer(_tiny_cfg(tmp_path / "cold", False), device="cpu")
    s_cold = t_cold.run()
    pre, cold = _log(tmp_path / "pre" / "train_log.jsonl"), _log(
        tmp_path / "cold" / "train_log.jsonl")
    assert [r["loss"] for r in pre if r["event"] == "step"] == \
           [r["loss"] for r in cold if r["event"] == "step"]
    assert s_pre["params_digest"] == s_cold["params_digest"]
    compile_events = [r for r in pre if r["event"] == "compile"]
    assert len(compile_events) == 1 and pre[0]["event"] == "compile"
    assert compile_events[0]["compile_s"] == info["compile_s"]
    assert validate_event(compile_events[0], source="train_log.jsonl") == []
    assert ref_validate(compile_events[0], source="train_log.jsonl") == []
    assert s_pre["compile"] == info
    assert s_cold["compile"] is None
    assert not [r for r in cold if r["event"] == "compile"]


@contextlib.contextmanager
def _host_state_poisoned(state):
    """Garbage in the state's host fields while the device body runs: a
    replayed graph never reads them, so neither may the body."""
    saved = (state.step, state.updates_applied, state.root_key,
             state.window_rounds, state.wall_ms, state.next_apply_ms)
    state.step = state.updates_applied = -10 ** 6
    state.root_key = np.array([0xDEAD, 0xBEEF], np.uint32)
    state.window_rounds = state.wall_ms = state.next_apply_ms = -1.0
    try:
        yield
    finally:
        (state.step, state.updates_applied, state.root_key,
         state.window_rounds, state.wall_ms, state.next_apply_ms) = saved


def _emulated_step(step_fn, state, batch, disc=None):
    """One step as the card runs a captured one: the host part, one
    staging of the buffers, the stages over them."""
    hs = step_fn.host_part(state, None, disc)
    step_fn.stage(state, batch, hs)
    with _host_state_poisoned(state):
        loss, acc = step_fn.replay(hs.update)
    step_fn.commit(state, hs)
    return hs, loss


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_replay_emulation_matches_reference(topo8, name, monkeypatch):
    import test_torch_sync_modes as sm
    over, swaps = CASES[name]
    monkeypatch.setitem(sm.CASES, name, (over, swaps))
    init, traj = _ref_run(topo8, name)
    pcfg = ExperimentConfig.from_dict(_cfg_dict(over))
    rcfg = RefConfig.from_dict(_cfg_dict(over))
    _, sched = _schedules(rcfg, pcfg)
    step_fn = api.build_train_step(get_model(pcfg.model), pcfg, sched,
                                   make_topology(pcfg.mesh))
    feed = _batches()
    state = state_from_reference(init, device="cpu")
    info = step_fn.prepare(state, _torch_batch(feed[0]))
    assert info["source"] == "eager" and not step_fn.captured
    lamb = pcfg.optim.name == "lamb"
    disc = None
    fires = masked = ties = 0
    prev = init
    for i, (b, want) in enumerate(zip(feed, traj)):
        if i in swaps:
            disc = api.make_discipline_vector(*swaps[i])
        api.load_state_into(state, state_from_reference(prev, device="cpu"))
        tie = _forwards_branch_differently(prev.params, b["image"])
        ties += tie
        before = [p.clone() for p in api.tree_leaves(state.params)]
        hs, loss = _emulated_step(step_fn, state, _torch_batch(b), disc)
        prev = want["state"]
        np.testing.assert_array_equal(hs.flags.numpy(), want["flags"])
        assert (hs.applied, hs.lr, float(hs.num)) == (
            want["applied"], want["lr"], want["num_contributors"])
        assert state.updates_applied == want["updates_applied"]
        assert state.step == int(prev.step) == i + 1
        for f in ("window_rounds", "wall_ms", "next_apply_ms"):
            assert getattr(state, f) == float(getattr(prev, f)), (i, f)
        np.testing.assert_allclose(float(loss), want["loss"], rtol=1e-5)
        got_p = api.tree_leaves(params_to_reference(state.params))
        for g, w in zip(got_p, api.tree_leaves(prev.params)):
            if lamb:
                g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
                assert np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(w)
            else:
                _close(g, w, tie, f"{name} step {i} params")
        for tree, ref_tree in ((state.momentum, prev.momentum),
                               (state.window_acc, prev.window_acc)):
            got = None if tree is None else params_to_reference(tree)
            for g, w in zip(api.tree_leaves(got), api.tree_leaves(ref_tree)):
                _close(g, w, tie, f"{name} step {i} slots")
        if hs.applied == 0 and name != "interval":
            masked += 1
            assert all(torch.equal(a, c) for a, c in
                       zip(api.tree_leaves(state.params), before))
        fires += hs.applied
    assert ties <= 3
    if name == "timeout":
        assert masked >= 1
    if name == "interval":
        assert fires >= 2
    if name in ("sync", "quorum"):
        assert len({t["lr"] for t in traj}) > 1  # the staircase stepped


def test_replay_emulation_with_accumulation_is_the_eager_step():
    """Accumulation 2 × 32 rows, dropout and drop-connect on, LAMB under
    a staircase lr, quorum: 10 emulated replays over one prepared state
    against 10 plain calls from the same start, bitwise."""
    over = {"sync": {"mode": "quorum", "num_replicas_to_aggregate": 5,
                     **LOGNORMAL, **DROP_CONNECT},
            "optim": LAMB, "train": {"grad_accum_steps": 2}}
    d = _cfg_dict(over)
    d["data"]["batch_size"] = 32
    pcfg = ExperimentConfig.from_dict(d)
    model = get_model(pcfg.model)
    topo = make_topology(pcfg.mesh)
    sched = lambda u: float(np.float32(0.01 * 0.5 ** (u // 3)))  # noqa: E731
    feed = [_torch_batch(b) for b in _batches()]
    runs = []
    for emulate in (True, False):
        step_fn = api.build_train_step(model, pcfg, sched, topo)
        state = api.init_train_state(model, pcfg, torch.device("cpu"), topo)
        if emulate:
            step_fn.prepare(state, feed[0])
        losses = []
        for b in feed[:STEPS]:
            if emulate:
                losses.append(float(_emulated_step(step_fn, state, b)[1]))
            else:
                state, m = step_fn(state, b)
                losses.append(float(m["loss"]))
        runs.append((losses, api.tree_leaves(state.params)
                     + api.tree_leaves(state.momentum), state.updates_applied))
    (l1, t1, u1), (l2, t2, u2) = runs
    assert l1 == l2 and u1 == u2 == STEPS
    assert all(torch.equal(a, b) for a, b in zip(t1, t2))


def _poisoning(trainer, at_step):
    step_fn, poisoned = trainer.step_fn, []

    def poisoning_step(state, batch, *args):
        if state.step == at_step and not poisoned:
            poisoned.append(True)
            api.tree_leaves(state.params)[0].fill_(float("nan"))
        return step_fn(state, batch, *args)
    trainer.step_fn = poisoning_step


def test_nan_rollback_loads_into_the_prepared_state(tmp_path):
    summaries = {}
    for precompile in (True, False):
        cfg = _tiny_cfg(tmp_path / str(precompile), precompile)
        cfg = cfg.override({"train.max_steps": 8,
                            "train.save_interval_steps": 2,
                            "train.log_every_steps": 2})
        t = Trainer(cfg, device="cpu")
        live = api.tree_leaves(t.state.params)
        _poisoning(t, 4)
        summaries[precompile] = t.run()
        assert summaries[precompile]["nan_rollbacks"] == 1
        if precompile:
            # the rollback copied into the bound tensors in place
            assert all(a is b for a, b in
                       zip(api.tree_leaves(t.state.params), live))
            assert t._train_step._prepared.state is t.state
    assert summaries[True]["params_digest"] == \
        summaries[False]["params_digest"]
    assert summaries[True]["final_step"] == 8


def test_decode_versions_each_get_a_decode_step(staged, tmp_path):
    both = _run_both(staged, tmp_path, "pin")
    (_, ref_lines, _, _), (rep, lines, _, _) = both["ref"], both["port"]
    assert lines == ref_lines  # greedy a, sampled b and c
    assert rep.version_steps > rep.decode_iterations  # two live at once
    assert len(rep.decode_compiles) == 2
    assert all(i["source"] == "eager" and i["reason"].startswith("cpu")
               for i in rep.decode_compiles)
    assert not rep._versions and rep._params.decode is not None
    assert rep._params.decode.table_key[0] == rep.model_step
