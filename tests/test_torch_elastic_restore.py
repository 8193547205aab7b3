"""Canonical checkpoints and the mesh-portable restore of the port
(``parallel/api.py canonical_save_state / pack_restored_state /
restore_for_topology``, ``train/checkpoint.py``'s per-host layout and
``OptimizerStateMismatchError``, ``train/loop.py``'s resume) against the
reference's.

* For one state, the port's single-file checkpoint bytes equal the
  reference's: LAMB's ``{"m", "v"}`` slots, bf16 params (no masters),
  and the canonical (logical-shape) save of a ZeRO-1 and of a
  resident-sharded run's live state. The reference's own digests differ
  across knobs by ulps
  (``tests/test_zero1.py::test_checkpoint_roundtrip_and_cross_knob_restore``
  fails with this JAX), so both savers are fed one state, not two runs.
  Each side restores the other's artifact leaf for leaf.
* On the port, params and slot digests are equal across
  ``shard_weight_update``, ``comm_buckets`` and ``resident_sharded``.
* A save at 8 replicas resumes at 4, and one from 2 gloo processes
  resumes in 1: ``cross_world_restore`` is journaled naming both worlds,
  the slots come back as saved, the cursor where it was, and the next
  step matches the reference's ``restore_for_topology`` run on the same
  files (loss ``rtol 1e-5``, each param leaf within 1e-4 of its norm:
  one free step of each package).
* The per-host layout of 2 gloo processes is read back whole by the
  port, and the reference's ``_restore_sharded`` reads the same files
  to the same logical arrays.
* A checkpoint of another optimizer-state kind raises
  ``OptimizerStateMismatchError`` before any state is read.
"""

import json
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from conftest import base_config
from distributedmnist_tpu.models.registry import get_model as ref_get_model
from distributedmnist_tpu.parallel import api as ref_api
from distributedmnist_tpu.train import checkpoint as ref_ckpt
from distributedmnist_tpu.train.loop import Trainer as RefTrainer
from distributedmnist_tpu_torch.core.config import ExperimentConfig
from distributedmnist_tpu_torch.core.mesh import make_topology
from distributedmnist_tpu_torch.models.convert import (list_form,
                                                       state_from_reference,
                                                       state_to_reference)
from distributedmnist_tpu_torch.models.registry import get_model
from distributedmnist_tpu_torch.parallel import api
from distributedmnist_tpu_torch.parallel.api import tree_leaves
from distributedmnist_tpu_torch.train import checkpoint as ckpt
from distributedmnist_tpu_torch.train.loop import Trainer

from _torch_dp import batches, cfg_dict, leaves_np, ref_steps, within_norm
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_distributed import _launch

LAMB = {"name": "lamb", "weight_decay": 1e-3}
ZERO = {"shard_weight_update": True, "comm_buckets": 3}
RESIDENT = {"shard_weight_update": True, "comm_buckets": 4,
            "resident_sharded": True}
EXTRA = {"config": {"name": "fixed"}, "world": {"num_replicas": 8}}


def _ref_state(topo8, d: dict, steps: int = 1):
    """A reference run's state after ``steps``, as host numpy, in the
    canonical layout, with its config."""
    ref, _, rcfg = ref_steps(topo8, d, batches(steps))
    plan = ref_api.zero1_plan_for(ref_get_model(rcfg.model), rcfg, topo8)
    return ref_api.canonical_save_state(ref, plan), rcfg


def _port_live_state(d: dict, canonical):
    """The reference's canonical state as the port's live state for the
    config's plan (repacked: flat slots, flat params when resident)."""
    cfg = ExperimentConfig.from_dict(d)
    topo = make_topology(cfg.mesh)
    plan = api.zero1_plan_for(get_model(cfg.model), cfg, topo)
    saved = {f: getattr(canonical, f) for f in (
        "params", "momentum", "step", "updates_applied", "root_key",
        "window_acc", "window_rounds", "wall_ms", "next_apply_ms")}
    saved = jax.tree.map(lambda x: np.asarray(x), saved)
    bf16 = any(a.dtype == ml_dtypes.bfloat16
               for a in jax.tree.leaves(saved["params"]))
    if bf16:  # numpy has no bfloat16 of its own: through float32, exactly
        saved["params"] = jax.tree.map(lambda a: a.astype(np.float32),
                                       saved["params"])
    state = state_from_reference(api.pack_restored_state(saved, plan, topo),
                                 device="cpu")
    if bf16:
        state.params = api.tree_map(lambda t: t.to(torch.bfloat16),
                                    state.params)
    return state, plan


CASES = {"lamb": ({"optim": LAMB}, None),
         "bf16_params": ({"optim": {"name": "momentum", "momentum": 0.9},
                          "precision": {"param_dtype": "bfloat16"}}, None),
         "lamb_zero1": ({"optim": LAMB, "parallel": ZERO}, "flat slots"),
         "momentum_resident": ({"optim": {"name": "momentum",
                                          "momentum": 0.9},
                                "parallel": RESIDENT}, "flat params")}


@pytest.mark.parametrize("case", list(CASES))
def test_single_file_bytes_equal_reference(topo8, tmp_path, case):
    over, layout = CASES[case]
    d = cfg_dict(**over)
    canonical, _ = _ref_state(topo8, d)
    ref_ckpt.save_checkpoint(tmp_path / "ref", canonical, 1, extra=EXTRA)
    state, plan = _port_live_state(d, canonical)
    if layout == "flat slots":
        assert any(x.dim() == 1 and x.numel() % 8 == 0 for x in
                   tree_leaves(state.momentum["m"]))
        assert plan is not None and not plan.params_sharded
    if layout == "flat params":
        assert plan.params_sharded and all(
            x.dim() == 1 for x, lp in zip(tree_leaves(state.params),
                                          plan.leaves()) if lp.sharded)
    host = state_to_reference(api.canonical_save_state(state, plan))
    ckpt.save_state(tmp_path / "port", host, 1, extra=EXTRA)
    name = "ckpt-00000001.msgpack"
    assert ((tmp_path / "port" / name).read_bytes()
            == (tmp_path / "ref" / name).read_bytes())
    # each side restores the other's
    saved, _, _ = ckpt.restore_state(tmp_path / "ref")
    back = state_from_reference(saved, device="cpu")
    for a, b in zip(leaves_np(back.params) + leaves_np(back.momentum),
                    jax.tree.leaves(canonical.params)
                    + jax.tree.leaves(canonical.momentum)):
        np.testing.assert_array_equal(a, np.asarray(b).astype(a.dtype))
    got, _, _ = ref_ckpt.restore_checkpoint(tmp_path / "port", canonical)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(canonical)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _opt_digest(train_dir) -> str:
    import hashlib
    saved, _, _ = ckpt.restore_state(train_dir)
    h = hashlib.sha256()
    ckpt._digest_tree(saved["momentum"], h)
    return h.hexdigest()


def test_digests_equal_across_knobs(tmp_path):
    digests = {}
    for name, par in {"replicated": {}, "zero1": {"shard_weight_update":
                                                  True},
                      "bucketed": ZERO, "resident": RESIDENT}.items():
        d = cfg_dict(optim={"name": "momentum", "momentum": 0.9},
                     parallel=par, train={"max_steps": 3,
                                          "train_dir": str(tmp_path / name),
                                          "save_interval_steps": 3})
        t = Trainer(ExperimentConfig.from_dict(d), device="cpu")
        s = t.run()
        digests[name] = (ckpt.checkpoint_params_digest(tmp_path / name)[0],
                         _opt_digest(tmp_path / name), s["params_digest"])
    assert len(set(digests.values())) == 1, digests
    assert digests["replicated"][0] == digests["replicated"][2]


def _journal(train_dir) -> list:
    path = Path(train_dir) / "recovery_journal.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()]


def _resume_cfg(train_dir, n: int, steps: int, **over) -> dict:
    return cfg_dict(optim=LAMB, parallel=ZERO, mesh={"num_replicas": n},
                    train={"max_steps": steps, "train_dir": str(train_dir),
                           "save_interval_steps": 2}, **over)


def _reference_continues(train_dir, n: int, steps: int):
    """The reference's Trainer on ``n`` of the 8 devices resumes the same
    directory (``restore_for_topology``) and runs to ``steps``."""
    d = _resume_cfg(train_dir, n, steps)
    d["train"]["save_interval_steps"] = 0
    d["train"]["async_checkpoint"] = False
    t = RefTrainer(base_config(**d))
    recs = []
    t.run(step_callback=lambda s, r: recs.append(r))
    return t, recs


def test_save_at_8_resumes_at_4(tmp_path):
    src = tmp_path / "run"
    Trainer(ExperimentConfig.from_dict(_resume_cfg(src, 8, 2)),
            device="cpu").run()
    saved, _, step = ckpt.restore_state(src)
    # the reference continues from a copy of the same files
    import shutil
    shutil.copytree(src, tmp_path / "ref")
    t = Trainer(ExperimentConfig.from_dict(_resume_cfg(src, 4, 3)),
                device="cpu")
    cross = [r for r in _journal(src)
             if r.get("action") == "cross_world_restore"]
    assert step == 2 and len(cross) == 1
    assert cross[0]["saved_world"]["num_replicas"] == 8
    assert cross[0]["new_world"]["num_replicas"] == 4
    assert t.topo.num_replicas == 4 and t.state.step == 2
    assert t.train_iter.state()["batches"] == 2
    # the slots come back as saved, repacked for 4 replicas
    assert all(x.numel() % 4 == 0 for x in tree_leaves(t.state.momentum)
               if x.dim() == 1)
    slots = leaves_np(api.canonical_save_state(t.state,
                                               t._zero1_plan).momentum)
    want = [np.asarray(x) for x in tree_leaves(
        list_form(saved["momentum"]))]
    for a, b in zip(slots, want):
        np.testing.assert_array_equal(a, b)
    recs = []
    t.run(step_callback=lambda s, r: recs.append(r))
    ref, ref_recs = _reference_continues(tmp_path / "ref", 4, 3)
    np.testing.assert_allclose(recs[-1]["loss"], ref_recs[-1]["loss"],
                               rtol=1e-5)
    within_norm(leaves_np(t.state.params),
                jax.tree.leaves(jax.device_get(ref.state.params)), 1e-4)


@pytest.fixture(scope="module")
def two_process_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("elastic_two")
    d = _resume_cfg(out / "train", 8, 2)
    d["data"]["batch_size"] = 128  # each process reads its shard
    d["sync"] = {"straggler_profile": "none"}
    d["eval"] = {"eval_batch_size": 32}
    ranks = _launch(out, d)
    return out, d, ranks


def test_per_host_layout_is_read_whole(topo8, two_process_run):
    out, d, ranks = two_process_run
    train = out / "train"
    names = sorted(p.name for p in train.glob("ckpt-00000002*"))
    assert names == ["ckpt-00000002.manifest.json",
                     "ckpt-00000002.shard000-of-002.msgpack",
                     "ckpt-00000002.shard000-of-002.msgpack.sha256",
                     "ckpt-00000002.shard001-of-002.msgpack",
                     "ckpt-00000002.shard001-of-002.msgpack.sha256"]
    saved, extra, step = ckpt.restore_state(train)
    assert step == 2 and extra["world"]["process_count"] == 2
    cfg = ExperimentConfig.from_dict(d)
    plan = api.zero1_plan_for(get_model(cfg.model), cfg,
                              make_topology(cfg.mesh))
    port_slots = [np.asarray(x) for x in tree_leaves(
        list_form(saved["momentum"]))]
    # the saved flat slots are the processes' chunks in replica order
    assert [a.shape for a in tree_leaves(list_form(
        saved["momentum"]["m"]))] == [(lp.pad,) for lp in plan.leaves()]
    # the reference reads the same files into its ZeRO-1 template
    rcfg = base_config(**{k: v for k, v in d.items() if k != "mesh"})
    template = ref_api.init_train_state(ref_get_model(rcfg.model), rcfg,
                                        topo8)
    ref_state, ref_extra, _ = ref_ckpt._restore_sharded(train, template, 2)
    assert ref_extra == extra
    rplan = ref_api.zero1_plan_for(ref_get_model(rcfg.model), rcfg, topo8)
    canon = ref_api.canonical_save_state(ref_state, rplan)
    from distributedmnist_tpu_torch.parallel.partition_rules import (
        zero1_unpack)
    logical = [zero1_unpack(list_form(saved["momentum"][k]), plan)
               for k in ("m", "v")]
    for a, b in zip([x for t in logical for x in tree_leaves(t)],
                    jax.tree.leaves(canon.momentum["m"])
                    + jax.tree.leaves(canon.momentum["v"])):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(tree_leaves(list_form(saved["params"])),
                    jax.tree.leaves(canon.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert len(port_slots) == 2 * len(plan.leaves())


def test_two_processes_resume_in_one(tmp_path, two_process_run):
    out, d, ranks = two_process_run
    import shutil
    src = tmp_path / "port"
    shutil.copytree(out / "train", src)
    shutil.copytree(out / "train", tmp_path / "ref")
    d1 = json.loads(json.dumps(d))
    d1["train"].update(train_dir=str(src), max_steps=3)
    t = Trainer(ExperimentConfig.from_dict(d1), device="cpu")
    cross = [r for r in _journal(src)
             if r.get("action") == "cross_world_restore"]
    assert cross and cross[-1]["saved_world"]["process_count"] == 2
    assert cross[-1]["new_world"]["process_count"] == 1
    # the params come back as the two processes left them
    two = np.load(out / "params0.npz")
    for i, a in enumerate(leaves_np(t.logical_params())):
        np.testing.assert_array_equal(a, two[f"arr_{i}"])
    recs = []
    t.run(step_callback=lambda s, r: recs.append(r))
    d2 = json.loads(json.dumps(d1))
    d2["train"].update(train_dir=str(tmp_path / "ref"),
                       save_interval_steps=0, async_checkpoint=False)
    ref = RefTrainer(base_config(**{k: v for k, v in d2.items()
                                    if k != "mesh"}))
    ref_recs = []
    ref.run(step_callback=lambda s, r: ref_recs.append(r))
    np.testing.assert_allclose(recs[-1]["loss"], ref_recs[-1]["loss"],
                               rtol=1e-5)
    within_norm(leaves_np(t.state.params),
                jax.tree.leaves(jax.device_get(ref.state.params)), 1e-4)


@pytest.mark.parametrize("n,parallel", [(8, {}), (1, ZERO)],
                         ids=["replicated", "one_replica"])
def test_per_host_layout_resumes_without_zero1(tmp_path, two_process_run,
                                               n, parallel):
    """The two processes' per-host checkpoint (flat slots padded for 8
    replicas) resumes where no plan shards anything: the slots come back
    in their logical shapes, equal to the saved chunks unpacked."""
    out, d, _ = two_process_run
    import shutil
    shutil.copytree(out / "train", tmp_path / "t")
    d1 = json.loads(json.dumps(d))
    d1["mesh"] = {"num_replicas": n}
    d1["parallel"] = parallel
    d1["train"].update(train_dir=str(tmp_path / "t"), max_steps=3)
    t = Trainer(ExperimentConfig.from_dict(d1), device="cpu")
    assert t._zero1_plan is None and t.state.step == 2
    saved, _, _ = ckpt.restore_state(tmp_path / "t")
    cfg = ExperimentConfig.from_dict(d)
    plan = api.zero1_plan_for(get_model(cfg.model), cfg,
                              make_topology(cfg.mesh))
    from distributedmnist_tpu_torch.parallel.partition_rules import (
        zero1_unpack)
    want = [x for k in ("m", "v") for x in tree_leaves(
        zero1_unpack(list_form(saved["momentum"][k]), plan))]
    got = leaves_np(t.state.momentum)
    assert [a.shape for a in got] == [b.shape for b in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    recs = []
    t.run(step_callback=lambda s, r: recs.append(r))
    assert np.isfinite(recs[-1]["loss"])


def test_optimizer_kind_mismatch_raises_before_any_graft(tmp_path,
                                                         monkeypatch):
    src = tmp_path / "lamb"
    Trainer(ExperimentConfig.from_dict(_resume_cfg(src, 8, 2)),
            device="cpu").run()

    def no_graft(*a, **k):
        raise AssertionError("the state was read")

    monkeypatch.setattr(ckpt, "restore_state", no_graft)
    d = _resume_cfg(src, 8, 3)
    d["optim"] = {"name": "momentum", "momentum": 0.9}
    with pytest.raises(ckpt.OptimizerStateMismatchError,
                       match="'lamb' optimizer state") as e:
        Trainer(ExperimentConfig.from_dict(d), device="cpu")
    assert (e.value.saved_kind, e.value.requested_kind) == ("lamb",
                                                            "momentum")
    d["optim"] = {"name": "lars"}
    with pytest.raises(ckpt.OptimizerStateMismatchError):
        Trainer(ExperimentConfig.from_dict(d), device="cpu")
