"""ZeRO-1 over model-parallel replicas in the port's gloo launches (the
jobs the tensor-, sequence-, expert- and pipeline-parallel test files
add to their launches) against the reference's ZeRO-1 step under
``shard_map`` on the conftest's 8-device mesh, and against the port's
own replicated step at the same mesh. The workers run
``_torch_tp_cases.zero1_step``; this module runs the reference side in
the pytest process.

Each mesh runs three jobs of the same momentum config from the same
params on the same batches: ZeRO-1 monolithic, ZeRO-1 with
``comm_buckets=2`` and ``resident_sharded``, and the replicated update.
"""

import copy

import jax
import numpy as np

from conftest import LOSS_TOL, assert_update_parity
from distributedmnist_tpu.core.config import MeshConfig as RefMesh
from distributedmnist_tpu.core.mesh import make_topology as ref_topology
from distributedmnist_tpu.models.registry import get_model as ref_get_model
from distributedmnist_tpu.parallel import api as ref_api
from distributedmnist_tpu.train.lr_schedule import constant as ref_constant

from _torch_dp import within_norm
from _torch_tp_cases import LR

MOMENTUM = {"name": "momentum", "momentum": 0.9}
KNOBS = {"mono": {"shard_weight_update": True},
         "resident": {"shard_weight_update": True, "comm_buckets": 2,
                      "resident_sharded": True},
         "replicated": {"shard_weight_update": False}}
# the ZeRO-1 step against the port's replicated step at the same mesh,
# each leaf's distance over its norm: momentum (its first update is
# lr·g) at every step; LAMB after one step (ROADMAP.md C8: its
# sign-like first update moves whole elements where a reassociated sum
# is near eps)
MOMENTUM_TOL, LAMB_TOL = 3e-7, 1e-5


def with_knob(d: dict, knob: str, optim: dict = MOMENTUM) -> dict:
    d = copy.deepcopy(d)
    d["optim"] = {**d.get("optim", {}), **optim}
    d["parallel"] = dict(KNOBS[knob])
    return d


def zero1_jobs(prefix: str, d: dict, params, batches: list,
               optim: dict = MOMENTUM) -> list:
    """The three jobs of one mesh: ``{prefix}_{knob}`` each."""
    return [(f"{prefix}_{knob}", {"case": "zero1_step",
                                  "cfg": with_knob(d, knob, optim),
                                  "params": params, "batches": batches})
            for knob in KNOBS]


def ref_mesh(d: dict) -> dict:
    m = d["mesh"]
    keys = ("num_replicas", "model_parallelism", "seq_parallelism",
            "expert_parallelism", "pipeline_parallelism",
            "pipeline_microbatches", "pipeline_schedule", "pipeline_chunks")
    return {k: m[k] for k in keys if k in m}


def ref_zero1_steps(cfg, mesh: dict, batches: list):
    """The reference's train step of ``cfg`` (its ZeRO-1 knobs on) on the
    8-device mesh from its own init (the params the port's jobs get),
    its state placed by ``state_partition_specs``: each step's loss and
    its params in their logical layout (``logical_params``)."""
    topo = ref_topology(RefMesh(**mesh))
    model = ref_get_model(cfg.model)
    specs = ref_api.state_partition_specs(model, cfg, topo)
    state = topo.device_put_state(ref_api.init_train_state(model, cfg, topo),
                                  specs)
    plan = ref_api.zero1_plan_for(model, cfg, topo)
    fn = ref_api.build_train_step(model, cfg, topo, ref_constant(LR))
    losses, params = [], []
    for b in batches:
        state, m = fn(state, topo.device_put_batch(b, seq_sharded=True))
        losses.append(float(m["loss"]))
        params.append(jax.device_get(ref_api.logical_params(
            state.params, plan, topo)))
    return losses, params, plan


def _leaves(tree) -> list:
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def check_slots(out: dict) -> None:
    """One rank's slots: a ZeRO-1 leaf's its replicas' chunks, a fallback
    leaf's its model, expert and stage shard."""
    plan, slots, shards = out["plan"], out["slot_numels"], out["shard_numels"]
    want = [out["local"] * chunk if sharded else numel
            for (sharded, chunk), numel in zip(plan, shards)]
    assert slots == want * (len(slots) // len(want)), (slots, want)


def check_zero1(res: list, prefix: str, ref_cfg, mesh: dict, batches: list,
                lamb: bool = False) -> dict:
    """Both ZeRO-1 jobs of one mesh on every rank against the reference's
    ZeRO-1 step of the same knobs (every step's loss at ``LOSS_TOL``, the
    params at ``assert_update_parity``) and against the port's
    replicated job (momentum at every step within ``MOMENTUM_TOL`` of
    each leaf's norm, LAMB after one step within ``LAMB_TOL``). Returns
    the number of leaves each reference plan shards, by knob.
    ``ref_cfg(knob)`` is the reference's config of that job."""
    by = lambda name: [r[name] for r in res]  # noqa: E731
    rep = by(f"{prefix}_replicated")
    shards = {}
    for knob in ("mono", "resident"):
        losses, want, plan = ref_zero1_steps(ref_cfg(knob), mesh, batches)
        shards[knob] = sum(lp.sharded for lp in jax.tree.leaves(
            plan.leaf_plans, is_leaf=lambda x: hasattr(x, "sharded")))
        outs = by(f"{prefix}_{knob}")
        for out, base in zip(outs, rep):
            assert sum(s for s, _ in out["plan"]) == shards[knob]
            np.testing.assert_allclose(out["losses"], losses, **LOSS_TOL)
            for got, w in zip(out["params"], want):
                assert_update_parity(got, w)
            steps = 1 if lamb else len(batches)
            for s in range(steps):
                within_norm(_leaves(out["params"][s]),
                            _leaves(base["params"][s]),
                            LAMB_TOL if lamb else MOMENTUM_TOL)
            check_slots(out)
            assert out["params"][-1].keys() == want[-1].keys()
    return shards
