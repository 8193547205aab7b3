"""The port's ZeRO-1 plan under tensor, sequence, pipeline and expert
parallelism against the reference's, in process: ``parallel/api.py
zero1_plan_for`` (the rule engine's specs for the topology into
``partition_rules.make_zero1_plan``) on a topology of the mesh's shape,
against the reference's ``zero1_plan_for`` on the conftest's 8-device
mesh, leaf by leaf (``sharded``, ``size``, ``pad``, ``chunk``,
``shape``), with ``comm_bucket_assignment`` at 1, 2 and 3 buckets.

A leaf shards over the replicas only when its spec is replicated on
every other axis: under SP every leaf (27 of the 4-layer transformer);
under PP only ``embed``, ``pos`` and ``final_norm`` (the stacked block
leaves keep the stage axis), in the stacked layout of either schedule;
under EP 2 the 13 leaves of the MoE transformer that are not expert
weights, under EP 2 × TP 2 the 9 that no rule splits. The steps
themselves run in the TP, EP and PP test files' launches
(``_torch_zero1_mp``).
"""

import copy

import jax
import pytest

from conftest import base_config
from distributedmnist_tpu.core.config import MeshConfig as RefMesh
from distributedmnist_tpu.core.mesh import make_topology as ref_topology
from distributedmnist_tpu.models.registry import get_model as ref_get_model
from distributedmnist_tpu.parallel import api as ref_api
from distributedmnist_tpu.parallel import partition_rules as ref_pr
from distributedmnist_tpu_torch.core.config import ExperimentConfig
from distributedmnist_tpu_torch.core.mesh import Topology
from distributedmnist_tpu_torch.models.registry import get_model
from distributedmnist_tpu_torch.parallel import api
from distributedmnist_tpu_torch.parallel import partition_rules as pr

DENSE = {"name": "transformer", "compute_dtype": "float32", "seq_len": 16,
         "model_dim": 32, "num_heads": 4, "num_layers": 4, "vocab_size": 37,
         "attention_impl": "dense"}
MOE = {**DENSE, "model_dim": 16, "num_heads": 2, "num_layers": 2,
       "vocab_size": 31, "num_experts": 4, "expert_capacity_factor": 4.0,
       "moe_num_groups": 4}
# name → (model, mesh, leaves the plan shards)
MESHES = {
    "dp2_tp2": (DENSE, {"model_parallelism": 2}, 11),
    "dp2_sp2": (DENSE, {"seq_parallelism": 2}, 27),
    "dp2_pp2_gpipe": (DENSE, {"pipeline_parallelism": 2,
                              "pipeline_microbatches": 2}, 3),
    "dp2_pp2_1f1b": (DENSE, {"pipeline_parallelism": 2,
                             "pipeline_microbatches": 2,
                             "pipeline_schedule": "1f1b",
                             "pipeline_chunks": 2}, 3),
    "dp2_ep2": (MOE, {"expert_parallelism": 2}, 13),
    "dp2_ep2_tp2": (MOE, {"expert_parallelism": 2,
                          "model_parallelism": 2}, 9),
}


def _config(name: str, buckets: int) -> dict:
    model, mesh, _ = MESHES[name]
    return {"data": {"dataset": "synthetic_lm", "batch_size": 8,
                     "use_native_pipeline": False},
            "model": copy.deepcopy(model),
            "mesh": {"num_replicas": 2, **mesh},
            "parallel": {"shard_weight_update": True,
                         "comm_buckets": buckets}}


def _rows(plan, ref: bool) -> list:
    lps = (jax.tree.leaves(plan.leaf_plans,
                           is_leaf=lambda x: isinstance(x, ref_pr.LeafShardPlan))
           if ref else plan.leaves())
    return [(lp.sharded, lp.size, lp.pad, lp.chunk, tuple(lp.shape))
            for lp in lps]


def _port_plan(d: dict):
    cfg = ExperimentConfig.from_dict(d)
    mesh = cfg.mesh
    topo = Topology(num_replicas=2, process_count=2, distributed=True,
                    model_parallelism=mesh.model_parallelism,
                    seq_parallelism=mesh.seq_parallelism,
                    pipeline_parallelism=mesh.pipeline_parallelism,
                    expert_parallelism=mesh.expert_parallelism)
    return api.zero1_plan_for(get_model(cfg.model), cfg, topo)


def _ref_plan(d: dict):
    cfg = base_config(**copy.deepcopy(d))
    topo = ref_topology(RefMesh(**d["mesh"]))
    return ref_api.zero1_plan_for(ref_get_model(cfg.model), cfg, topo)


@pytest.mark.parametrize("buckets", [1, 2, 3])
@pytest.mark.parametrize("name", list(MESHES))
def test_plan_and_buckets_match_the_reference(name, buckets):
    d = _config(name, buckets)
    got, want = _port_plan(d), _ref_plan(d)
    assert _rows(got, False) == _rows(want, True)
    assert pr.comm_bucket_assignment(got) == \
        ref_pr.comm_bucket_assignment(want)
    assert sum(s for s, *_ in _rows(got, False)) == MESHES[name][2]
    assert (got.n, got.comm_buckets) == (want.n, want.comm_buckets)


def test_plan_without_specs_is_the_data_parallel_plan():
    """``make_zero1_plan`` with no specs shards every leaf large enough,
    as with every spec replicated; a split spec keeps its leaf out."""
    import numpy as np
    tree = {"a": np.zeros((4, 3)), "b": [np.zeros(5)], "c": np.zeros(1)}
    none = pr.make_zero1_plan(tree, None, 2)
    rep = pr.make_zero1_plan(tree, {"a": (), "b": [(None,)], "c": ()}, 2)
    split = pr.make_zero1_plan(tree, {"a": (None, "model"), "b": [(None,)],
                                      "c": ()}, 2)
    assert _rows(none, False) == _rows(rep, False)
    assert [lp.sharded for lp in none.leaves()] == [True, True, False]
    assert [lp.sharded for lp in split.leaves()] == [False, True, False]
    assert pr.spec_is_replicated((None, None))
    assert not pr.spec_is_replicated((None, ("expert", "model")))
