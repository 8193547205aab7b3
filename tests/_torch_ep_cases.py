"""The cases the expert-parallel parity tests run in gloo worker processes
(``_torch_mp.run_world(..., cases="_torch_ep_cases")``). Each takes a
payload of numpy inputs (the reference's converted params, token
batches, MoE layer weights) and returns numpy results; the tests hold
them against the reference in the pytest process. This module imports
the port only.
"""

import copy

import numpy as np
import torch
import torch.distributed as dist

from distributedmnist_tpu_torch.core.config import ExperimentConfig, MeshConfig
from distributedmnist_tpu_torch.core.mesh import make_topology
from distributedmnist_tpu_torch.ops import collectives
from distributedmnist_tpu_torch.ops.moe import moe_ffn
from distributedmnist_tpu_torch.parallel import api
from distributedmnist_tpu_torch.parallel.partition_rules import (
    spec_leaves, split_dim, tree_path_names)
from distributedmnist_tpu_torch.train import lr_schedule

from _torch_tp_cases import CPU, LR, _np, _process_rows, _state
from _torch_tp_cases import save_initial  # noqa: F401 — a case here too


def coords(topo) -> tuple:
    return (topo.process_index, topo.model_index, topo.seq_index,
            topo.expert_index)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def moe_layer(p: dict) -> dict:
    """One ``moe_ffn`` on this rank's slice: its sequence block of
    ``x``, its experts and model slice of ``w1``/``w2``, the router
    whole; the objective ``Σ out·ct + c·aux / s`` of its block (the
    train step's form), its output block, the aux and the gradients."""
    m, s, e = p["mesh"]
    topo = make_topology(MeshConfig(num_replicas=1, model_parallelism=m,
                                    seq_parallelism=s, expert_parallelism=e))
    i, j, k = topo.model_index, topo.seq_index, topo.expert_index
    w1, w2 = p["w1"], p["w2"]
    el, fl = w1.shape[0] // e, w1.shape[2] // m
    x = topo.seq_block(_t(p["x"])).clone().requires_grad_(True)
    ct = topo.seq_block(_t(p["ct"]))
    router = _t(p["router"]).requires_grad_(True)
    w1 = _t(w1[k * el:(k + 1) * el, :, i * fl:(i + 1) * fl]).requires_grad_()
    w2 = _t(w2[k * el:(k + 1) * el, i * fl:(i + 1) * fl]).requires_grad_()
    dtype = getattr(torch, p.get("dtype", "float32"))
    out, aux = moe_ffn(x.to(dtype), router.to(dtype), w1.to(dtype),
                       w2.to(dtype), num_experts=p["num_experts"],
                       capacity_factor=p["cf"], router_top_k=p["top_k"],
                       num_groups=p["num_groups"],
                       expert_group=topo.expert_group,
                       model_group=topo.model_group,
                       reduce_group=topo.expert_model_group,
                       stats_group=topo.seq_group, stats=topo.comm)
    ((out.float() * ct).sum() + p["c"] * aux / s).backward()
    return {"coords": coords(topo), "out": out.detach().float().numpy(),
            "aux": float(aux), "aux_dtype": str(aux.dtype),
            "grads": {n: t.grad.numpy() for n, t in
                      (("x", x), ("router", router), ("w1", w1),
                       ("w2", w2))}}


def collective_ops(p: dict) -> dict:
    """The expert layer's collectives over the whole world as one
    expert group: ``scatter_sum`` of this rank's block of ``p["x"]``
    and the gradient of ``Σ out·ct``; ``all_reduce_sum`` of this rank's
    row of ``p["v"]`` and the gradient of ``Σ_r c_r·out``;
    the expert layer's two ``all_to_all``s, ``(1, 2)`` and back
    ``(2, 1)``, of this rank's ``p["a"]`` block, and the gradient of
    ``Σ dispatched·ct_a``."""
    g = dist.get_world_size()
    topo = make_topology(MeshConfig(num_replicas=1, expert_parallelism=g))
    grp, r = topo.expert_group, topo.expert_index
    w = p["x"].shape[1] // g
    x = _t(p["x"][:, r * w:(r + 1) * w]).requires_grad_(True)
    out = collectives.scatter_sum(x, 1, r, g, grp, topo.comm)
    (out * _t(p["ct"])).sum().backward()
    v = _t(p["v"][r]).requires_grad_(True)
    red = collectives.all_reduce_sum(v, grp, topo.comm)
    (red * float(p["c"][r])).sum().backward()
    a = _t(p["a"][r]).requires_grad_(True)
    sent = collectives.all_to_all(a, 1, 2, grp, topo.comm)
    back = collectives.all_to_all(sent, 2, 1, grp, topo.comm)
    (sent * _t(p["ct_a"][r])).sum().backward()
    return {"scatter": out.detach().numpy(), "scatter_grad": x.grad.numpy(),
            "reduce": red.detach().numpy(), "reduce_grad": v.grad.numpy(),
            "dispatch": sent.detach().numpy(), "back": back.detach().numpy(),
            "dispatch_grad": a.grad.numpy()}


def _replicated_grads(step, model, topo, state, batch) -> dict:
    """This rank's float32 gradients of the leaves split over neither
    the model nor the expert axis, by path."""
    xs = topo.split_batch(batch["image"])
    ys = topo.split_batch(batch["label"])
    _, _, grads = step._sharded_grads(state.params, xs, ys)
    specs = spec_leaves(api.tp_specs(model, topo, state.params))
    names = tree_path_names(state.params)
    axes = (topo.axis_names[1], topo.axis_names[3])
    return {n: g.numpy().copy() for n, g, sp in zip(names, grads, specs)
            if all(split_dim(sp, a) is None for a in axes)}


def step(p: dict) -> dict:
    """One train step per batch from the converted params: the losses,
    the params gathered whole and (``p["grads"]``, on a sharded mesh)
    the first batch's replicated-leaf gradients."""
    cfg = ExperimentConfig.from_dict(p["cfg"])
    topo = make_topology(cfg.mesh)
    model, state = _state(cfg, topo, p["params"])
    fn = api.build_train_step(model, cfg, lr_schedule.constant(LR), topo)
    out = {"coords": coords(topo)}
    if p.get("grads"):
        out["replicated_grads"] = _replicated_grads(
            fn, model, topo, state, _process_rows(p["batches"][0], topo))
    losses = []
    for b in p["batches"]:
        state, m = fn(state, _process_rows(b, topo))
        losses.append(float(m["loss"]))
    out.update(losses=losses,
               params=_np(api.tp_gather(state.params, model, topo)))
    return out


def trainer(p: dict) -> dict:
    """The Trainer on an expert axis: a fresh run with saves by steps,
    an eval, and a resume to ``resume_steps``."""
    from distributedmnist_tpu_torch.train.loop import Trainer
    d = p["cfg"]
    t = Trainer(ExperimentConfig.from_dict(d), device=CPU)
    summary = t.run()
    out = {"coords": coords(t.topo), "final_step": summary["final_step"],
           "last": summary["last_metrics"],
           "digest": summary["params_digest"], "eval": t.evaluate("test"),
           "is_writer": t.is_writer}
    d2 = copy.deepcopy(d)
    d2["train"].update(resume=True, max_steps=p["resume_steps"])
    t2 = Trainer(ExperimentConfig.from_dict(d2), device=CPU)
    out["resumed_start"] = t2._start_step
    s2 = t2.run()
    out.update(resumed_final=s2["final_step"],
               resumed_digest=s2["params_digest"],
               resumed_params=_np(t2.logical_params()))
    return out


def world_env(p: dict) -> dict:
    """The topology's coordinates and sub-group members on this rank."""
    topo = make_topology(ExperimentConfig.from_dict(p["cfg"]).mesh)
    members = {}
    for name in ("replica_group", "model_group", "seq_group",
                 "expert_group", "expert_model_group"):
        g = getattr(topo, name)
        members[name] = (None if g is None else
                         [dist.get_global_rank(g, r)
                          for r in range(dist.get_world_size(g))])
    return {"coords": coords(topo), "members": members, "rank": topo.rank}
