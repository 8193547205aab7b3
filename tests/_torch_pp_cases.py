"""The cases the pipeline-parallel parity tests run in gloo worker processes
(``_torch_mp.run_world(..., cases="_torch_pp_cases")``). Each takes a
payload of numpy inputs (the reference's params in its per-layer
layout, token batches) and returns numpy results; the tests hold them
against the reference in the pytest process. This module imports the
port only.
"""

import copy
import dataclasses

import torch
import torch.distributed as dist

from distributedmnist_tpu_torch.core.config import (ConfigError,
                                                    ExperimentConfig,
                                                    MeshConfig)
from distributedmnist_tpu_torch.core.mesh import make_topology
from distributedmnist_tpu_torch.models import transformer
from distributedmnist_tpu_torch.models.convert import params_from_reference
from distributedmnist_tpu_torch.models.registry import get_model
from distributedmnist_tpu_torch.ops.pipeline import (make_1f1b_schedule,
                                                     make_gpipe_schedule,
                                                     run_schedule)
from distributedmnist_tpu_torch.parallel import api
from distributedmnist_tpu_torch.train import lr_schedule

from _torch_tp_cases import CPU, LR, _np, _process_rows
from _torch_tp_cases import zero1_step  # noqa: F401 — a case here too


def coords(topo) -> tuple:
    return (topo.process_index, topo.model_index, topo.seq_index,
            topo.stage_index, topo.expert_index)


def stacked(params: dict, mesh: dict) -> dict:
    """The reference's per-layer params in the stacked layout the mesh
    trains: GPipe's layer order, or 1F1B's chunk-interleaved one."""
    if mesh.get("pipeline_schedule") == "1f1b":
        return transformer.stack_block_params_chunked(
            params, mesh["pipeline_parallelism"],
            mesh.get("pipeline_chunks", 1))
    return transformer.stack_block_params(params)


def _state(cfg, topo, params):
    model = get_model(cfg.model)
    state = api.init_train_state(model, cfg, CPU, topo)
    full = params_from_reference(stacked(
        copy.deepcopy(params), dataclasses.asdict(cfg.mesh)), device=CPU)
    state.params = api.tp_shard(full, model, topo)
    return model, state


def identity(p: dict) -> dict:
    """A pipeline of elementwise chunks over the whole world as one stage
    group (≙ ``test_pipeline_parallel.py:27-41``): GPipe's forward, the
    chunked ring's at ``v`` chunks a stage, and GPipe's and 1F1B's
    training schedules on a chunk ``x·w + 1`` with a loss ``Σ y·ct``:
    the outputs, and the input and ``w`` gradients."""
    S = dist.get_world_size()
    topo = make_topology(MeshConfig(num_replicas=1, pipeline_parallelism=S))
    me, micro = topo.stage_index, torch.from_numpy(p["micro"])
    M, v = micro.shape[0], p["chunks"]
    out = {}
    for name, tables, chunks in (
            ("gpipe", make_gpipe_schedule(S, M, True), 1),
            ("chunked", make_1f1b_schedule(S, v, M, True), v)):
        res = run_schedule(tables, group=topo.stage_group,
                           inputs=list(micro) if me == 0 else None,
                           like=micro[0], chunk_fn=lambda j, x: (
                               x * 2.0 + 1.0, None),
                           num_chunks=chunks, num_microbatches=M,
                           forward_only=True, stats=topo.comm)
        out[name] = (torch.stack(res.outputs).numpy() if me == S - 1
                     else None)
    ct = torch.from_numpy(p["ct"])
    for name, tables, chunks, recompute in (
            ("gpipe_grads", make_gpipe_schedule(S, M), 1, False),
            ("1f1b_grads", make_1f1b_schedule(S, v, M), v, True)):
        w = [torch.full((), 1.5 + 0.25 * (j * S + me),
                        requires_grad=True) for j in range(chunks)]
        res = run_schedule(
            tables, group=topo.stage_group,
            inputs=list(micro) if me == 0 else None, like=micro[0],
            chunk_fn=lambda j, x: (x * w[j] + 1.0, None),
            num_chunks=chunks, num_microbatches=M,
            slot_params=[[t] for t in w],
            head_fn=lambda hp, y, m: ((y * ct[m]).sum() * hp[0], y.sum()),
            head_params=[torch.ones((), requires_grad=True)],
            recompute=recompute, stats=topo.comm)
        out[name] = {"w": [float(d[0]) for d in res.dslots],
                     "dinputs": (torch.stack(res.dinputs).numpy()
                                 if me == 0 else None),
                     "losses": res.losses.numpy().tolist()}
    out["stage"] = me
    out["staged"] = dict(topo.comm.staged)
    return out


def step(p: dict) -> dict:
    """One train step from the reference's params in the mesh's stacked
    layout on ``p["batch"]``: the loss, accuracy, and the params
    gathered whole (stacked). A refusal is returned as ``{"error"}``."""
    cfg = ExperimentConfig.from_dict(p["cfg"])
    try:
        topo = make_topology(cfg.mesh)
        model, state = _state(cfg, topo, p["params"])
        fn = api.build_train_step(model, cfg, lr_schedule.constant(LR), topo)
        state, m = fn(state, _process_rows(p["batch"], topo))
    except (ValueError, ConfigError) as e:
        return {"error": f"{type(e).__name__}: {e}"}
    return {"coords": coords(topo), "loss": float(m["loss"]),
            "train_acc": float(m["train_acc"]),
            "params": _np(api.tp_gather(state.params, model, topo)),
            "staged": dict(topo.comm.staged)}


def evaluate(p: dict) -> dict:
    """``build_eval_step`` of the mesh on the reference's params, each
    eval microbatch count the rows allow: the eval sums of the batch."""
    cfg = ExperimentConfig.from_dict(p["cfg"])
    topo = make_topology(cfg.mesh)
    model, state = _state(cfg, topo, p["params"])
    fn = api.build_eval_step(model, cfg, topo)
    toks = torch.from_numpy(p["tokens"])
    batch = {"image": toks, "label": toks,
             "weight": torch.ones(toks.shape[0])}
    return {"sums": [float(x) for x in fn(state.params, batch)]}


def trainer(p: dict) -> dict:
    """The Trainer on a pipelined mesh: a fresh run with saves by steps,
    an eval, and a resume to ``resume_steps``; then the cross-schedule
    resume, which must be refused (``p["other"]``: the other schedule's
    mesh overrides)."""
    from distributedmnist_tpu_torch.train.loop import Trainer
    d = p["cfg"]
    t = Trainer(ExperimentConfig.from_dict(d), device=CPU)
    summary = t.run()
    out = {"coords": coords(t.topo), "final_step": summary["final_step"],
           "last": summary["last_metrics"],
           "digest": summary["params_digest"], "eval": t.evaluate("test"),
           "is_writer": t.is_writer,
           "params": _np(t.logical_params())}
    d2 = copy.deepcopy(d)
    d2["train"].update(resume=True, max_steps=p["resume_steps"])
    t2 = Trainer(ExperimentConfig.from_dict(d2), device=CPU)
    out["resumed_start"] = t2._start_step
    s2 = t2.run()
    out.update(resumed_final=s2["final_step"],
               resumed_digest=s2["params_digest"])
    if p.get("other"):
        d3 = copy.deepcopy(d2)
        d3["mesh"].update(p["other"])
        d3["train"]["max_steps"] = p["resume_steps"] + 2
        try:
            Trainer(ExperimentConfig.from_dict(d3), device=CPU)
            out["cross_schedule"] = None
        except ValueError as e:
            out["cross_schedule"] = str(e)
    return out


def refusals(p: dict) -> dict:
    """Each of ``p["cfgs"]`` built into a Trainer (or, with ``"step"``,
    a train step): the message it is refused with, or None."""
    from distributedmnist_tpu_torch.train.loop import Trainer
    out = {}
    for name, d in p["cfgs"].items():
        cfg = ExperimentConfig.from_dict(d)
        try:
            if name.startswith("step"):
                topo = make_topology(cfg.mesh)
                api.build_train_step(get_model(cfg.model), cfg,
                                     lr_schedule.constant(LR), topo)
            else:
                Trainer(cfg, device=CPU)
            out[name] = None
        except (ValueError, ConfigError) as e:
            out[name] = str(e)
    return out


def world_env(p: dict) -> dict:
    """The topology's coordinates and sub-group members on this rank."""
    topo = make_topology(ExperimentConfig.from_dict(p["cfg"]).mesh)
    members = {}
    for name in ("replica_group", "model_group", "seq_group", "stage_group",
                 "expert_group", "expert_model_group"):
        g = getattr(topo, name)
        members[name] = (None if g is None else
                         [dist.get_global_rank(g, r)
                          for r in range(dist.get_world_size(g))])
    return {"coords": coords(topo), "members": members, "rank": topo.rank}


def save_initial(p: dict) -> dict:
    """A Trainer of ``p["cfg"]`` that runs no step and saves its initial
    params (the final save at step 0), from the reference's params
    (``p["params"]``, per-layer) in the mesh's stacked layout."""
    from distributedmnist_tpu_torch.train.loop import Trainer
    cfg = ExperimentConfig.from_dict(p["cfg"])
    t = Trainer(cfg, device=CPU)
    full = params_from_reference(stacked(copy.deepcopy(p["params"]),
                                         p["cfg"]["mesh"]), device=CPU)
    with torch.no_grad():
        for a, b in zip(api.tree_leaves(t.state.params), api.tree_leaves(
                api.tp_shard(full, t.model, t.topo))):
            a.copy_(b)
    t.run()
    return {"is_writer": t.is_writer}


def restore(p: dict) -> dict:
    """A Trainer of ``p["cfg"]`` resumed from ``p["cfg"]``'s train_dir
    (a checkpoint another package wrote): the step and the params it
    restored, gathered whole."""
    from distributedmnist_tpu_torch.train.loop import Trainer
    t = Trainer(ExperimentConfig.from_dict(p["cfg"]), device=CPU)
    return {"step": t._start_step, "params": _np(t.logical_params())}
