"""The cases the tensor/sequence-parallel parity tests run in gloo worker
processes (``_torch_mp.run_world``). Each takes a payload of numpy
inputs (the reference's converted params, token batches, q/k/v) and
returns numpy results; the tests hold them against the reference's
shard_map runs in the pytest process. This module imports the port
only.
"""

import copy

import numpy as np
import torch

from distributedmnist_tpu_torch.core.config import ExperimentConfig, MeshConfig
from distributedmnist_tpu_torch.core.mesh import make_topology
from distributedmnist_tpu_torch.data.datasets import ArrayDataset
from distributedmnist_tpu_torch.models.convert import (params_from_reference,
                                                       params_to_reference)
from distributedmnist_tpu_torch.models.registry import get_model
from distributedmnist_tpu_torch.parallel import api
from distributedmnist_tpu_torch.parallel.partition_rules import (
    spec_leaves, split_dim, tree_path_names)
from distributedmnist_tpu_torch.train import lr_schedule
from distributedmnist_tpu_torch.train.evaluation import run_full_eval

CPU = torch.device("cpu")
LR = 0.1


def cfg_dict(n_replicas=1, m=1, s=1, heads=4, sp_attention="ring",
             attention_impl="dense", **over) -> dict:
    """The reference tests' tiny transformer (``tests/
    test_tensor_parallel.py _cfg``): seq 32, d 32, 2 layers, vocab 37,
    float32, batch 4 a replica, sync, no stragglers; ``over`` merges
    into the sections."""
    d = {"data": {"dataset": "synthetic_lm", "batch_size": 4 * n_replicas,
                  "synthetic_train_size": 1024, "synthetic_test_size": 256,
                  "use_native_pipeline": False},
         "model": {"name": "transformer", "compute_dtype": "float32",
                   "seq_len": 32, "model_dim": 32, "num_heads": heads,
                   "num_layers": 2, "vocab_size": 37,
                   "attention_impl": attention_impl,
                   "sp_attention": sp_attention},
         "sync": {"mode": "sync", "straggler_profile": "none"},
         "mesh": {"num_replicas": n_replicas, "model_parallelism": m,
                  "seq_parallelism": s},
         "optim": {"initial_learning_rate": LR,
                   "learning_rate_decay_factor": 1.0},
         "train": {"max_steps": 10, "log_every_steps": 5,
                   "save_interval_steps": 0, "save_results_period": 0}}
    d = copy.deepcopy(d)
    for sec, vals in over.items():
        d[sec] = {**d.get(sec, {}), **vals}
    return d


def _np(tree):
    """A tree of tensors as numpy copies (a CPU tensor's numpy view
    would follow later in-place updates)."""
    return None if tree is None else copy.deepcopy(params_to_reference(tree))


def _coords(topo) -> tuple:
    return (topo.process_index, topo.model_index, topo.seq_index)


def _state(cfg, topo, params):
    """The port's state for ``topo`` with the reference's full params
    (numpy) converted and cut to this rank's shard."""
    model = get_model(cfg.model)
    state = api.init_train_state(model, cfg, CPU, topo)
    # a copy: the payload's arrays are shared by every case of a launch
    full = params_from_reference(copy.deepcopy(params), device=CPU)
    state.params = api.tp_shard(full, model, topo)
    return model, state


def _process_rows(batch: dict, topo) -> dict:
    """Replica-process ``p``'s rows of the global batch."""
    rows = batch["image"].shape[0] // topo.process_count
    lo = topo.process_index * rows
    return {k: torch.from_numpy(np.ascontiguousarray(v[lo:lo + rows]))
            for k, v in batch.items()}


def _replicated_grads(step, model, topo, state, batch) -> dict:
    """This rank's float32 gradients of the leaves the rules leave whole
    (the embeddings and norms), by path."""
    xs = topo.split_batch(batch["image"])
    ys = topo.split_batch(batch["label"])
    _, _, grads = step._sharded_grads(state.params, xs, ys)
    specs = spec_leaves(api.tp_specs(model, topo, state.params)) if (
        topo.model_parallelism > 1) else [()] * len(grads)
    names = tree_path_names(state.params)
    axis = topo.axis_names[1]
    return {n: g.numpy().copy() for n, g, sp in zip(names, grads, specs)
            if split_dim(sp, axis) is None}


def step(p: dict) -> dict:
    """``p["steps"]`` train steps from the converted params on
    ``p["batches"]`` (each the global batch); the losses, the params
    gathered whole, and (``p["grads"]``) the replicated leaves' first
    gradients. A raised error is returned as ``{"error": ...}``."""
    cfg = ExperimentConfig.from_dict(p["cfg"])
    topo = make_topology(cfg.mesh)
    try:
        model, state = _state(cfg, topo, p["params"])
        fn = api.build_train_step(model, cfg, lr_schedule.constant(LR), topo)
        out = {"coords": _coords(topo)}
        if p.get("grads"):
            out["replicated_grads"] = _replicated_grads(
                fn, model, topo, state, _process_rows(p["batches"][0], topo))
        losses, flags = [], []
        for b in p["batches"]:
            state, m = fn(state, _process_rows(b, topo))
            losses.append(float(m["loss"]))
            flags.append(m["flags"].tolist())
        out.update(losses=losses, flags=flags,
                   params=_np(api.tp_gather(state.params, model, topo)),
                   momentum=_np(api.gather_state(state, model,
                                                 topo).momentum))
        return out
    except (ValueError, NotImplementedError) as e:
        return {"error": f"{type(e).__name__}: {e}"}


def forward(p: dict) -> dict:
    """The sharded forward on the converted params: this rank's model
    shard over the model group and, under SP, its block of the tokens
    at their global positions over the seq group."""
    cfg = ExperimentConfig.from_dict(p["cfg"])
    topo = make_topology(cfg.mesh)
    model, state = _state(cfg, topo, p["params"])
    apply = model.sharded_apply_factory(topo.seq_group, topo.model_group)
    tokens = topo.seq_block(torch.from_numpy(p["tokens"]))
    positions = (topo.seq_positions(tokens.shape[1], CPU)
                 if topo.seq_parallelism > 1 else None)
    with torch.no_grad():
        return {"seq_index": topo.seq_index,
                "logits": apply(state.params, tokens, positions).numpy()}


def evaluate(p: dict) -> dict:
    """``run_full_eval`` of the converted params over ``p["tokens"]``:
    the split striped over the replica-processes, each rank's shard
    through the tensor-parallel eval step."""
    cfg = ExperimentConfig.from_dict(p["cfg"])
    topo = make_topology(cfg.mesh)
    model, state = _state(cfg, topo, p["params"])
    fn = api.build_eval_step(model, cfg, topo)
    data = ArrayDataset(p["tokens"], p["tokens"].copy())
    res = run_full_eval(fn, state.params, data, p["batch_size"], device=CPU,
                        topo=topo)
    return {k: res[k] for k in ("accuracy", "loss", "num_examples")}


def attention(p: dict) -> dict:
    """Ring or Ulysses attention over the whole world as one seq group:
    this rank's block of the full ``[b, h, s, d]`` q/k/v (bhsd), its
    output block, and with ``p["grads"]`` the gradients of the blocks
    for ``Σ out²`` (the full objective summed over ranks)."""
    from distributedmnist_tpu_torch.ops.flash_attention import (
        flash_attention_bshd, flash_attention_bshd_plain)
    from distributedmnist_tpu_torch.ops.ring_attention import \
        ring_self_attention
    from distributedmnist_tpu_torch.ops.ulysses_attention import \
        ulysses_self_attention
    import torch.distributed as dist
    topo = make_topology(MeshConfig(num_replicas=1,
                                    seq_parallelism=dist.get_world_size()))
    group = topo.seq_group
    w = p["q"].shape[2] // topo.seq_parallelism
    j = topo.seq_index
    blocks = [torch.from_numpy(np.ascontiguousarray(
        x[:, :, j * w:(j + 1) * w])).requires_grad_(bool(p["grads"]))
        for x in (p["q"], p["k"], p["v"])]
    try:
        if p["impl"] == "ring":
            out = ring_self_attention(*blocks, group, causal=p["causal"])
        else:
            inner = (flash_attention_bshd if p["impl"] == "ulysses_flash"
                     else flash_attention_bshd_plain)
            t = lambda x: x.transpose(1, 2)  # noqa: E731
            out = t(ulysses_self_attention(*(t(x) for x in blocks), group,
                                           causal=p["causal"],
                                           attention_fn=inner))
    except ValueError as e:
        return {"error": str(e)}
    res = {"rank": j, "out": out.detach().numpy()}
    if p["grads"]:
        (out ** 2).sum().backward()
        res["grads"] = [x.grad.numpy() for x in blocks]
    return res


def save_initial(p: dict) -> dict:
    """A Trainer of ``p["cfg"]`` that runs no step and saves its initial
    params (the final save at step 0)."""
    from distributedmnist_tpu_torch.train.loop import Trainer
    t = Trainer(ExperimentConfig.from_dict(p["cfg"]), device=CPU)
    t.run()
    return {"is_writer": t.is_writer}


def trainer(p: dict) -> dict:
    """The Trainer on the 3-D mesh: a fresh run of ``max_steps`` steps
    (quorum over lognormal stragglers), an eval, a resume to
    ``resume_steps``; then a resume from ``p["restore_dir"]`` (a
    one-process run's checkpoint) with the params it restored gathered
    whole; and this rank's replicated-leaf gradients on one batch."""
    from distributedmnist_tpu_torch.train.loop import Trainer
    d = p["cfg"]
    out = {}
    flags = []
    t = Trainer(ExperimentConfig.from_dict(d), device=CPU)
    out["coords"] = _coords(t.topo)
    summary = t.run(step_callback=lambda s, r: flags.append(r["flags"]))
    out.update(final_step=summary["final_step"], flags=flags,
               last=summary["last_metrics"], digest=summary["params_digest"],
               eval=t.evaluate("test"),
               replicated_grads=_replicated_grads(
                   t._train_step, t.model, t.topo, t.state,
                   _process_rows(next(t.train_iter), t.topo)))
    d2 = copy.deepcopy(d)
    d2["train"].update(resume=True, max_steps=p["resume_steps"])
    t2 = Trainer(ExperimentConfig.from_dict(d2), device=CPU)
    out["resumed_start"] = t2._start_step
    s2 = t2.run()
    out["resumed_final"], out["resumed_digest"] = (s2["final_step"],
                                                   s2["params_digest"])
    d3 = copy.deepcopy(d)
    d3["train"].update(resume=True, train_dir=p["restore_dir"],
                       max_steps=0)
    t3 = Trainer(ExperimentConfig.from_dict(d3), device=CPU)
    out["restored_step"] = t3._start_step
    out["restored_params"] = _np(t3.logical_params())
    return out


def world_env(p: dict) -> dict:
    """The topology's coordinates and sub-group members on this rank."""
    import torch.distributed as dist
    cfg = ExperimentConfig.from_dict(p["cfg"])
    topo = make_topology(cfg.mesh)
    members = {}
    for name in ("replica_group", "model_group", "seq_group"):
        g = getattr(topo, name)
        members[name] = (None if g is None else
                         [dist.get_global_rank(g, r)
                          for r in range(dist.get_world_size(g))])
    return {"coords": _coords(topo), "members": members,
            "rank": topo.rank, "n": topo.num_replicas,
            "local": topo.local_replica_count, "first": topo.first_replica}



def sp_trainer(p: dict) -> dict:
    """A fresh Trainer run of ``p["cfg"]`` and its test eval: the last
    record, every step's flags and the data cursor's implementation."""
    from distributedmnist_tpu_torch.train.loop import Trainer
    flags = []
    t = Trainer(ExperimentConfig.from_dict(p["cfg"]), device=CPU)
    summary = t.run(step_callback=lambda s, r: flags.append(r["flags"]))
    return {"final_step": summary["final_step"],
            "last": summary["last_metrics"], "flags": flags,
            "eval": t.evaluate("test"), "impl": t.train_iter.state()["impl"]}
