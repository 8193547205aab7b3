"""The cases the tensor-parallel serving parity test runs in gloo worker
processes (``_torch_mp.run_world(..., cases="_torch_tp_serving_cases")``):
each rank restores a published checkpoint onto the serving topology
(``core/mesh.py serving_topology``), keeps its shard, and runs the
group's forward, prefill and one paged decode step on the payload's
tokens; the test holds the results against the reference's functions on
the same params in the pytest process. This module imports the port
only.
"""

import dataclasses

import numpy as np
import torch

from distributedmnist_tpu_torch.core.config import effective_model_config
from distributedmnist_tpu_torch.core.mesh import serving_topology
from distributedmnist_tpu_torch.models.registry import get_model
from distributedmnist_tpu_torch.parallel.api import restore_for_topology
from distributedmnist_tpu_torch.servesvc.kv_cache import PagedKVCache
from distributedmnist_tpu_torch.servesvc.tp_group import held_shard_digest
from distributedmnist_tpu_torch.train import checkpoint as ckpt

CPU = torch.device("cpu")


def tp_serving_forward(payload: dict) -> dict:
    """This rank's shard of ``payload["train_dir"]``'s step, and the
    group's full logits of: the one-shot forward of ``tokens``, the
    prefill of ``prompt``, and the decode step that feeds ``next`` at
    position ``len(prompt)`` through a paged cache of this rank's
    heads, for the model with ``attention_impl``."""
    cfg = ckpt.wait_for_run_config(payload["train_dir"])
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, attention_impl=payload["attention_impl"]))
    model = get_model(effective_model_config(cfg, serving=True))
    topo = serving_topology(2)
    state, _, step = restore_for_topology(
        model, cfg, topo, payload["train_dir"], None, step=payload["step"],
        device=CPU)
    params = state.params
    apply = model.sharded_apply_factory(None, topo.model_group, topo.comm)
    prefill, decode_step = model.tp_decode_factory(topo.model_group,
                                                   topo.comm)
    with torch.no_grad():
        logits = apply(params, torch.from_numpy(payload["tokens"]), None)
        prompt = payload["prompt"]
        plen = prompt.shape[1]
        pl, ks, vs = prefill(params, torch.from_numpy(prompt))
        layers, heads, hd = model.decode_cache_shape
        cache = PagedKVCache(layers, 8, 4, heads // 2, hd, 4, device=CPU)
        table = cache.alloc_sequence(plen + 1)
        cache.write_prompt(table, ks[:, 0], vs[:, 0], plen)
        dl, _, _ = decode_step(
            params, torch.tensor([payload["next"]]), torch.tensor([plen]),
            cache.k, cache.v, torch.from_numpy(table[None]),
            torch.tensor([plen + 1], dtype=torch.int32), block_size=4,
            attention_kernel="paged")
    return {"step": step, "logits": logits.numpy(), "prefill": pl.numpy(),
            "decode": dl.numpy(), "k": ks.numpy(),
            "digest": held_shard_digest(params),
            "heads_cached": int(cache.k.shape[3]),
            "staged": dict(topo.comm.staged)}
