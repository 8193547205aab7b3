"""A compact causal-LM transformer (≙ ``distributedmnist_tpu/models/
transformer.py``): ``init``, ``apply`` (a dense or mixture-of-experts
FFN; differentiable, so the train step runs it under autograd), the
next-token ``loss_fn`` and ``accuracy``, the prompt prefill with K/V
export, and the one-token decode step over a paged KV cache (dense FFNs
only, as in the reference).

Params are a plain dict in the reference's layout, so a reference
checkpoint converts leaf for leaf (``models/convert.py``):
``embed [V, d]`` (also the tied LM head), ``pos [S, d]``, per block
``ln1/ln2 {"scale": [d]}``, ``wqkv [d, 3, d]``, ``wo [d, d]``,
``w1 [d, 4d]``, ``w2 [4d, d]``, and ``final_norm {"scale": [d]}``; with
``num_experts = E > 0`` each block's FFN is ``router [d, E]``, ``w1 [E,
d, 4d]`` and ``w2 [E, 4d, d]`` (:mod:`..ops.moe`).

Dtypes follow the reference at the same points: every param is cast to
the compute dtype on entry (a no-op when the caller already holds them
in it; a differentiable cast, so gradients reach float32 params in
float32, as the cast's transpose does in the reference), ``_rms_norm``
computes in float32 and casts back, attention runs in float32 inside
the kernels, and the decode attention's float32 output is cast to the
compute dtype before ``wo``.

``apply(remat=True)`` recomputes activations in the backward instead of
keeping them (``torch.utils.checkpoint``, non-reentrant), by the
reference's two policies: ``"full"`` checkpoints each block, so the
flash forward runs again in the backward; ``"save_attn"`` keeps the
attention sublayer outside the checkpoint (its Function's residuals,
O(s·d), stay) and recomputes only the FFN sublayer and its norm.

Tensor parallelism (Megatron; ≙ the reference's ``model_axis`` path):
``apply(model_group=g)`` runs on one rank's shard of the params
(``parallel/partition_rules.py transformer_partition_rules``: ``wqkv``
and ``w1`` split on their output dim, ``wo`` and ``w2`` on their input
dim), so this rank computes ``num_heads / m`` heads and its slice of the
FFN; ``copy_to_group`` (*f*) sits on ``ln1(x)`` and ``ln2(x)`` where they
enter the column-parallel products and ``reduce_from_group`` (*g*)
after ``wo`` and ``w2``, so activations, logits and any loss are the
same on every rank of the group. :func:`prefill_with_kv` and
:func:`decode_step` take the same ``model_group`` (tensor-parallel
serving): each rank's prefill K/V and paged cache hold its ``h / m``
heads. Sequence parallelism needs nothing
here but the block's global ``positions`` and a sequence-parallel
``attention_fn`` (ring or Ulysses, ``models/registry.py
make_seq_attn``); :func:`sp_partial_token_loss` is its loss. Expert
parallelism: ``apply(moe=MoeGroups(...))`` runs each MoE FFN on this
rank's experts over the expert group (:func:`..ops.moe.moe_ffn`), the
block's other leaves whole (or tensor-parallel as above).

Pipeline parallelism (≙ the reference's ``models/transformer.py:
431-843``): :func:`stack_block_params` / :func:`stack_block_params_chunked`
give the stacked layouts (``blocks`` one dict of leaves stacked on a
layer dim, in layer order for GPipe, chunk-interleaved for 1F1B:
:func:`pp_layer_order`), whose layer dim splits over the stage group;
:func:`grads_pp` (GPipe) and :func:`grads_pp_1f1b` run one stage's share
of a training step through :mod:`..ops.pipeline`'s engine — the
embedding on stage 0, this stage's chunks of layers (TP, SP and EP
inside them as above), the loss head on the last stage — and
:func:`apply_pp` / :func:`apply_pp_1f1b` its forward for eval.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import local_self_attention
from ..ops.collectives import copy_to_group, reduce_from_group
from ..ops.moe import moe_ffn
from ..ops.paged_attention import paged_attention, paged_attention_dense
from ..parallel.partition_rules import map_leaves, tree_leaves

Params = dict[str, Any]


def _trunc_normal(shape, stddev, generator, device) -> torch.Tensor:
    """N(0, stddev²) truncated to ±2σ, float32 (≙ the reference's
    ``truncated_normal_init``; a torch generator draws other numbers
    than a JAX key, so tests convert reference params instead)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type == "meta":
        # shapes alone; the initializer on the meta device runs torch's
        # Python references, whose first call imports torch._dynamo (10
        # s of a serving rank's boot on the H100 host)
        return t
    return torch.nn.init.trunc_normal_(t, 0.0, stddev, -2 * stddev,
                                       2 * stddev, generator=generator)


@dataclasses.dataclass(frozen=True)
class MoeGroups:
    """How a block's mixture-of-experts FFN runs (≙ the reference's
    ``num_experts`` … ``moe_stats_axes`` arguments): the routing knobs,
    and the process groups of expert parallelism (``expert_group``; its
    output sum over ``reduce_group``, the expert×model ranks) and of
    the sequence blocks its load statistics average over
    (``stats_group``). The model group is ``apply``'s."""

    num_experts: int
    capacity_factor: float
    router_top_k: int
    num_groups: int
    expert_group: Any
    reduce_group: Any
    stats_group: Any


def init(generator: torch.Generator, vocab_size: int = 256,
         model_dim: int = 128, num_heads: int = 4, num_layers: int = 2,
         max_seq_len: int = 512, device=None,
         num_experts: int = 0) -> Params:
    """Float32 params on ``device`` (default: the generator's; ``meta``
    gives the shapes alone); ``num_experts > 0`` makes every block's FFN
    a routed mixture of experts."""
    if model_dim % num_heads:
        raise ValueError(f"model_dim={model_dim} not divisible by "
                         f"num_heads={num_heads}")
    dev = generator.device if device is None else device
    d, ff, scale = model_dim, 4 * model_dim, 0.02
    tn = lambda *shape: _trunc_normal(shape, scale, generator, dev)
    ones = lambda: {"scale": torch.ones(d, dtype=torch.float32, device=dev)}
    def ffn() -> dict:
        if num_experts > 0:
            return {"router": tn(d, num_experts),
                    "w1": tn(num_experts, d, ff),
                    "w2": tn(num_experts, ff, d)}
        return {"w1": tn(d, ff), "w2": tn(ff, d)}

    return {
        "embed": tn(vocab_size, d),
        "pos": tn(max_seq_len, d),
        "blocks": [{"ln1": ones(), "wqkv": tn(d, 3, d), "wo": tn(d, d),
                    "ln2": ones(), **ffn()}
                   for _ in range(num_layers)],
        "final_norm": ones(),
    }


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """Every leaf cast to ``dtype`` (leaves already in it are returned
    as they are, so casting cast params costs nothing)."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [cast_params(v, dtype) for v in params]
    return params.to(dtype)


def _rms_norm(x: torch.Tensor, p: Params) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + 1e-6) * p["scale"]).to(x.dtype)


def _attn_sublayer(x: torch.Tensor, blk: Params, *, num_heads: int,
                   attn: Callable, return_kv: bool = False,
                   model_group=None, stats=None):
    """Pre-norm attention sublayer: ``x + wo(attn(qkv(ln1(x))))``. Under
    tensor parallelism ``blk`` holds this rank's shard (``wqkv [d, 3,
    e]``, ``wo [e, d]``, ``e = d / m``): it runs its ``e / head_dim``
    heads, and the row-parallel ``wo`` product is summed over
    ``model_group``.

    ``return_kv`` also returns this layer's K/V in ``[b, s, h, hd]``
    (strided views of the qkv product) — what the prefill seeds the
    paged cache with."""
    b, s, d = x.shape
    hd = d // num_heads
    e = blk["wqkv"].shape[-1]
    h_local = e // hd
    h = copy_to_group(_rms_norm(x, blk["ln1"]), model_group, stats)
    qkv = (h @ blk["wqkv"].reshape(d, 3 * e)).view(b, s, 3, e)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    bshd = lambda t: t.view(b, s, h_local, hd)
    if getattr(attn, "layout", "bhsd") == "bshd":
        # the kernel reads the residual layout through its strides: no
        # head transpose, no copy
        o = attn(bshd(q), bshd(k), bshd(v)).reshape(b, s, e)
    else:
        heads = lambda t: bshd(t).transpose(1, 2)
        o = attn(heads(q), heads(k), heads(v)).transpose(1, 2).reshape(
            b, s, e)
    out = x + reduce_from_group(o @ blk["wo"], model_group, stats)
    if return_kv:
        return out, bshd(k), bshd(v)
    return out


def _ffn_sublayer(x: torch.Tensor, blk: Params,
                  model_group=None, stats=None) -> torch.Tensor:
    """Pre-norm dense FFN sublayer: ``x + w2(relu(w1(ln2(x))))``; under
    tensor parallelism ``w1`` holds this rank's columns and ``w2`` its
    rows, and the product is summed over ``model_group``."""
    h = copy_to_group(_rms_norm(x, blk["ln2"]), model_group, stats)
    return x + reduce_from_group(F.relu(h @ blk["w1"]) @ blk["w2"],
                                 model_group, stats)


def _moe_sublayer(x: torch.Tensor, blk: Params, moe: MoeGroups,
                  model_group=None, stats=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm mixture-of-experts FFN sublayer: ``(x + moe(ln2(x)),
    aux)`` (:func:`..ops.moe.moe_ffn` sums over the model group
    itself)."""
    out, aux = moe_ffn(_rms_norm(x, blk["ln2"]), blk["router"], blk["w1"],
                       blk["w2"], num_experts=moe.num_experts,
                       capacity_factor=moe.capacity_factor,
                       router_top_k=moe.router_top_k,
                       num_groups=moe.num_groups,
                       expert_group=moe.expert_group,
                       model_group=model_group,
                       reduce_group=moe.reduce_group,
                       stats_group=moe.stats_group, stats=stats)
    return x + out, aux


def _embed(p: Params, tokens: torch.Tensor,
           positions: torch.Tensor | None) -> torch.Tensor:
    if positions is None:
        positions = torch.arange(tokens.shape[-1], device=tokens.device)
    return p["embed"][tokens.long()] + p["pos"][positions.long()]


def _head(x: torch.Tensor, p: Params) -> torch.Tensor:
    x = _rms_norm(x, p["final_norm"])
    return (x @ p["embed"].T).float()  # tied head


def _check_heads(num_heads: int, model_group) -> None:
    m = 1 if model_group is None else dist.get_world_size(model_group)
    if num_heads % m != 0:
        raise ValueError(f"num_heads={num_heads} not divisible by "
                         f"model-parallel size {m}")


def _sublayers(num_heads: int, attn: Callable, model_group, stats,
               moe: MoeGroups | None) -> tuple[Callable, Callable]:
    """A block's two halves: ``attn_part(x, blk) -> x`` and
    ``ffn_part(x, blk) -> (x, aux)`` (aux 0 for a dense FFN)."""
    def attn_part(x, blk):
        return _attn_sublayer(x, blk, num_heads=num_heads, attn=attn,
                              model_group=model_group, stats=stats)

    def ffn_part(x, blk):
        if "router" in blk:
            return _moe_sublayer(x, blk, moe, model_group, stats)
        return _ffn_sublayer(x, blk, model_group, stats), x.new_zeros(
            (), dtype=torch.float32)
    return attn_part, ffn_part


def apply(params: Params, tokens: torch.Tensor, *, num_heads: int = 4,
          attention_fn: Callable | None = None,
          positions: torch.Tensor | None = None,
          compute_dtype: torch.dtype = torch.bfloat16, remat: bool = False,
          remat_policy: str = "full", model_group=None,
          stats=None, moe: MoeGroups | None = None,
          return_aux: bool = False):
    """tokens [batch, seq] → logits [batch, seq, vocab] float32, or with
    ``return_aux`` ``(logits, aux)``: the MoE load-balance losses summed
    over the blocks (0 without experts).

    ``positions`` (the global positions of these tokens) must be given
    when the sequence is split; defaults to ``arange(seq)``.
    ``model_group``: run tensor-parallel over that process group on this
    rank's shard of the params (the module docstring); the heads must
    divide over it. ``moe``: how the blocks' expert FFNs run (needed
    when the params have a ``router``). ``stats`` (a
    :class:`..core.mesh.CommStats`) counts its collectives."""
    attn = attention_fn or local_self_attention
    _check_heads(num_heads, model_group)
    p = cast_params(params, compute_dtype)
    x = _embed(p, tokens, positions)
    attn_part, ffn_part = _sublayers(num_heads, attn, model_group, stats,
                                     moe)

    def block(x, blk):
        return ffn_part(attn_part(x, blk), blk)

    ckpt = lambda fn: lambda *a: checkpoint(fn, *a, use_reentrant=False)  # noqa: E731
    if remat:
        if remat_policy == "save_attn":
            ffn = ckpt(ffn_part)

            def block(x, blk):  # noqa: F811 — the policy's body
                return ffn(attn_part(x, blk), blk)
        elif remat_policy == "full":
            block = ckpt(block)
        else:
            raise ValueError(f"unknown remat_policy {remat_policy!r} "
                             "(expected 'full' or 'save_attn')")
    if "router" in p["blocks"][0] and moe is None:
        raise ValueError("mixture-of-experts params need apply(moe=...)")
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in p["blocks"]:
        x, aux = block(x, blk)
        aux_total = aux_total + aux
    logits = _head(x, p)
    return (logits, aux_total) if return_aux else logits


def sp_partial_token_loss(logits: torch.Tensor, tgt: torch.Tensor,
                          positions: torch.Tensor, s_global: int,
                          total: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The sequence-parallel partial next-token (loss, accuracy) of one
    sequence block (≙ the reference's ``sp_partial_token_loss``).

    ``logits`` [b, s_loc, V] this block's; ``tgt`` [b, s_loc] its targets,
    already shifted one *global* position (the caller fetches the next
    block's first column); ``positions`` its global positions;
    ``total`` the global count of predicted tokens. Summed over the
    sequence blocks the pair is the dense :func:`loss_fn` /
    :func:`accuracy`: the global last position has no target (weight
    0)."""
    w = (positions < s_global - 1).float()[None, :]
    logp = torch.log_softmax(logits.float(), dim=-1)
    tgt = tgt.long()
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    correct = (torch.argmax(logp, dim=-1) == tgt).float()
    return (nll * w).sum() / total, (correct * w).sum() / total


def loss_fn(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Next-token mean cross-entropy. ``labels`` are the input tokens;
    targets are labels shifted left (last position dropped)."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = labels[:, 1:].long()
    return -logp.gather(-1, tgt[..., None])[..., 0].mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Next-token top-1 accuracy over the same positions as
    :func:`loss_fn`."""
    pred = torch.argmax(logits[:, :-1], dim=-1)
    return (pred == labels[:, 1:].long()).float().mean()


def prefill_with_kv(params: Params, tokens: torch.Tensor, *,
                    num_heads: int = 4,
                    attention_fn: Callable | None = None,
                    positions: torch.Tensor | None = None,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    model_group=None, stats=None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prompt prefill: the causal forward through the configured
    attention (the flash kernel when ``attention_impl="flash"``) that
    also returns every layer's K/V for seeding a decode cache.

    tokens [b, s] → (logits [b, s, vocab] float32, k [L, b, s, h, hd],
    v [L, b, s, h, hd]) with K/V in the compute dtype. Under
    ``model_group`` the params are this rank's tensor-parallel shard (as
    :func:`apply`'s): attention runs on its ``h / m`` heads, K/V are
    those heads', and the logits are the full ones on every rank."""
    attn = attention_fn or local_self_attention
    _check_heads(num_heads, model_group)
    p = cast_params(params, compute_dtype)
    x = _embed(p, tokens, positions)
    ks, vs = [], []
    for blk in p["blocks"]:
        x, k, v = _attn_sublayer(x, blk, num_heads=num_heads, attn=attn,
                                 return_kv=True, model_group=model_group,
                                 stats=stats)
        ks.append(k)
        vs.append(v)
        x = _ffn_sublayer(x, blk, model_group, stats)
    return _head(x, p), torch.stack(ks), torch.stack(vs)


def decode_step(params: Params, tokens: torch.Tensor,
                positions: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, block_tables: torch.Tensor,
                lengths: torch.Tensor, *, num_heads: int = 4,
                block_size: int = 16,
                compute_dtype: torch.dtype = torch.bfloat16,
                attention_kernel: str = "dense", model_group=None,
                stats=None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One incremental decode step over S slots sharing one paged KV
    cache.

    * ``tokens`` [S] — each slot's newest token,
    * ``positions`` [S] — that token's 0-based position,
    * ``k_cache``/``v_cache`` [L, N, B, h, hd] — the paged cache (block
      0 is the reserved null block),
    * ``block_tables`` [S, P] int32 — each slot's position→block map
      (idle slots: all zeros),
    * ``lengths`` [S] int32 — context length including this token
      (``positions + 1``; 0 for an idle slot, whose row is zeros).

    ``attention_kernel``: ``"paged"`` runs kernel K5
    (``ops/paged_attention.py``), which walks each table in-kernel;
    ``"dense"`` runs its plain version, the full-table gather.

    Under ``model_group`` the params are this rank's tensor-parallel
    shard and the caches hold its ``h / m`` heads: K5 runs over those,
    ``wo`` and ``w2`` are row-parallel (summed over the group), and the
    logits are the full ones on every rank.

    Returns (logits [S, vocab] float32, k_cache, v_cache). Unlike the
    reference, which returns new cache arrays, this token's K/V are
    written INTO the given caches (``index_put_``) and the same tensors
    are returned — a functional copy of the whole cache per token is
    what the reference's buffer donation avoids as well."""
    if attention_kernel not in ("dense", "paged"):
        raise ValueError(
            f"decode.attention_kernel must be 'dense' or 'paged', "
            f"got {attention_kernel!r}")
    attend = paged_attention if attention_kernel == "paged" \
        else paged_attention_dense
    _check_heads(num_heads, model_group)
    p = cast_params(params, compute_dtype)
    num_slots = tokens.shape[0]
    x = _embed(p, tokens, positions)  # [S, d]
    d = x.shape[-1]
    hd = d // num_heads
    scale = 1.0 / (hd ** 0.5)
    positions = positions.long()
    blk_ids = block_tables.long().gather(
        1, (positions // block_size)[:, None])[:, 0]
    offs = positions % block_size
    for li, blk in enumerate(p["blocks"]):
        e = blk["wqkv"].shape[-1]  # d / m under tensor parallelism
        h_local = e // hd
        h = copy_to_group(_rms_norm(x, blk["ln1"]), model_group, stats)
        qkv = (h @ blk["wqkv"].reshape(d, 3 * e)).view(num_slots, 3, e)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        k_cache[li].index_put_(
            (blk_ids, offs), k.reshape(num_slots, h_local, hd).to(
                k_cache.dtype))
        v_cache[li].index_put_(
            (blk_ids, offs), v.reshape(num_slots, h_local, hd).to(
                v_cache.dtype))
        o = attend(q.view(num_slots, h_local, hd), k_cache[li],
                   v_cache[li], block_tables, lengths, scale=scale)
        x = x + reduce_from_group(
            o.to(compute_dtype).reshape(num_slots, e) @ blk["wo"],
            model_group, stats)
        x = _ffn_sublayer(x, blk, model_group, stats)
    return _head(x, p), k_cache, v_cache


# ---------------------------------------------------------------------------
# Pipeline parallelism: layer-stacked params and the stage body
# ---------------------------------------------------------------------------

def _stack(*leaves):
    return (torch.stack(leaves) if isinstance(leaves[0], torch.Tensor)
            else np.stack(leaves))


def pp_layer_order(num_layers: int, num_stages: int = 1,
                   num_chunks: int = 1) -> list[int]:
    """The layer each row of the stacked layout holds (≙ the reference's
    ``stack_block_params_chunked`` order): with one chunk a stage, layer
    order; with ``v`` chunks, stage ``d``'s contiguous shard holds global
    chunks ``{d, S+d, …, (v-1)·S+d}``, slot-major."""
    L, S, v = num_layers, num_stages, num_chunks
    if L % (S * v):
        raise ValueError(
            f"num_layers={L} not divisible by stages×chunks={S}×{v}")
    per = L // (S * v)
    return [c * per + l for d in range(S) for j in range(v)
            for c in [j * S + d] for l in range(per)]


def stack_block_params(params: Params) -> Params:
    """``blocks`` from a list of per-layer dicts to one dict of leaves
    stacked on a leading layer dim (≙ the reference's: the layout whose
    layer dim splits over the stage group). Tensors or numpy arrays."""
    blocks = params["blocks"]
    return {**{k: v for k, v in params.items() if k != "blocks"},
            "blocks": map_leaves(_stack, blocks[0], *blocks[1:])}


def stack_block_params_chunked(params: Params, num_stages: int,
                               num_chunks: int) -> Params:
    """The 1F1B layout (≙ the reference's): :func:`stack_block_params`
    in :func:`pp_layer_order`'s order, so that each stage's contiguous
    shard holds its chunks slot-major."""
    order = pp_layer_order(len(params["blocks"]), num_stages, num_chunks)
    return stack_block_params({**params, "blocks": [params["blocks"][i]
                                                    for i in order]})


class _Stage:
    """One stage's share of a pipelined transformer: its stacked block
    leaves cut into ``num_chunks`` slots of ``per`` layers (each slot a
    tree of views, leaves requiring grad when ``grad``; ``slot_params``
    their leaves in ``tree_leaves`` order), and
    ``chunk(slot, x) -> (y, aux)`` running a slot's layers (``aux`` the
    MoE aux summed over them, None without experts; under ``remat`` each
    layer checkpointed, the reference's ``jax.checkpoint(layer)``)."""

    def __init__(self, blocks: Params, num_chunks: int, *, num_heads: int,
                 attn: Callable, model_group, stats, moe, remat: bool,
                 grad: bool):
        L_local = tree_leaves(blocks)[0].shape[0]
        if L_local % num_chunks:
            raise ValueError(f"{L_local} layers a stage do not split into "
                             f"{num_chunks} chunks")
        per = self.per = L_local // num_chunks
        leaf = ((lambda a: a.detach().requires_grad_(True)) if grad
                else (lambda a: a))
        self.slots = [map_leaves(lambda a, j=j: leaf(
            a[j * per:(j + 1) * per]), blocks) for j in range(num_chunks)]
        self.slot_params = [tree_leaves(s) for s in self.slots]
        self.moe = "router" in blocks
        attn_part, ffn_part = _sublayers(num_heads, attn, model_group, stats,
                                         moe)

        def layer(x, blk):
            return ffn_part(attn_part(x, blk), blk)
        self.layer = ((lambda x, blk: checkpoint(layer, x, blk,
                                                 use_reentrant=False))
                      if remat else layer)

    def chunk(self, slot: int, x: torch.Tensor):
        aux_total = None
        for li in range(self.per):
            x, aux = self.layer(x, map_leaves(lambda a: a[li],
                                              self.slots[slot]))
            if self.moe:
                aux_total = aux if aux_total is None else aux_total + aux
        return x, aux_total


def _stage_sum(x: torch.Tensor, group, stats) -> torch.Tensor:
    """``x`` summed in place over the stage group (its seconds in
    ``stats``)."""
    if stats is None:
        dist.all_reduce(x, group=group)
    else:
        stats.timed(dist.all_reduce, x, group=group)
    return x


def _pp_grads(params: Params, tokens: torch.Tensor, labels: torch.Tensor,
              *, tables, num_heads: int, stage_group, num_microbatches: int,
              num_chunks: int, recompute: bool,
              attention_fn: Callable | None = None,
              positions: torch.Tensor | None = None, model_group=None,
              seq_group=None, moe: MoeGroups | None = None,
              aux_weight: float = 0.0,
              compute_dtype: torch.dtype = torch.bfloat16,
              remat: bool = False, stats=None):
    """The pipelined training step body of one stage (params in the
    stacked layout, this stage's shard of the blocks): the embedding on
    stage 0, the schedule's chunk-works over the stage group
    (:func:`..ops.pipeline.run_schedule`), the loss head on the last
    stage, then one sum over the stage group of what every stage holds
    whole — the embedding's gradient (the lookup's transpose from the
    banked input cotangents plus the tied head's), the positions', the
    final norm's, the losses, the metrics and the MoE aux. Returns
    ``(loss, accuracy, grads)``: the loss the mean of the microbatches'
    (``scale = 1/M``, the reference's sum convention), every float32
    gradient scaled by it, blocks this stage's own.

    Under sequence parallelism (``seq_group``) the tokens are this
    block's, ``positions`` their global positions, the targets shifted
    one global position before the engine, and the loss, accuracy and
    gradients are this block's partials (the caller sums them over the
    seq group); the gradients are float32 leaves in ``tree_leaves``
    order of the stacked params (blocks, embed, final_norm, pos). The
    MoE aux's value term is ``aux_weight / n_seq ·
    aux_sum / M``; its backward seed is ``aux_weight / n_seq`` too (the
    port's aux sums its cotangent over the seq group in
    :func:`..ops.collectives.all_reduce_sum`, where the reference's
    ``pmean`` transposes without a sum and seeds the full weight)."""
    from ..ops.collectives import ppermute
    from ..ops.pipeline import run_schedule

    attn = attention_fn or local_self_attention
    _check_heads(num_heads, model_group)
    M = num_microbatches
    b, s_loc = tokens.shape
    if b % M:
        raise ValueError(f"batch {b} not divisible by "
                         f"num_microbatches={M}")
    mb = b // M
    n_seq = 1 if seq_group is None else dist.get_world_size(seq_group)
    me = dist.get_rank(stage_group)
    if positions is None:
        positions = torch.arange(s_loc, device=tokens.device)
    with torch.no_grad():
        p = cast_params(params, compute_dtype)
    d = p["embed"].shape[-1]
    stage = _Stage(p["blocks"], num_chunks, num_heads=num_heads, attn=attn,
                   model_group=model_group, stats=stats, moe=moe,
                   remat=remat, grad=True)
    inputs = emb = None
    if me == 0:
        with torch.enable_grad():
            emb = [p["embed"].detach().requires_grad_(True),
                   p["pos"].detach().requires_grad_(True)]
            x = emb[0][tokens.long()] + emb[1][positions.long()]
        inputs = list(x.view(M, mb, s_loc, d).unbind(0))
    if seq_group is None:
        tgt = labels
    else:
        # block j's last target is block j+1's first token
        nxt = ppermute(labels[:, :1].contiguous(), -1, seq_group, stats)
        tgt = torch.cat([labels[:, 1:], nxt], dim=1)
    tgt = tgt.view(M, mb, s_loc)
    s_global = s_loc * n_seq

    def head_fn(hp, y, m):
        logits = (_rms_norm(y, {"scale": hp[1]}) @ hp[0].T).float()
        if seq_group is None:
            return loss_fn(logits, tgt[m]), accuracy(logits, tgt[m])
        return sp_partial_token_loss(logits, tgt[m], positions, s_global,
                                     mb * (s_global - 1))

    head = [p["embed"].detach().requires_grad_(True),
            p["final_norm"]["scale"].detach().requires_grad_(True)]
    res = run_schedule(
        tables, group=stage_group, inputs=inputs,
        like=p["embed"].new_empty((mb, s_loc, d)), chunk_fn=stage.chunk,
        num_chunks=num_chunks, num_microbatches=M,
        slot_params=stage.slot_params, head_fn=head_fn, head_params=head,
        recompute=recompute, aux_cotangent=aux_weight / n_seq, stats=stats)
    g_embed, g_norm = res.dhead
    g_pos = torch.zeros(p["pos"].shape, dtype=torch.float32,
                        device=g_embed.device)
    if me == 0:
        g_lookup, g_pos = torch.autograd.grad(
            x, emb, torch.stack(res.dinputs).view_as(x))
        g_embed = g_embed + g_lookup.float()
        g_pos = g_pos.float()
    whole = [g_embed, g_pos, g_norm]
    flat = torch.cat([g.reshape(-1) for g in whole]
                     + [res.losses.sum().reshape(1),
                        res.metrics.sum().reshape(1),
                        res.aux_sum.reshape(1)])
    _stage_sum(flat, stage_group, stats)
    at, out = 0, []
    for g in whole:
        out.append(flat[at:at + g.numel()].view(g.shape) / M)
        at += g.numel()
    loss_sum, acc_sum, aux_sum = flat[at], flat[at + 1], flat[at + 2]
    loss = loss_sum / M
    if moe is not None:
        loss = loss + (aux_weight / n_seq) * aux_sum / M
    # the stacked block leaves: each slot's rows, slot-major
    blocks = [torch.cat(rows) / M for rows in zip(*res.dslots)]
    return loss, acc_sum / M, blocks + [out[0], out[2], out[1]]


def _pp_forward(params: Params, tokens: torch.Tensor, *, tables,
                num_heads: int, stage_group, num_microbatches: int,
                num_chunks: int, attention_fn: Callable | None = None,
                model_group=None, moe: MoeGroups | None = None,
                compute_dtype: torch.dtype = torch.bfloat16,
                stats=None) -> torch.Tensor:
    """The pipelined forward (eval): the embedding on stage 0, the
    schedule's forward works, the last chunk's outputs summed over the
    stage group (zeros elsewhere: every stage gets them, as the
    reference's masked ``psum`` broadcasts them) and the head on every
    stage. Returns logits ``[b, s, V]`` float32."""
    from ..ops.pipeline import run_schedule

    attn = attention_fn or local_self_attention
    _check_heads(num_heads, model_group)
    M = num_microbatches
    b, s = tokens.shape
    if b % M:
        raise ValueError(f"batch {b} not divisible by "
                         f"num_microbatches={M}")
    me = dist.get_rank(stage_group)
    S = dist.get_world_size(stage_group)
    p = cast_params(params, compute_dtype)
    d = p["embed"].shape[-1]
    stage = _Stage(p["blocks"], num_chunks, num_heads=num_heads, attn=attn,
                   model_group=model_group, stats=stats, moe=moe,
                   remat=False, grad=False)
    inputs = (list(_embed(p, tokens, None).view(M, b // M, s, d).unbind(0))
              if me == 0 else None)
    res = run_schedule(tables, group=stage_group, inputs=inputs,
                       like=p["embed"].new_empty((b // M, s, d)),
                       chunk_fn=stage.chunk, num_chunks=num_chunks,
                       num_microbatches=M, forward_only=True, stats=stats)
    out = (torch.cat(res.outputs) if me == S - 1
           else p["embed"].new_zeros((b, s, d)))
    return _head(_stage_sum(out, stage_group, stats), p)


def grads_pp(params: Params, tokens: torch.Tensor, labels: torch.Tensor, *,
             num_microbatches: int, stage_group, **kw):
    """GPipe training (≙ the reference's ``apply_pp`` under AD): all
    forwards (each keeping its graph; under ``remat`` each layer
    checkpointed), then all backwards; :func:`_pp_grads`'s contract."""
    from ..ops.pipeline import make_gpipe_schedule
    tables = make_gpipe_schedule(dist.get_world_size(stage_group),
                                 num_microbatches)
    return _pp_grads(params, tokens, labels, tables=tables,
                     stage_group=stage_group,
                     num_microbatches=num_microbatches, num_chunks=1,
                     recompute=False, **kw)


def grads_pp_1f1b(params: Params, tokens: torch.Tensor, labels: torch.Tensor,
                  *, num_microbatches: int, num_chunks: int, stage_group,
                  **kw):
    """Interleaved-1F1B training (≙ the reference's ``grads_pp_1f1b``,
    params in :func:`stack_block_params_chunked`'s layout): forward and
    backward chunk-works interleaved by :func:`..ops.pipeline.
    make_1f1b_schedule`, each backward recomputing its chunk from the
    saved input; :func:`_pp_grads`'s contract."""
    from ..ops.pipeline import make_1f1b_schedule
    tables = make_1f1b_schedule(dist.get_world_size(stage_group),
                                num_chunks, num_microbatches)
    return _pp_grads(params, tokens, labels, tables=tables,
                     stage_group=stage_group,
                     num_microbatches=num_microbatches,
                     num_chunks=num_chunks, recompute=True, **kw)


def apply_pp(params: Params, tokens: torch.Tensor, *, num_microbatches: int,
             stage_group, **kw) -> torch.Tensor:
    """GPipe's forward (≙ the reference's ``apply_pp``, eval): logits
    on every stage (:func:`_pp_forward`)."""
    from ..ops.pipeline import make_gpipe_schedule
    tables = make_gpipe_schedule(dist.get_world_size(stage_group),
                                 num_microbatches, forward_only=True)
    return _pp_forward(params, tokens, tables=tables,
                       stage_group=stage_group,
                       num_microbatches=num_microbatches, num_chunks=1,
                       **kw)


def apply_pp_1f1b(params: Params, tokens: torch.Tensor, *,
                  num_microbatches: int, num_chunks: int, stage_group,
                  **kw) -> torch.Tensor:
    """The chunked ring's forward (≙ the reference's ``apply_pp_1f1b``,
    eval under ``1f1b``): the forward-only schedule of the same chunk
    placement."""
    from ..ops.pipeline import make_1f1b_schedule
    tables = make_1f1b_schedule(dist.get_world_size(stage_group),
                                num_chunks, num_microbatches,
                                forward_only=True)
    return _pp_forward(params, tokens, tables=tables,
                       stage_group=stage_group,
                       num_microbatches=num_microbatches,
                       num_chunks=num_chunks, **kw)
