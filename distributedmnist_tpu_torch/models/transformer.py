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
same on every rank of the group. Sequence parallelism needs nothing
here but the block's global ``positions`` and a sequence-parallel
``attention_fn`` (ring or Ulysses, ``models/registry.py
make_seq_attn``); :func:`sp_partial_token_loss` is its loss. Expert
parallelism: ``apply(moe=MoeGroups(...))`` runs each MoE FFN on this
rank's experts over the expert group (:func:`..ops.moe.moe_ffn`), the
block's other leaves whole (or tensor-parallel as above). Pipeline
parallelism is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import local_self_attention
from ..ops.collectives import copy_to_group, reduce_from_group
from ..ops.moe import moe_ffn
from ..ops.paged_attention import paged_attention, paged_attention_dense

Params = dict[str, Any]


def _trunc_normal(shape, stddev, generator, device) -> torch.Tensor:
    """N(0, stddev²) truncated to ±2σ, float32 (≙ the reference's
    ``truncated_normal_init``; a torch generator draws other numbers
    than a JAX key, so tests convert reference params instead)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
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
    m = 1 if model_group is None else dist.get_world_size(model_group)
    if num_heads % m != 0:
        raise ValueError(f"num_heads={num_heads} not divisible by "
                         f"model-parallel size {m}")
    p = cast_params(params, compute_dtype)
    x = _embed(p, tokens, positions)

    def attn_part(x, blk):
        return _attn_sublayer(x, blk, num_heads=num_heads, attn=attn,
                              model_group=model_group, stats=stats)

    def ffn_part(x, blk):
        if "router" in blk:
            return _moe_sublayer(x, blk, moe, model_group, stats)
        return _ffn_sublayer(x, blk, model_group, stats), x.new_zeros(
            (), dtype=torch.float32)

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
                    compute_dtype: torch.dtype = torch.bfloat16
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prompt prefill: the causal forward through the configured
    attention (the flash kernel when ``attention_impl="flash"``) that
    also returns every layer's K/V for seeding a decode cache.

    tokens [b, s] → (logits [b, s, vocab] float32, k [L, b, s, h, hd],
    v [L, b, s, h, hd]) with K/V in the compute dtype."""
    attn = attention_fn or local_self_attention
    p = cast_params(params, compute_dtype)
    x = _embed(p, tokens, positions)
    ks, vs = [], []
    for blk in p["blocks"]:
        x, k, v = _attn_sublayer(x, blk, num_heads=num_heads, attn=attn,
                                 return_kv=True)
        ks.append(k)
        vs.append(v)
        x = _ffn_sublayer(x, blk)
    return _head(x, p), torch.stack(ks), torch.stack(vs)


def decode_step(params: Params, tokens: torch.Tensor,
                positions: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, block_tables: torch.Tensor,
                lengths: torch.Tensor, *, num_heads: int = 4,
                block_size: int = 16,
                compute_dtype: torch.dtype = torch.bfloat16,
                attention_kernel: str = "dense"
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
        h = _rms_norm(x, blk["ln1"])
        qkv = (h @ blk["wqkv"].reshape(d, 3 * d)).view(num_slots, 3, d)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        k_cache[li].index_put_(
            (blk_ids, offs), k.reshape(num_slots, num_heads, hd).to(
                k_cache.dtype))
        v_cache[li].index_put_(
            (blk_ids, offs), v.reshape(num_slots, num_heads, hd).to(
                v_cache.dtype))
        o = attend(q.view(num_slots, num_heads, hd), k_cache[li],
                   v_cache[li], block_tables, lengths, scale=scale)
        x = x + o.to(compute_dtype).reshape(num_slots, d) @ blk["wo"]
        x = _ffn_sublayer(x, blk)
    return _head(x, p), k_cache, v_cache
