"""Model registry (≙ ``distributedmnist_tpu/models/registry.py``): the
``mnist_cnn`` entry (train-mode apply with dropout, loss, accuracy,
classification eval sums and the softmax ``predictions`` export) and
the ``resnet20`` entry (CIFAR-10 ResNet-20: the CNN's loss, accuracy
and eval sums, no dropout and, as in the reference, no ``predictions``)
and the ``transformer`` entry (the same for a causal LM — its
``predictions`` is the next-token distribution — plus the decode
exports the serving replica builds on; a mixture-of-experts
transformer has none, as in the reference).

The transformer entry carries its partition-rule table (≙ the
reference's ``transformer_partition_rules``; ``parallel/
partition_rules.py`` maps it) and its ``sharded_apply_factory`` (≙
``registry.py:369-438``, with ``make_seq_attn``): the apply of the
DP×TP×SP×EP train step, on one rank's shard of the params and one block
of the sequence. The CNN and ResNet-20 have neither, so they refuse the
model, seq and expert axes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..core import prng
from ..core.config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype a config dtype string names."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; valid: "
                         f"{', '.join(_DTYPES)}") from None


def lm_last_logits(logits: torch.Tensor) -> torch.Tensor:
    """Last-position logits [batch, vocab] of a [batch, seq, vocab]
    causal-LM forward."""
    return logits[:, -1]


def lm_predictions(logits: torch.Tensor) -> torch.Tensor:
    """Next-token distribution [batch, vocab] of a causal LM: softmax
    over the last position's logits — the one-shot inference export."""
    return torch.softmax(lm_last_logits(logits).float(), dim=-1)


def sample_token(logits: torch.Tensor, key=None,
                 temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """Sample next-token ids [...] (int64) from logits [..., vocab], as
    the reference's ``sample_token`` does.

    ``temperature <= 0`` is greedy argmax — deterministic, no key
    needed. ``temperature > 0`` divides the float32 logits and draws
    ``categorical`` with ``key`` (a ``uint32[2]`` key of
    :mod:`..core.prng`): the argmax of the scaled logits plus Gumbel
    noise from the key's bits, the reference's draw on the same key;
    ``top_k > 0`` first masks everything below the k-th highest logit
    with ``-1e30``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    if key is None:
        raise ValueError("sample_token with temperature > 0 needs a "
                         "PRNG key")
    scaled = logits.float() / temperature
    if top_k and top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = scaled.masked_fill(scaled < kth, -1e30)
    return prng.categorical(key, scaled, axis=-1)


def classification_eval_metrics(logits: torch.Tensor, labels: torch.Tensor,
                                weight: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Weighted eval sums for a [batch, classes] classifier:
    ``(correct_sum, loss_sum, weight_sum)``; pad rows carry weight 0."""
    w = weight.float()
    correct = (torch.argmax(logits, dim=-1) == labels.long()).float()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    return (correct * w).sum(), (nll * w).sum(), w.sum()


def lm_eval_metrics(logits: torch.Tensor, labels: torch.Tensor,
                    weight: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Token-level eval sums for a [batch, seq, vocab] causal LM
    (``weight`` is per sequence; counts are per predicted token):
    ``(correct_sum, loss_sum, weight_sum)``."""
    w = weight.float()[:, None]
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = labels[:, 1:].long()
    correct = (torch.argmax(logp, dim=-1) == tgt).float()
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    return ((correct * w).sum(), (nll * w).sum(),
            (w * torch.ones_like(correct)).sum())


@dataclasses.dataclass(frozen=True)
class Model:
    """A model family instance.

    * ``init(key_or_generator) -> params`` — the CNN and ResNet-20 take
      a ``uint32[2]`` key (and a ``device``), the transformer a torch
      generator; ``init_params(seed, device)`` is the one spelling the
      train state uses (``model.init_seed``), and on the ``meta`` device
      gives the param shapes without data;
    * ``apply(params, inputs, *, train=False, dropout_keep=None) ->
      logits`` with the keep mask drawn beforehand (the transformer has
      no dropout and ignores it; gradients flow when autograd is on);
    * ``dropout_masks(keys, rows, device)`` — the keep masks for
      ``rows`` examples a key (``[2]`` or ``[n, 2]``), None without
      dropout;
    * ``vmap_replicas`` — whether the train step runs the local replicas
      as one ``torch.func.vmap`` of ``grad`` (else one at a time through
      plain autograd: ``torch.utils.checkpoint`` does not run under
      ``torch.func``, so the transformer under ``model.remat`` loops);
    * ``loss(logits, labels) -> scalar``; ``accuracy(logits, labels)
      -> scalar``;
    * ``eval_metrics(logits, labels, weight) -> (correct_sum,
      loss_sum, weight_sum)``;
    * ``predictions(logits) -> [batch, classes]`` — the per-example
      distribution the serving replica answers with; ``input_shape``
      (no batch dim) and ``input_dtype`` (a numpy dtype name) describe
      one request's inputs;
    * ``decode_prefill(params, tokens [b, s]) -> (logits [b, s, V],
      k [L, b, s, h, hd], v [L, b, s, h, hd])`` through the configured
      attention (``attention_impl``);
    * ``decode_step(params, tokens, positions, k_cache, v_cache,
      block_tables, lengths, *, block_size, attention_kernel)`` — one
      token per slot over the paged cache;
    * ``decode_cache_shape = (num_layers, num_heads, head_dim)``;
    * ``partition_rules(axes) -> [(regex, spec)]`` — the table
      :func:`..parallel.partition_rules.match_partition_rules` maps over
      the params (:class:`..parallel.partition_rules.RuleAxes` binds the
      active axes);
    * ``sharded_apply_factory(seq_group, model_group, stats=None,
      expert_group=None, expert_model_group=None) -> apply(params,
      tokens, positions, return_aux=False)`` — the tensor-, sequence-
      and expert-parallel apply, its collectives counted in ``stats`` (a
      :class:`..core.mesh.CommStats`; None: the model supports none);
    * ``has_aux`` — ``apply(..., return_aux=True)`` returns ``(logits,
      aux)`` and the train step adds ``aux_weight · aux`` to the loss
      (the MoE load-balance loss).
    """

    name: str
    init: Callable[..., Any]
    init_params: Callable[[int, torch.device], Any]
    apply: Callable[..., torch.Tensor]
    compute_dtype: torch.dtype
    dropout_masks: Callable[..., torch.Tensor] | None = None
    vmap_replicas: bool = False
    loss: Callable[..., torch.Tensor] | None = None
    accuracy: Callable[..., torch.Tensor] | None = None
    eval_metrics: Callable[..., tuple] | None = None
    predictions: Callable[[torch.Tensor], torch.Tensor] | None = None
    input_shape: tuple[int, ...] = ()
    input_dtype: str = "float32"
    decode_prefill: Callable[..., tuple] | None = None
    decode_step: Callable[..., tuple] | None = None
    decode_cache_shape: tuple[int, int, int] | None = None
    partition_rules: Callable[[Any], list] | None = None
    sharded_apply_factory: Callable[..., Callable] | None = None
    has_aux: bool = False
    aux_weight: float = 0.0


def transformer_partition_rules(num_experts: int) -> Callable[[Any], list]:
    """The transformer's table (≙ the reference's): Megatron TP on the
    model axis — ``wqkv [d, 3, d]`` and ``w1`` split on their last
    (output) dim, ``wo`` and ``w2`` on their first (input) dim — the
    experts of a mixture-of-experts block (``w1 [E, d, ff]``, ``w2 [E,
    ff, d]``) on their first dim over the expert axis and their hidden
    dim over the model axis, the router, embeddings and norms
    replicated. The stacked (pipeline) layout's entries are the
    reference's too; the port does not build that layout yet (Queue A
    item 8c), so they are not reached."""
    def rules(axes) -> list:
        m, e, st = axes.model, axes.expert, axes.stage
        out: list = []
        if st is not None:
            out += [(r"blocks/wqkv$", (st, None, None, m)),
                    (r"blocks/wo$", (st, m, None)),
                    (r"blocks/(ln1|ln2)/scale$", (st,))]
            if num_experts > 0:
                out += [(r"blocks/router$", (st,)),
                        (r"blocks/w1$", (st, e, None, m)),
                        (r"blocks/w2$", (st, e, m, None))]
            else:
                out += [(r"blocks/w1$", (st, None, m)),
                        (r"blocks/w2$", (st, m, None))]
        else:
            out += [(r"blocks/\d+/wqkv$", (None, None, m)),
                    (r"blocks/\d+/wo$", (m, None))]
            if num_experts > 0:
                out += [(r"blocks/\d+/router$", ()),
                        (r"blocks/\d+/w1$", (e, None, m)),
                        (r"blocks/\d+/w2$", (e, m, None))]
            else:
                out += [(r"blocks/\d+/w1$", (None, m)),
                        (r"blocks/\d+/w2$", (m, None))]
        # embeddings and norms replicated in every layout
        out += [(r"(^|/)(ln1|ln2|final_norm)/scale$", ()),
                (r"^(embed|pos)$", ())]
        return out
    return rules


def get_model(cfg: ModelConfig) -> Model:
    if cfg.name == "mnist_cnn":
        return _mnist_cnn(cfg)
    if cfg.name == "resnet20":
        return _resnet20(cfg)
    if cfg.name == "transformer":
        return _transformer(cfg)
    raise NotImplementedError(
        f"model {cfg.name!r} is not ported yet (the port has the "
        "'mnist_cnn', 'resnet20' and 'transformer' families)")


def _mnist_cnn(cfg: ModelConfig) -> Model:
    from . import cnn
    compute_dtype = torch_dtype(cfg.compute_dtype)

    def init(key, device=None):
        return cnn.init(key, image_size=cfg.image_size,
                        num_channels=cfg.num_channels,
                        num_classes=cfg.num_classes, device=device)

    def apply(params, x, *, train=False, dropout_keep=None):
        return cnn.apply(params, x, train=train, dropout_keep=dropout_keep,
                         dropout_rate=cfg.dropout_rate,
                         compute_dtype=compute_dtype)

    def dropout_masks(keys, rows, device):
        return cnn.dropout_mask(keys, (rows, cnn.HIDDEN), cfg.dropout_rate,
                                device)

    return Model(name=cfg.name, init=init,
                 init_params=lambda seed, device: init(prng.PRNGKey(seed),
                                                       device),
                 apply=apply, compute_dtype=compute_dtype,
                 dropout_masks=(dropout_masks if cfg.dropout_rate > 0.0
                                else None),
                 vmap_replicas=True,
                 loss=cnn.loss_fn,
                 accuracy=cnn.accuracy,
                 eval_metrics=classification_eval_metrics,
                 predictions=cnn.predictions,
                 input_shape=(cfg.image_size, cfg.image_size,
                              cfg.num_channels))


def _resnet20(cfg: ModelConfig) -> Model:
    from . import cnn, resnet
    compute_dtype = torch_dtype(cfg.compute_dtype)

    def init(key, device=None):
        return resnet.init(key, num_classes=cfg.num_classes,
                           num_channels=cfg.num_channels, device=device)

    def apply(params, x, *, train=False, dropout_keep=None):
        del dropout_keep  # resnet20 has no dropout
        return resnet.apply(params, x, train=train,
                            compute_dtype=compute_dtype)

    return Model(name=cfg.name, init=init,
                 init_params=lambda seed, device: init(prng.PRNGKey(seed),
                                                       device),
                 apply=apply, compute_dtype=compute_dtype,
                 vmap_replicas=True,
                 loss=cnn.loss_fn, accuracy=cnn.accuracy,
                 eval_metrics=classification_eval_metrics,
                 input_shape=(cfg.image_size, cfg.image_size,
                              cfg.num_channels))


def _transformer(cfg: ModelConfig) -> Model:
    from . import transformer
    from ..ops.flash_attention import (flash_attention_bshd,
                                       flash_attention_bshd_plain)

    moe = cfg.num_experts > 0
    compute_dtype = torch_dtype(cfg.compute_dtype)
    if cfg.attention_impl == "flash":
        attention_fn = flash_attention_bshd
        # Ulysses' full-sequence attention, in the model's bshd layout
        inner_bshd = flash_attention_bshd
    elif cfg.attention_impl == "dense":
        attention_fn = None  # transformer defaults to local_self_attention
        inner_bshd = flash_attention_bshd_plain  # dense, bshd
    else:
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")
    if (cfg.remat and cfg.remat_policy == "save_attn"
            and cfg.attention_impl != "flash"):
        # save_attn keeps the attention sublayer's residuals resident;
        # only the flash Function bounds those at O(s·d) — dense
        # attention would keep the [b, h, s, s] probabilities a layer
        raise ValueError(
            "model.remat_policy='save_attn' requires "
            "attention_impl='flash' (dense attention has no fused VJP; "
            "its resident residuals would be O(seq²) per layer)")

    def init(generator, device=None):
        return transformer.init(
            generator, vocab_size=cfg.vocab_size, model_dim=cfg.model_dim,
            num_heads=cfg.num_heads, num_layers=cfg.num_layers,
            max_seq_len=cfg.seq_len, device=device,
            num_experts=cfg.num_experts)

    def moe_groups(expert_group=None, reduce_group=None, stats_group=None):
        if not moe:
            return None
        return transformer.MoeGroups(
            num_experts=cfg.num_experts,
            capacity_factor=cfg.expert_capacity_factor,
            router_top_k=cfg.moe_router_top_k,
            num_groups=cfg.moe_num_groups, expert_group=expert_group,
            reduce_group=reduce_group, stats_group=stats_group)

    local_moe = moe_groups()

    def apply(params, tokens, positions=None, *, train=False,
              dropout_keep=None, return_aux=False):
        del train, dropout_keep  # the reference's has no dropout
        return transformer.apply(params, tokens, num_heads=cfg.num_heads,
                                 attention_fn=attention_fn,
                                 positions=positions,
                                 compute_dtype=compute_dtype,
                                 remat=cfg.remat,
                                 remat_policy=cfg.remat_policy,
                                 moe=local_moe, return_aux=return_aux)

    def decode_prefill(params, tokens, positions=None):
        return transformer.prefill_with_kv(
            params, tokens, num_heads=cfg.num_heads,
            attention_fn=attention_fn, positions=positions,
            compute_dtype=compute_dtype)

    def decode_step(params, tokens, positions, k_cache, v_cache,
                    block_tables, lengths, *, block_size,
                    attention_kernel="dense"):
        return transformer.decode_step(
            params, tokens, positions, k_cache, v_cache, block_tables,
            lengths, num_heads=cfg.num_heads, block_size=block_size,
            compute_dtype=compute_dtype, attention_kernel=attention_kernel)

    def make_seq_attn(seq_group, stats=None):
        """The attention for a sequence split over ``seq_group``: the
        configured one when unsplit, else ring or Ulysses over the
        group."""
        if seq_group is None:
            return attention_fn  # flash or dense, per attention_impl
        if cfg.sp_attention == "ring":
            from ..ops.ring_attention import ring_self_attention

            def sharded_attn(q, k, v, causal=True, scale=None):
                return ring_self_attention(q, k, v, seq_group,
                                           causal=causal, scale=scale,
                                           stats=stats)
            return sharded_attn
        if cfg.sp_attention == "ulysses":
            from ..ops.ulysses_attention import ulysses_self_attention

            def sharded_attn(q, k, v, causal=True, scale=None):
                return ulysses_self_attention(q, k, v, seq_group,
                                              causal=causal, scale=scale,
                                              attention_fn=inner_bshd,
                                              stats=stats)
            sharded_attn.layout = "bshd"
            return sharded_attn
        raise ValueError(f"unknown sp_attention {cfg.sp_attention!r}")

    def sharded_apply_factory(seq_group, model_group, stats=None,
                              expert_group=None, expert_model_group=None):
        """The apply of the DP×SP×TP×EP train step: tokens arrive as this
        process's ``[b, seq_local]`` block with their global positions;
        attention crosses the blocks by the configured strategy; the
        params may be this rank's tensor- and expert-parallel shard.
        Under SP×MoE routing runs on each block with block-local
        capacity while the load statistics average over the seq group,
        so the aux loss is the full-token value on every block."""
        if expert_group is not None and not moe:
            raise ValueError("mesh has expert parallelism but the model has "
                             "no experts (model.num_experts == 0)")
        sharded_attn = make_seq_attn(seq_group, stats)
        if (cfg.remat and cfg.remat_policy == "save_attn"
                and seq_group is not None and cfg.sp_attention == "ring"):
            # save_attn keeps the attention sublayer outside the
            # checkpoint so the flash Function's O(s·d) residuals stay;
            # the ring has no fused backward — autograd would keep every
            # ring step's scores instead, what remat exists to avoid
            raise ValueError(
                "model.remat_policy='save_attn' requires an attention "
                "with a fused VJP (flash / Ulysses-over-flash); ring "
                "attention under sequence parallelism needs "
                "remat_policy='full'")

        groups = moe_groups(expert_group, expert_model_group, seq_group)

        def apply_sharded(params, tokens, positions, return_aux=False):
            return transformer.apply(params, tokens, num_heads=cfg.num_heads,
                                     attention_fn=sharded_attn,
                                     positions=positions,
                                     compute_dtype=compute_dtype,
                                     remat=cfg.remat,
                                     remat_policy=cfg.remat_policy,
                                     model_group=model_group, stats=stats,
                                     moe=groups, return_aux=return_aux)
        return apply_sharded

    def init_params(seed, device):
        # a torch generator: other numbers than the reference's JAX key
        # (the meta device, which has none, takes the shapes alone)
        device = torch.device(device)
        if device.type == "meta":
            return init(torch.Generator(), device)
        return init(torch.Generator(device=device).manual_seed(seed))

    # decode exports: dense-FFN causal LMs only (MoE routing works on
    # token groups; a one-token step has no group to route)
    decode = {} if moe else dict(
        decode_prefill=decode_prefill, decode_step=decode_step,
        decode_cache_shape=(cfg.num_layers, cfg.num_heads,
                            cfg.model_dim // cfg.num_heads))
    return Model(name=cfg.name, init=init, init_params=init_params,
                 apply=apply, compute_dtype=compute_dtype,
                 vmap_replicas=not cfg.remat,
                 loss=transformer.loss_fn,
                 accuracy=transformer.accuracy,
                 eval_metrics=lm_eval_metrics,
                 predictions=lm_predictions,
                 input_shape=(cfg.seq_len,), input_dtype="int32",
                 partition_rules=transformer_partition_rules(
                     cfg.num_experts),
                 sharded_apply_factory=sharded_apply_factory,
                 has_aux=moe, aux_weight=cfg.moe_aux_weight, **decode)
