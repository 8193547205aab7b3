"""Model registry (≙ ``distributedmnist_tpu/models/registry.py``): the
``transformer`` entry — its train-mode apply, loss, accuracy and
token-level eval sums for the train step and the evaluator, and the
decode exports the serving replica builds on. The other families
(``mnist_cnn``, ``resnet20``) and the transformer's mixture-of-experts
FFNs raise "not ported yet".
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

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


def sample_token(logits: torch.Tensor,
                 generator: torch.Generator | None = None,
                 temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """Sample next-token ids [...] (int64) from logits [..., vocab].

    ``temperature <= 0`` is greedy argmax — deterministic, no generator
    needed, and bit-comparable with the reference. ``temperature > 0``
    divides the logits and draws from ``generator`` (the decode replica
    seeds one per sequence, where the reference folds a seed into a JAX
    key; the two draw different numbers from the same seed);
    ``top_k > 0`` first masks everything below the k-th highest
    logit."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    if generator is None:
        raise ValueError("sample_token with temperature > 0 needs a "
                         "torch.Generator")
    scaled = logits.float() / temperature
    if top_k and top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = scaled.masked_fill(scaled < kth, -1e30)
    probs = torch.softmax(scaled, dim=-1).reshape(-1, scaled.shape[-1])
    draw = torch.multinomial(probs.to(generator.device), 1,
                             generator=generator)
    return draw.reshape(logits.shape[:-1]).to(logits.device)


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

    * ``init(generator) -> params`` on the generator's device;
    * ``apply(params, tokens, *, train=False, positions=None) -> logits``
      (the transformer has no dropout, so ``train`` changes nothing;
      gradients flow when autograd is on);
    * ``loss(logits, labels) -> scalar``; ``accuracy(logits, labels)
      -> scalar``;
    * ``eval_metrics(logits, labels, weight) -> (correct_sum,
      loss_sum, weight_sum)``;
    * ``decode_prefill(params, tokens [b, s]) -> (logits [b, s, V],
      k [L, b, s, h, hd], v [L, b, s, h, hd])`` through the configured
      attention (``attention_impl``);
    * ``decode_step(params, tokens, positions, k_cache, v_cache,
      block_tables, lengths, *, block_size, attention_kernel)`` — one
      token per slot over the paged cache;
    * ``decode_cache_shape = (num_layers, num_heads, head_dim)``.
    """

    name: str
    init: Callable[[torch.Generator], Any]
    apply: Callable[..., torch.Tensor]
    compute_dtype: torch.dtype
    loss: Callable[..., torch.Tensor] | None = None
    accuracy: Callable[..., torch.Tensor] | None = None
    eval_metrics: Callable[..., tuple] | None = None
    decode_prefill: Callable[..., tuple] | None = None
    decode_step: Callable[..., tuple] | None = None
    decode_cache_shape: tuple[int, int, int] | None = None


def get_model(cfg: ModelConfig) -> Model:
    if cfg.name != "transformer":
        raise NotImplementedError(
            f"model {cfg.name!r} is not ported yet (the port has the "
            "'transformer' family only)")
    return _transformer(cfg)


def _transformer(cfg: ModelConfig) -> Model:
    from . import transformer
    from ..ops.flash_attention import flash_attention_bshd

    if cfg.num_experts > 0:
        raise NotImplementedError("mixture-of-experts FFNs "
                                  "(model.num_experts > 0) are not ported "
                                  "yet")
    compute_dtype = torch_dtype(cfg.compute_dtype)
    if cfg.attention_impl == "flash":
        attention_fn = flash_attention_bshd
    elif cfg.attention_impl == "dense":
        attention_fn = None  # transformer defaults to local_self_attention
    else:
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")

    def init(generator):
        return transformer.init(
            generator, vocab_size=cfg.vocab_size, model_dim=cfg.model_dim,
            num_heads=cfg.num_heads, num_layers=cfg.num_layers,
            max_seq_len=cfg.seq_len)

    def apply(params, tokens, positions=None, *, train=False):
        del train  # no dropout (the reference's transformer has none)
        return transformer.apply(params, tokens, num_heads=cfg.num_heads,
                                 attention_fn=attention_fn,
                                 positions=positions,
                                 compute_dtype=compute_dtype)

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

    return Model(name=cfg.name, init=init, apply=apply,
                 compute_dtype=compute_dtype, loss=transformer.loss_fn,
                 accuracy=transformer.accuracy,
                 eval_metrics=lm_eval_metrics,
                 decode_prefill=decode_prefill, decode_step=decode_step,
                 decode_cache_shape=(cfg.num_layers, cfg.num_heads,
                                     cfg.model_dim // cfg.num_heads))
