"""In-memory datasets (≙ ``distributedmnist_tpu/data/datasets.py``): the
split containers and the deterministic synthetic token sequences the
causal-LM training path reads.

``make_synthetic_lm`` is the reference's numpy code, so the same seed
gives bitwise the same tokens. The image datasets (``mnist``,
``fashion_mnist``, ``cifar10``, ``synthetic``) are not ported yet and
raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.config import DataConfig


@dataclasses.dataclass(frozen=True)
class ArrayDataset:
    """An in-memory split. For LM tasks: images [N, S] int32 token
    sequences, labels [N, S] (the same tokens — the loss shifts
    internally for next-token prediction). Image tasks keep images
    [N, H, W, C] float32 and labels [N] int32."""

    images: np.ndarray
    labels: np.ndarray

    def __post_init__(self):
        if self.images.ndim not in (2, 4) or self.labels.ndim not in (1, 2):
            raise ValueError(f"unexpected split shapes {self.images.shape}, "
                             f"{self.labels.shape}")
        if len(self.images) != len(self.labels):
            raise ValueError(f"{len(self.images)} inputs but "
                             f"{len(self.labels)} labels")

    @property
    def num_examples(self) -> int:
        return len(self.labels)

    def take(self, idx: np.ndarray) -> "ArrayDataset":
        return ArrayDataset(self.images[idx], self.labels[idx])

    def shard(self, shard_id: int, num_shards: int) -> "ArrayDataset":
        """Deterministic contiguous-strided shard."""
        return self.take(np.arange(shard_id, self.num_examples, num_shards))


@dataclasses.dataclass(frozen=True)
class Datasets:
    train: ArrayDataset
    validation: ArrayDataset
    test: ArrayDataset


def make_synthetic_lm(num_train: int, num_test: int, seq_len: int = 128,
                      vocab_size: int = 256, seed: int = 12345,
                      peak: float = 3.0) -> Datasets:
    """Deterministic learnable token sequences: a fixed random
    first-order Markov chain with peaked transitions. A causal LM that
    learns the transition table drives next-token loss well below the
    unigram entropy — the convergence oracle for the sequence path."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((vocab_size, vocab_size)) * peak
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    cdf = np.cumsum(probs, axis=1)

    def sample(n: int) -> ArrayDataset:
        seqs = np.empty((n, seq_len), np.int32)
        seqs[:, 0] = rng.integers(0, vocab_size, n)
        for t in range(1, seq_len):
            u = rng.random(n)[:, None]
            seqs[:, t] = (cdf[seqs[:, t - 1]] < u).sum(axis=1)
        return ArrayDataset(seqs, seqs.copy())

    return Datasets(train=sample(num_train),
                    validation=sample(max(num_test // 2, 64)),
                    test=sample(num_test))


def load_datasets(cfg: DataConfig, image_size: int = 28, num_channels: int = 1,
                  num_classes: int = 10, seq_len: int = 128,
                  vocab_size: int = 256) -> Datasets:
    """The configured dataset; only ``synthetic_lm`` is ported."""
    del image_size, num_channels, num_classes  # the image datasets
    if cfg.dataset == "synthetic_lm":
        return make_synthetic_lm(cfg.synthetic_train_size,
                                 cfg.synthetic_test_size, seq_len,
                                 vocab_size)
    raise NotImplementedError(
        f"dataset {cfg.dataset!r} is not ported yet (the port has "
        "'synthetic_lm' only)")
