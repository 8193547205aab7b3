"""Batching (≙ ``distributedmnist_tpu/data/pipeline.py``): the seeded,
epoch-reshuffling train stream with a resumable cursor, the gradient
accumulation feed, fixed-order weight-padded eval batches, and the hop
of a host batch onto the card.

Two shuffles, as in the reference, and each is bitwise the reference's
for the same seed, so a cursor saved by either package resumes the same
stream in the other:

* :class:`BatchIterator` — the reference's numpy code;
* :class:`NativeOrderIterator` — the permutation of the reference's C++
  prefetcher (``native/dml_native.cc``: a splitmix64-seeded
  Fisher-Yates an epoch), which the reference batches in wherever it
  runs that prefetcher (``data.use_native_pipeline`` on a host with a
  spare core). The port draws it in numpy and Python, inline: the
  prefetch thread itself is not ported, nor the device-side one.
  Batches are copied to the card from pinned memory (:func:`to_device`).
"""

from __future__ import annotations

from typing import Iterator

import os

import numpy as np
import torch

from ..core.config import DataConfig
from .datasets import ArrayDataset

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9e3779b97f4a7c15


class BatchIterator:
    """Infinite epoch-reshuffling batch stream over an ArrayDataset.

    Yields numpy dicts {"image": [b, ...], "label": [b, ...]} where
    ``b`` is the host-local batch (global batch / num_hosts)."""

    def __init__(self, data: ArrayDataset, batch_size: int, seed: int,
                 host_id: int = 0, num_hosts: int = 1,
                 shard_mode: str = "sharded"):
        if batch_size % num_hosts != 0:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{num_hosts} hosts")
        self.local_batch = batch_size // num_hosts
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.global_batch = batch_size
        if shard_mode == "sharded":
            self.data = data.shard(host_id, num_hosts) if num_hosts > 1 else data
            self.seed = seed  # same shuffle stream, disjoint data
        elif shard_mode == "independent":
            self.data = data  # full copy per host, host-distinct stream
            self.seed = seed * 1_000_003 + host_id
        else:
            raise ValueError(f"unknown shard_mode {shard_mode!r}")
        if self.data.num_examples < self.local_batch:
            raise ValueError(
                f"host-local dataset ({self.data.num_examples}) smaller than "
                f"host-local batch ({self.local_batch})")
        self._epoch = 0
        self._pos = 0
        self._order = self._epoch_order(0)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(self.data.num_examples)

    @property
    def epoch(self) -> int:
        return self._epoch

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        if self._pos + self.local_batch > self.data.num_examples:
            # drop the ragged tail and reshuffle
            self._epoch += 1
            self._order = self._epoch_order(self._epoch)
            self._pos = 0
        idx = self._order[self._pos:self._pos + self.local_batch]
        self._pos += self.local_batch
        return {"image": self.data.images[idx], "label": self.data.labels[idx]}

    @property
    def batches_per_epoch(self) -> int:
        return self.data.num_examples // self.local_batch

    @property
    def batches_consumed(self) -> int:
        """Lockstep global-batch count: the world-size-independent
        coordinate of the cursor."""
        return (self._epoch * self.batches_per_epoch
                + self._pos // self.local_batch)

    def state(self) -> dict:
        """Checkpointable position, in the reference's layout."""
        return {"impl": "numpy", "epoch": self._epoch, "pos": self._pos,
                "batches": self.batches_consumed,
                "world": {"num_hosts": self.num_hosts,
                          "host_id": self.host_id,
                          "batch_size": self.global_batch}}

    def seek_batches(self, batches: int) -> None:
        """Position the stream exactly ``batches`` global batches in."""
        if batches < 0:
            raise ValueError(f"batches must be >= 0, got {batches}")
        bpe = self.batches_per_epoch
        self._epoch = batches // bpe
        self._order = self._epoch_order(self._epoch)
        self._pos = (batches % bpe) * self.local_batch

    def restore(self, state: dict) -> None:
        impl = state.get("impl", "numpy")
        if impl != "numpy":
            raise ValueError(
                f"data-iterator state was produced by the {impl!r} pipeline; "
                "restoring it into the numpy shuffle stream would replay a "
                "different permutation")
        world = state.get("world")
        if world is not None and (
                world.get("num_hosts") != self.num_hosts
                or world.get("host_id") != self.host_id
                or world.get("batch_size") != self.global_batch):
            # a cursor from another world indexes another shard's
            # permutation: reassign through the lockstep coordinate
            batches = state.get("batches")
            if batches is None:
                raise ValueError(
                    f"data-iterator state from world {world} has no "
                    "'batches' coordinate; cannot reassign it")
            self.seek_batches(int(batches))
            return
        self._epoch = int(state["epoch"])
        self._order = self._epoch_order(self._epoch)
        self._pos = int(state["pos"])


class GradAccumFeed:
    """The feed of gradient accumulation (``train.grad_accum_steps``):
    each ``next()`` pulls ``accum`` consecutive batches of the inner
    stream and concatenates them along dim 0 — the train step splits
    each replica's rows of that into ``accum`` microbatches and applies
    the optimizer once. The inner cursor just advances ``accum`` batches
    a step, so ``state()`` / ``restore()`` (passed through) keep the
    reference's lockstep ``batches`` coordinate."""

    def __init__(self, inner: BatchIterator, accum: int):
        if accum < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got {accum}")
        self.inner = inner
        self.accum = accum

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        batches = [next(self.inner) for _ in range(self.accum)]
        if self.accum == 1:
            return batches[0]
        return {k: np.concatenate([b[k] for b in batches])
                for k in batches[0]}

    def state(self) -> dict:
        return self.inner.state()

    def restore(self, state: dict) -> None:
        self.inner.restore(state)


def eval_batches(data: ArrayDataset, batch_size: int, pad_multiple: int = 1,
                 host_id: int = 0, num_hosts: int = 1) -> Iterator[dict]:
    """Fixed-order eval batches with 0/1 weights, zero-padded to full
    size (so every batch has one shape)."""
    global_n = data.num_examples
    if batch_size <= 0:
        batch_size = global_n
    if batch_size % num_hosts != 0:
        batch_size += num_hosts - batch_size % num_hosts
    local_bs = batch_size // num_hosts
    if local_bs % pad_multiple != 0:
        local_bs += pad_multiple - local_bs % pad_multiple
    stripe = data.shard(host_id, num_hosts) if num_hosts > 1 else data
    max_stripe = -(-global_n // num_hosts)
    num_batches = max(1, -(-max_stripe // local_bs))
    for b in range(num_batches):
        start = b * local_bs
        stop = min(start + local_bs, stripe.num_examples)
        take = max(stop - start, 0)
        x = stripe.images[start:start + take]
        y = stripe.labels[start:start + take]
        w = np.ones(take, np.float32)
        pad = local_bs - take
        if pad:
            x = np.concatenate([x, np.zeros((pad,) + data.images.shape[1:],
                                            data.images.dtype)])
            y = np.concatenate([y, np.zeros((pad,) + data.labels.shape[1:],
                                            data.labels.dtype)])
            w = np.concatenate([w, np.zeros(pad, np.float32)])
        yield {"image": x, "label": y, "weight": w}


def _splitmix64(states: np.ndarray) -> np.ndarray:
    """splitmix64's output mix of each (already advanced) uint64 state
    (≙ ``dml_native.cc:34-39``; numpy's uint64 arrays wrap as C++'s
    ``uint64_t`` does)."""
    z = states
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xbf58476d1ce4e5b9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94d049bb133111eb)
    return z ^ (z >> np.uint64(31))


def native_permutation(seed: int, epoch: int, n: int) -> np.ndarray:
    """The C++ loader's ``shuffle_for(epoch)`` over ``n`` rows
    (≙ ``dml_native.cc:78-89``): state ``seed ^ (golden · (epoch+1))``,
    one draw discarded, then Fisher-Yates from ``n-1`` down with ``j =
    draw % (i+1)``. Draw ``t`` (from 1) mixes the state ``s0 + (t+1) ·
    golden``, so every draw is made in one vectorised pass; only the
    swaps run in a Python loop."""
    s0 = (int(seed) & _MASK64) ^ ((_GOLDEN * (epoch + 1)) & _MASK64)
    order = list(range(n))
    if n < 2:
        return np.asarray(order, np.int64)
    steps = np.arange(2, n + 1, dtype=np.uint64)
    draws = _splitmix64(np.uint64(s0) + steps * np.uint64(_GOLDEN))
    bounds = np.arange(n, 1, -1, dtype=np.uint64)  # i + 1
    js = (draws % bounds).tolist()
    for i, j in zip(range(n - 1, 0, -1), js):
        order[i], order[j] = order[j], order[i]
    return np.asarray(order, np.int64)


class NativeOrderIterator(BatchIterator):
    """The stream the reference's ``NativePrefetcher`` yields (≙
    ``data/native_loader.py:55-115``), drawn inline: the host's own rows
    (its shard) in :func:`native_permutation` order for the iterator's
    ``seed``, the first permutation at epoch 0, the ragged tail dropped
    and a reshuffle at ``epoch + 1`` (``dml_native.cc:92-97,213``). Its
    cursor is the loader's, ``{"impl": "native", "epoch", "pos"}``;
    restoring the numpy stream's cursor raises, as the loader's does."""

    def _epoch_order(self, epoch: int) -> np.ndarray:
        return native_permutation(self.seed, epoch, self.data.num_examples)

    def state(self) -> dict:
        return {"impl": "native", "epoch": self._epoch, "pos": self._pos}

    def restore(self, state: dict) -> None:
        impl = state.get("impl", "numpy")
        if impl != "native":
            raise ValueError(
                f"data-iterator state was produced by the {impl!r} pipeline; "
                "restoring it into the native shuffle stream would replay a "
                "different permutation")
        self._epoch = max(int(state["epoch"]), 0)
        self._order = self._epoch_order(self._epoch)
        self._pos = min(max(int(state["pos"]), 0), self.data.num_examples)


def host_can_spare_producer_thread() -> bool:
    """The reference's gate for its prefetch thread (≙ ``data/
    pipeline.py:265-275``): a spare core."""
    return (os.cpu_count() or 1) >= 2


def make_train_iterator(data: ArrayDataset, cfg: DataConfig, seed: int,
                        host_id: int = 0, num_hosts: int = 1) -> BatchIterator:
    """The train stream, in the order the reference batches the same
    config in on this host (≙ ``data/pipeline.py:291-320``): with
    ``data.use_native_pipeline`` on a host with a spare core, its C++
    prefetcher's (:class:`NativeOrderIterator`); else its numpy
    iterator's."""
    cls = (NativeOrderIterator
           if cfg.use_native_pipeline and host_can_spare_producer_thread()
           else BatchIterator)
    return cls(data, cfg.batch_size, seed=seed, host_id=host_id,
               num_hosts=num_hosts, shard_mode=cfg.shard_mode)


def to_device(batch: dict, device: torch.device) -> dict:
    """A host batch as tensors on ``device``: on a CUDA device each
    array goes through a pinned host buffer and a non-blocking copy."""
    out = {}
    for key, a in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[key] = t
    return out
