"""Paged KV cache for continuous-batching decode (≙
``distributedmnist_tpu/servesvc/kv_cache.py``).

K/V for every in-flight sequence live in ONE pair of device tensors
shaped ``[layers, num_blocks, block_size, heads, head_dim]``, carved
into fixed-size blocks that a free-list allocator hands out. Each
sequence owns a fixed-width **block table** mapping its positions to
blocks, so one decode step reads any mix of sequence lengths, and a
finished sequence returns its blocks the same step its neighbours keep
generating.

Block 0 is the **reserved null block**: idle decode slots point their
whole table (and their writes) at it, so the fixed-shape step never
branches — garbage lands in a block no sequence owns.

Admission reserves every block a sequence can need (prompt +
max_new_tokens) up front: block pressure defers admission, it never
kills a running generation.
"""

from __future__ import annotations

import numpy as np
import torch

NULL_BLOCK = 0


class BlockAllocator:
    """Free-list allocator over ``num_blocks`` fixed-size blocks.

    Block 0 (:data:`NULL_BLOCK`) is reserved and never handed out.
    ``alloc`` is all-or-nothing: a request the pool cannot satisfy
    returns None and takes nothing."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (one is the reserved null block), "
                f"got {num_blocks}")
        self.num_blocks = num_blocks
        # LIFO free list: recently freed blocks are reused first
        self._free: list[int] = list(range(num_blocks - 1, 0, -1))
        self._in_use: set[int] = set()

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> frozenset[int]:
        return frozenset(self._in_use)

    def alloc(self, n: int) -> tuple[int, ...] | None:
        """n blocks, or None (and no change) when the pool is short."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            return None
        got = tuple(self._free.pop() for _ in range(n))
        self._in_use.update(got)
        return got

    def free(self, blocks) -> None:
        for b in blocks:
            if b not in self._in_use:
                raise ValueError(
                    f"double free / foreign block {b} (in_use="
                    f"{sorted(self._in_use)})")
            self._in_use.remove(b)
            self._free.append(b)


def write_prompt_kv(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    ks: torch.Tensor, vs: torch.Tensor,
                    block_table: torch.Tensor, length: int, *,
                    block_size: int) -> None:
    """Scatter one sequence's prefill K/V into its blocks, in place.

    ``ks``/``vs`` [L, s_pad, h, hd] (one sequence, padded to its prompt
    bucket); positions ``< length`` land at ``block_table[pos //
    block_size]`` offset ``pos % block_size``, padding positions go to
    the null block."""
    s_pad = ks.shape[1]
    pos = torch.arange(s_pad, device=k_cache.device)
    table = block_table.to(k_cache.device).long()
    blk_ids = torch.where(pos < length, table[pos // block_size],
                          torch.full_like(pos, NULL_BLOCK))
    offs = pos % block_size
    k_cache[:, blk_ids, offs] = ks.to(k_cache.dtype)
    v_cache[:, blk_ids, offs] = vs.to(v_cache.dtype)


class PagedKVCache:
    """The device tensors + allocator + block-table bookkeeping.
    Single writer: the decode loop's thread."""

    def __init__(self, num_layers: int, num_blocks: int, block_size: int,
                 num_heads: int, head_dim: int, max_blocks_per_seq: int,
                 *, device: torch.device | str,
                 dtype: torch.dtype = torch.float32):
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        self.allocator = BlockAllocator(num_blocks)
        shape = (num_layers, num_blocks, block_size, num_heads, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)

    def alloc_sequence(self, total_len: int) -> np.ndarray | None:
        """Reserve blocks for up to ``total_len`` tokens; returns the
        fixed-width block table (padded with the null block) or None
        under block pressure (nothing taken)."""
        need = -(-total_len // self.block_size)
        if need > self.max_blocks_per_seq:
            raise ValueError(
                f"{total_len} tokens need {need} blocks > "
                f"max_blocks_per_seq={self.max_blocks_per_seq}")
        got = self.allocator.alloc(need)
        if got is None:
            return None
        table = np.full((self.max_blocks_per_seq,), NULL_BLOCK,
                        dtype=np.int32)
        table[:need] = got
        return table

    def free_sequence(self, block_table: np.ndarray) -> None:
        self.allocator.free(int(b) for b in block_table
                            if int(b) != NULL_BLOCK)

    def write_prompt(self, block_table: np.ndarray, ks: torch.Tensor,
                     vs: torch.Tensor, length: int) -> None:
        """Install one sequence's prefill K/V (``[L, s_pad, h, hd]``)."""
        write_prompt_kv(self.k, self.v, ks, vs,
                        torch.from_numpy(block_table), length,
                        block_size=self.block_size)

    def gather_dense(self, block_table: np.ndarray,
                     length: int) -> tuple[np.ndarray, np.ndarray]:
        """Read a sequence back as dense ``[L, length, h, hd]`` float32
        arrays — the view tests compare against (host path, never used
        by the decode step)."""
        pos = np.arange(length)
        blk = torch.as_tensor(block_table[pos // self.block_size]).long()
        off = torch.as_tensor(pos % self.block_size).long()
        k = self.k[:, blk.to(self.k.device), off.to(self.k.device)]
        v = self.v[:, blk.to(self.v.device), off.to(self.v.device)]
        return k.float().cpu().numpy(), v.float().cpu().numpy()
