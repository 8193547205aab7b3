"""Single-query paged attention (≙ ``distributedmnist_tpu/ops/
pallas_paged_attention.py``): kernel K5.

The decode step's attention read. Every slot's newest query attends to
its whole context, which lives in a paged KV cache
(:mod:`..servesvc.kv_cache`: one layer is ``[num_blocks, block_size,
heads, head_dim]``) and is found through the slot's block table. On a
CUDA tensor :func:`paged_attention` launches the hand-written kernel
``csrc/paged_attention.cu``, which splits each slot's table over a
thread-block cluster whose blocks load their live pages with the TMA,
all at once, and merge their partial softmax states in a fixed order;
on a CPU tensor it runs the plain version :func:`paged_attention_dense`,
the full-table gather. There is no fallback between the two: a CUDA call
the kernel cannot take raises.

Numerics (shared by both versions): scores and softmax in float32,
scale ``1/sqrt(head_dim)`` unless given, positions at or past ``length``
masked, output float32. An idle slot (``length == 0``) returns exact
zeros in BOTH versions — the TPU kernel's contract; the reference's
dense gather softmaxes such a row into garbage instead, which the
decode loop never reads.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import load_library
from .attention import NEG_INF, pad_head_dim, padded_head_dim

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128, 256)


def paged_attention_dense(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_tables: torch.Tensor,
                          lengths: torch.Tensor, *,
                          scale: float | None = None) -> torch.Tensor:
    """The plain PyTorch version: gather every table entry into a dense
    ``[slots, width * block_size, heads, head_dim]`` view, mask past
    ``length``, softmax. Idle rows are zeroed."""
    num_slots, num_heads, hd = q.shape
    block_size = k_pages.shape[1]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    ctx = block_tables.shape[1] * block_size
    tables = block_tables.long()
    kd = k_pages[tables].reshape(num_slots, ctx, num_heads, hd)
    vd = v_pages[tables].reshape(num_slots, ctx, num_heads, hd)
    lengths = lengths.to(q.device)
    live = (torch.arange(ctx, device=q.device)[None, :]
            < lengths[:, None])                         # [S, ctx]
    scores = torch.einsum("shd,skhd->shk", q.float(), kd.float()) * scale
    scores = scores.masked_fill(~live[:, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("shk,skhd->shd", w, vd.float())
    return out * (lengths > 0)[:, None, None].to(out.dtype)


def _check(q, k_pages, v_pages, block_tables, lengths) -> None:
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"paged_attention wants q [slots, heads, hd] and "
                         f"pages [blocks, block_size, heads, hd]; got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}")
    if (v_pages.shape != k_pages.shape
            or tuple(k_pages.shape[2:]) != tuple(q.shape[1:])):
        raise ValueError(f"pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if (block_tables.dim() != 2 or lengths.dim() != 1
            or block_tables.shape[0] != q.shape[0]
            or lengths.shape[0] != q.shape[0]):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / "
                         f"lengths {tuple(lengths.shape)} do not match "
                         f"{q.shape[0]} slots")
    if k_pages.dtype != v_pages.dtype:
        raise ValueError(f"k/v page dtypes differ: {k_pages.dtype}, "
                         f"{v_pages.dtype}")
    devs = {x.device for x in (q, k_pages, v_pages, block_tables, lengths)}
    if len(devs) != 1:
        raise ValueError(f"paged_attention inputs on several devices: "
                         f"{sorted(map(str, devs))}")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, *,
                    scale: float | None = None) -> torch.Tensor:
    """Single-query attention over a paged KV cache, one layer.

    ``q`` [slots, heads, head_dim] (the current token's query, after its
    K/V were written to the cache); ``k_pages``/``v_pages`` [num_blocks,
    block_size, heads, head_dim]; ``block_tables`` [slots, width] int32
    (dead entries point at the null block 0); ``lengths`` [slots] int32,
    the context length including the current token, 0 for an idle slot.
    Returns float32 [slots, heads, head_dim]."""
    _check(q, k_pages, v_pages, block_tables, lengths)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return paged_attention_dense(q, k_pages, v_pages, block_tables,
                                     lengths, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    return _launch(q, k_pages, v_pages, block_tables, lengths, float(scale))


paged_attention.launches = 0  # kernel launches (CUDA calls only)


def kernel_route(dtype: torch.dtype, head_dim: int) -> str:
    """Which compiled kernel K5 launches for ``dtype`` and ``head_dim``:
    ``"cluster_split"`` (the only one: each slot's context split over a
    cluster of blocks); raises ``ValueError`` for a pair it does not
    take. Asks the built library."""
    fn = load_library("paged_attention").dmt_paged_attention_route
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    r = fn(_DTYPES.get(dtype, -1), head_dim)
    if r != 0:
        raise ValueError(f"K5 has no kernel for {dtype}, head_dim {head_dim}")
    return "cluster_split"


def kernel_occupancy(q_dtype: torch.dtype, kv_dtype: torch.dtype,
                     slots: int, heads: int, head_dim: int, block_size: int,
                     width: int) -> dict:
    """What K5 would launch for such a call, from the CUDA runtime,
    without launching it: blocks resident per SM, threads a block,
    dynamic shared memory bytes, blocks a cluster and clusters resident
    on the card at once. Needs a CUDA device."""
    fn = load_library("paged_attention").dmt_paged_attention_occupancy
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    info = (ctypes.c_int * 5)()
    rc = fn(_DTYPES[q_dtype], _DTYPES[kv_dtype], slots, heads, head_dim,
            block_size, width, info)
    if rc != 0:
        raise RuntimeError(f"K5 occupancy query failed: CUDA error {rc}")
    return dict(zip(("blocks_per_sm", "threads", "smem_bytes",
                     "cluster_size", "clusters_resident"), info))


def _lib():
    lib = load_library("paged_attention")
    fn = lib.dmt_paged_attention
    if fn.argtypes is None:  # declared once; CDLL caches the function
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k_pages, v_pages, block_tables, lengths,
            scale: float) -> torch.Tensor:
    if q.dtype not in _DTYPES or k_pages.dtype not in _DTYPES:
        raise ValueError(f"paged kernel takes float32 or bfloat16, got q "
                         f"{q.dtype}, pages {k_pages.dtype}")
    hd_true = q.shape[-1]
    size = padded_head_dim(hd_true, _HEAD_DIMS)
    if size != hd_true:
        # ≙ pallas_paged_attention.py's per-call pad of q and the pages
        q, k_pages, v_pages = (pad_head_dim(x, size)
                               for x in (q, k_pages, v_pages))
    num_slots, num_heads, hd = q.shape
    block_size = k_pages.shape[1]
    if q.stride(-1) != 1:
        raise ValueError("paged kernel needs q's head_dim contiguous")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("paged kernel needs contiguous k/v pages")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged kernel needs 16-byte aligned k/v pages")
    if (block_tables.dtype != torch.int32 or lengths.dtype != torch.int32
            or not block_tables.is_contiguous()
            or not lengths.is_contiguous()):
        raise ValueError("paged kernel needs contiguous int32 block_tables "
                         "and lengths")
    out = torch.empty((num_slots, num_heads, hd), dtype=torch.float32,
                      device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _lib()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    block_tables.data_ptr(), lengths.data_ptr(),
                    out.data_ptr(), _DTYPES[q.dtype], _DTYPES[k_pages.dtype],
                    num_slots, num_heads, hd, block_size,
                    block_tables.shape[1], k_pages.shape[0], q.stride(0),
                    q.stride(1), scale, stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {rc}")
    paged_attention.launches += 1
    return out if size == hd_true else out[..., :hd_true].contiguous()
