"""Flash-attention forward (≙ ``distributedmnist_tpu/ops/pallas_attention.py
flash_attention_bshd``, forward only): kernel K1.

:func:`flash_attention_bshd` is the model-layout entry — q, k, v in
``[batch, seq, heads, head_dim]``, read through their strides, so the
model hands it ``qkv[:, :, 0]`` views with no head transpose and no
copy. On a CUDA tensor it launches the hand-written kernel
``csrc/flash_attention_fwd.cu``; on a CPU tensor it runs the plain
version :func:`flash_attention_bshd_plain`. There is no fallback
between the two: a CUDA call that the kernel cannot take raises.

Numerics (shared by both versions): scores and softmax in float32,
scale ``1/sqrt(head_dim)`` unless given, causal mask with the finite
``-1e30``, output in the inputs' dtype. The kernel keeps P in float32
for the P.V product (the TPU kernel rounds P to the input dtype there),
so in bfloat16 it is a little closer to the float32 oracle than the
reference kernel is.

The reference kernel's log-sum-exp output and its backward kernels
(K2-K4) belong to the training slice and are not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import load_library
from .attention import local_self_attention

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128, 256)


def flash_attention_bshd_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = True,
                               scale: float | None = None) -> torch.Tensor:
    """The plain PyTorch version: dense causal attention over the same
    ``[b, s, h, d]`` layout (the ``[s, s]`` scores are materialized)."""
    t = lambda x: x.transpose(1, 2)  # [b, s, h, d] <-> [b, h, s, d]
    return t(local_self_attention(t(q), t(k), t(v), causal=causal,
                                  scale=scale)).contiguous()


flash_attention_bshd_plain.layout = "bshd"


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention_bshd wants q, k, v of one shape "
                         f"[b, s, h, d]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v devices differ: {q.device}, {k.device}, "
                         f"{v.device}")


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         scale: float | None = None) -> torch.Tensor:
    """Exact attention over ``[batch, seq, heads, head_dim]``; returns a
    contiguous q-shaped tensor in q's dtype."""
    _check(q, k, v)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return flash_attention_bshd_plain(q, k, v, causal=causal,
                                          scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bshd runs on cuda or cpu "
                         f"tensors, got {q.device}")
    return _launch(q, k, v, causal, float(scale))


flash_attention_bshd.layout = "bshd"  # the model skips head transposes
flash_attention_bshd.launches = 0     # kernel launches (CUDA calls only)


def _lib():
    lib = load_library("flash_attention_fwd")
    fn = lib.dmt_flash_attention_fwd
    if fn.argtypes is None:  # declared once; CDLL caches the function
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    b, s, h, d = q.shape
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash kernel takes float32 or bfloat16, got "
                         f"{q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {_HEAD_DIMS}, "
                         f"got {d}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("flash kernel needs a contiguous last (head_dim) "
                         "dimension; other dims may be strided")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 12)(
        *(st for x in (q, k, v, out)
          for st in (x.stride(0), x.stride(1), x.stride(2))))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), _DTYPES[q.dtype], b, s, h, d,
                    ctypes.addressof(strides), int(causal), scale, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{rc}")
    flash_attention_bshd.launches += 1
    return out
