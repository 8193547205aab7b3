"""Flash attention, forward and backward (≙ ``distributedmnist_tpu/ops/
pallas_attention.py flash_attention_bshd`` and its custom VJP
``_flash``): kernels K1, K1-lse, K2, K3 and K4.

:func:`flash_attention_bshd` is the model-layout entry — q, k, v in
``[batch, seq, heads, head_dim]``, read through their strides, so the
model hands it ``qkv[:, :, 0]`` views with no head transpose and no
copy. Without autograd (inference, eval) it runs the forward alone:
kernel K1 (``csrc/flash_attention_fwd.cu``). When a gradient is wanted
it runs :class:`FlashAttention`, the ``torch.autograd.Function`` that
mirrors the reference's ``_flash``:

* forward — K1-lse, the same kernel also writing each query row's
  log-sum-exp; the saved residuals are ``q, k, v, o, lse``, all
  O(s·d), so the ``[s, s]`` scores are never kept;
* backward — K4 (``csrc/flash_attention_bwd.cu``, dq, dk and dv in one
  visit) when the padded sequence fits one ``(BLOCK_Q, BLOCK_K)`` tile
  pair, else K2 (dq) and K3 (dk, dv). :func:`backward_route` is the
  one rule, the same for every device. The backward is a Function of
  its own (:class:`FlashAttentionBackward`);
* under ``torch.func.vmap`` (the train step's replicas) both Functions'
  ``vmap`` rules fold the replica axis into the batch axis, so one
  launch of each kernel serves every replica.

On a CUDA tensor each wrapper launches its kernel and adds one to its
``.launches`` count; on a CPU tensor it runs the plain PyTorch version
(:func:`flash_attention_fwd_lse_plain`,
:func:`flash_attention_bwd_plain`) and counts nothing. There is no
fallback between the two: a CUDA call a kernel cannot take raises.

Numerics (shared by every version): scores and softmax in float32,
scale ``1/sqrt(head_dim)`` unless given, causal mask with the finite
``-1e30`` (the backward zeroes masked and padded entries by selection),
outputs in the inputs' dtype, lse in float32 laid out ``[b, h, s]``
(the reference's is lane-broadcast ``[b, s_pad, h·128]``, a TPU
tiling; its lane 0 is this). In bfloat16 every kernel runs on the
tensor cores and rounds p and ds to bfloat16 before the products p·v,
ds·k, pᵀ·do and dsᵀ·q, as the TPU kernels round them to the input
dtype; every float32 call runs on the CUDA cores and keeps p and ds in
float32 for every product. :func:`kernel_route` says which kernel a call
takes. bfloat16 calls need 16-byte aligned q, k, v, o and do, with
(batch, seq, head) strides that are multiples of 8 elements — the
model's ``qkv[:, :, i]`` views are.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import load_library
from .attention import (NEG_INF, local_self_attention, pad_head_dim,
                        padded_head_dim)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The compiled head_dims; any smaller head_dim is zero-padded to the
# next one on the way in and sliced back on the way out (the scale stays
# the caller's, 1/sqrt of the true head_dim). K2-K4 have no 256
# instantiation, so training with head_dim > 128 raises.
_HEAD_DIMS = (32, 64, 128, 256)   # K1, K1-lse
_BWD_HEAD_DIMS = (32, 64, 128)    # K2, K3, K4
# The port's 64-row tiles (csrc/flash_attention_bwd.cu): K3 owns 64 keys
# and streams 64-query tiles, K2 gives each warpgroup 64 queries; K4
# takes the whole sequence when it fits one (BLOCK_Q, BLOCK_K) pair.
BLOCK_Q = 64
BLOCK_K = 64


def backward_route(seq_len: int) -> str:
    """``"fused"`` (K4) when the sequence padded to the port's tiles
    fits one ``(BLOCK_Q, BLOCK_K)`` pair, else ``"split"`` (K2 + K3) —
    the reference's ``nq == nk == 1`` rule over the port's block sizes.
    Depends on the shape alone, so CPU and GPU runs choose alike."""
    pad_q = -(-seq_len // BLOCK_Q) * BLOCK_Q
    pad_k = -(-seq_len // BLOCK_K) * BLOCK_K
    return "fused" if pad_q <= BLOCK_Q and pad_k <= BLOCK_K else "split"


# -- plain versions -------------------------------------------------------

def flash_attention_bshd_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = True,
                               scale: float | None = None) -> torch.Tensor:
    """The plain PyTorch version of K1: dense causal attention over the
    same ``[b, s, h, d]`` layout (the ``[s, s]`` scores are
    materialized)."""
    t = lambda x: x.transpose(1, 2)  # [b, s, h, d] <-> [b, h, s, d]
    return t(local_self_attention(t(q), t(k), t(v), causal=causal,
                                  scale=scale)).contiguous()


flash_attention_bshd_plain.layout = "bshd"


def _work_dtype(dtype: torch.dtype) -> torch.dtype:
    # float32 for float32/bfloat16 inputs; float64 stays float64 (gradcheck)
    return torch.promote_types(dtype, torch.float32)


def _scores(q, k, causal: bool, scale: float):
    """[b, s, h, d] q, k → float scores [b, h, s, s] and the live mask."""
    wt = _work_dtype(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(wt), k.to(wt)) * scale
    n = q.shape[1]
    live = (torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
            if causal else None)
    return s, live


def flash_attention_fwd_lse_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, *, causal: bool = True,
                                  scale: float | None = None
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K1-lse: dense attention that also returns
    each query row's log-sum-exp, ``(o [b, s, h, d] in q's dtype,
    lse [b, h, s] float32 — float64 for float64 inputs)``."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s, live = _scores(q, k, causal, scale)
    if live is not None:
        s = s.masked_fill(~live, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.to(s.dtype))
    return o.to(q.dtype).contiguous(), lse


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              scale: float | None = None):
    """The plain version of K2, K3 and K4, which compute one function —
    the FlashAttention-2 backward from the saved log-sum-exp, written
    out with the ``[s, s]`` matrices materialized:

        p  = exp(q·kᵀ·scale − lse)   (0 where masked, by selection)
        ds = p ⊙ (do·vᵀ − δ),        δ = rowsum(do ⊙ o)
        dq = scale·ds·k,  dk = scale·dsᵀ·q,  dv = pᵀ·do

    Returns ``(dq, dk, dv)`` ``[b, s, h, d]`` in the dtypes of q, k,
    v."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s, live = _scores(q, k, causal, scale)
    wt = s.dtype
    p = torch.exp(s - lse.to(wt)[..., None])
    if live is not None:
        p = torch.where(live, p, torch.zeros((), dtype=wt, device=p.device))
    do_, o_ = do.to(wt), o.to(wt)
    dp = torch.einsum("bqhd,bkhd->bhqk", do_, v.to(wt))
    delta = (do_ * o_).sum(-1).transpose(1, 2)[..., None]  # [b, h, s, 1]
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(wt)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(wt)) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do_)
    return (dq.to(q.dtype).contiguous(), dk.to(k.dtype).contiguous(),
            dv.to(v.dtype).contiguous())


# -- checks ---------------------------------------------------------------

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
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention_bshd runs on cuda or cpu "
                         f"tensors, got {q.device}")


def _check_kernel(q: torch.Tensor, *tensors: torch.Tensor) -> None:
    """What every kernel takes (after head_dim padding): float32/
    bfloat16 and a contiguous last dimension (the rest may be
    strided)."""
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash kernel takes float32 or bfloat16, got "
                         f"{q.dtype}")
    if any(x.stride(-1) != 1 for x in (q, *tensors)):
        raise ValueError("flash kernel needs a contiguous last (head_dim) "
                         "dimension; other dims may be strided")
    if q.dtype == torch.bfloat16 and not all(
            _aligned16(x) for x in (q, *tensors)):
        raise ValueError("the bfloat16 flash kernels read 16-byte rows: "
                         "each tensor's address must be 16-byte aligned and "
                         "its batch, seq and head strides multiples of 8")


def _aligned16(x: torch.Tensor) -> bool:
    return (x.data_ptr() % 16 == 0
            and all(st % 8 == 0 for st in x.stride()[:-1]))


def _strides(*tensors: torch.Tensor):
    return (ctypes.c_int64 * (3 * len(tensors)))(
        *(st for x in tensors for st in (x.stride(0), x.stride(1),
                                          x.stride(2))))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


# -- K1 and K1-lse --------------------------------------------------------

def _fwd_fn(name: str, with_lse: bool):
    lib = load_library("flash_attention_fwd")
    fn = getattr(lib, name)
    if fn.argtypes is None:  # declared once; CDLL caches the function
        fn.argtypes = ([ctypes.c_void_p] * (5 if with_lse else 4)
                       + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch_fwd(q, k, v, causal: bool, scale: float, with_lse: bool):
    d_true = q.shape[-1]
    size = padded_head_dim(d_true, _HEAD_DIMS)
    if size != d_true:
        q, k, v = (pad_head_dim(x, size) for x in (q, k, v))
    _check_kernel(q, k, v)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    strides = _strides(q, k, v, out)
    with torch.cuda.device(q.device):
        if with_lse:
            rc = _fwd_fn("dmt_flash_attention_fwd_lse", True)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), _DTYPES[q.dtype], b, s, h, d,
                ctypes.addressof(strides), int(causal), scale, _stream(q))
        else:
            rc = _fwd_fn("dmt_flash_attention_fwd", False)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], b, s, h, d, ctypes.addressof(strides),
                int(causal), scale, _stream(q))
    _raise_on(rc, "flash_attention_fwd_lse" if with_lse
              else "flash_attention_fwd")
    if size != d_true:
        out = out[..., :d_true].contiguous()
    return out, lse


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            scale: float | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1-lse: ``(o, lse)`` — the forward of the training path."""
    _check(q, k, v)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return flash_attention_fwd_lse_plain(q, k, v, causal=causal,
                                             scale=scale)
    out, lse = _launch_fwd(q, k, v, causal, float(scale), with_lse=True)
    flash_attention_fwd_lse.launches += 1
    return out, lse


flash_attention_fwd_lse.launches = 0


# -- K2, K3, K4 -----------------------------------------------------------

def _bwd_fn(name: str):
    fn = getattr(load_library("flash_attention_bwd"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch_bwd(name: str, q, k, v, o, lse, do, want: tuple[bool, ...],
                causal: bool, scale: float) -> tuple:
    """Launch one backward kernel; ``want`` says which of (dq, dk, dv)
    it writes. Returns those gradients, padded head_dims sliced back."""
    d_true = q.shape[-1]
    size = padded_head_dim(d_true, _BWD_HEAD_DIMS)
    if size != d_true:
        q, k, v, o, do = (pad_head_dim(x, size) for x in (q, k, v, o, do))
    _check_kernel(q, k, v, o, do)
    dq, dk, dv = (torch.empty(x.shape, dtype=x.dtype, device=x.device)
                  if w else None for x, w in zip((q, k, v), want))
    b, s, h, d = q.shape
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 {(b, h, s)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if not (o.dtype == do.dtype == q.dtype):
        raise ValueError(f"o / do dtypes {o.dtype}, {do.dtype} differ from "
                         f"q's {q.dtype}")
    # an unwritten output slot gets q's strides and a null pointer
    outs = [x if x is not None else q for x in (dq, dk, dv)]
    strides = _strides(q, k, v, o, do, *outs)
    ptr = lambda x: x.data_ptr() if x is not None else None
    with torch.cuda.device(q.device):
        rc = _bwd_fn(name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), ptr(dq), ptr(dk), ptr(dv),
            _DTYPES[q.dtype], b, s, h, d, ctypes.addressof(strides),
            int(causal), scale, _stream(q))
    _raise_on(rc, name)
    return tuple(x if size == d_true else x[..., :d_true].contiguous()
                 for x in (dq, dk, dv) if x is not None)


def _bwd_args(q, k, v, o, lse, do, scale):
    _check(q, k, v)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if do.stride(-1) != 1 or (do.dtype == torch.bfloat16
                              and not _aligned16(do)):
        do = do.contiguous()  # e.g. an expanded ones cotangent
    return do, float(scale)


def flash_attention_bwd_dq(q, k, v, o, lse, do, *, causal: bool = True,
                           scale: float | None = None) -> torch.Tensor:
    """K2: dq."""
    do, scale = _bwd_args(q, k, v, o, lse, do, scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         scale=scale)[0]
    (dq,) = _launch_bwd("dmt_flash_attention_bwd_dq", q, k, v, o, lse, do,
                        (True, False, False), causal, scale)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, o, lse, do, *, causal: bool = True,
                            scale: float | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: (dk, dv)."""
    do, scale = _bwd_args(q, k, v, o, lse, do, scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         scale=scale)[1:]
    dk, dv = _launch_bwd("dmt_flash_attention_bwd_dkv", q, k, v, o, lse, do,
                         (False, True, True), causal, scale)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd_fused(q, k, v, o, lse, do, *, causal: bool = True,
                              scale: float | None = None):
    """K4: (dq, dk, dv) in one visit; the sequence must fit one tile
    pair (:func:`backward_route` is ``"fused"``)."""
    do, scale = _bwd_args(q, k, v, o, lse, do, scale)
    if backward_route(q.shape[1]) != "fused":
        raise ValueError(f"the fused backward takes seq_len <= "
                         f"{min(BLOCK_Q, BLOCK_K)}, got {q.shape[1]}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         scale=scale)
    dq, dk, dv = _launch_bwd("dmt_flash_attention_bwd_fused", q, k, v, o,
                             lse, do, (True, True, True), causal, scale)
    flash_attention_bwd_fused.launches += 1
    return dq, dk, dv


flash_attention_bwd_fused.launches = 0


def flash_attention_backward(q, k, v, o, lse, do, *, causal: bool = True,
                             scale: float | None = None):
    """(dq, dk, dv) through the route :func:`backward_route` picks: K4,
    or K2 then K3 (on a CPU tensor, their common plain version)."""
    if q.device.type == "cpu":
        do, scale = _bwd_args(q, k, v, o, lse, do, scale)
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         scale=scale)
    if backward_route(q.shape[1]) == "fused":
        return flash_attention_bwd_fused(q, k, v, o, lse, do, causal=causal,
                                         scale=scale)
    dq = flash_attention_bwd_dq(q, k, v, o, lse, do, causal=causal,
                                scale=scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, o, lse, do, causal=causal,
                                     scale=scale)
    return dq, dk, dv


# -- which kernel a call takes --------------------------------------------

_ROUTES = {1: "wgmma", 0: "cuda_cores"}
_BWD_WHICH = {"K2": 0, "K3": 1, "K4": 2}


def _query(kernel: str, what: str):
    """The library query ``dmt_flash_attention_{fwd,bwd}_{what}`` for
    ``kernel``, and the leading arguments that name the kernel (the
    backward library serves K2, K3 and K4)."""
    fwd = kernel in ("K1", "K1-lse")
    lib = load_library("flash_attention_fwd" if fwd else "flash_attention_bwd")
    fn = getattr(lib, f"dmt_flash_attention_{'fwd' if fwd else 'bwd'}_{what}")
    lead = () if fwd else (_BWD_WHICH[kernel],)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * (len(lead) + (2 if what == "route"
                                                      else 5))
                       + ([] if what == "route"
                          else [ctypes.POINTER(ctypes.c_int)]))
        fn.restype = ctypes.c_int
    return fn, lead


def kernel_route(kernel: str, dtype: torch.dtype, head_dim: int) -> str:
    """Which compiled kernel ``kernel`` ("K1", "K1-lse", "K2", "K3" or
    "K4") launches for ``dtype`` and ``head_dim``: ``"wgmma"`` (the
    tensor-core kernel) or ``"cuda_cores"``; raises ``ValueError`` for a
    pair no kernel takes. Asks the built library (on a machine with
    ``nvcc``)."""
    if dtype not in _DTYPES:
        raise ValueError(f"no flash kernel takes {dtype}")
    fn, lead = _query(kernel, "route")
    r = fn(*lead, _DTYPES[dtype], head_dim)
    if r not in _ROUTES:
        raise ValueError(f"{kernel} has no kernel for {dtype}, head_dim "
                         f"{head_dim}")
    return _ROUTES[r]


def kernel_occupancy(kernel: str, dtype: torch.dtype,
                     shape: tuple[int, int, int, int]) -> dict:
    """What ``kernel`` would launch for inputs of ``shape`` ``[b, s, h,
    d]``, from the CUDA runtime, without launching it: blocks resident
    per SM, threads a block and dynamic shared memory bytes (registers
    and spills: ``_build.ptxas_report``). Needs a CUDA device."""
    info = (ctypes.c_int * 3)()
    fn, lead = _query(kernel, "occupancy")
    _raise_on(fn(*lead, _DTYPES[dtype], *shape, info),
              f"{kernel} occupancy query")
    return dict(zip(("blocks_per_sm", "threads", "smem_bytes"), info))


# -- the autograd binding and the model's entry ---------------------------

def _fold(info, in_dims, *tensors):
    """The replica axis of each vmapped tensor moved to the front and
    folded into its batch axis (``[L, b, ...]`` → ``[L·b, ...]``, a view
    where the strides allow); an unbatched tensor is expanded first."""
    out = []
    for x, d in zip(tensors, in_dims):
        x = (x.movedim(d, 0) if d is not None
             else x.expand(info.batch_size, *x.shape))
        out.append(x.reshape(x.shape[0] * x.shape[1], *x.shape[2:]))
    return out


def _unfold(L: int, *tensors: torch.Tensor):
    return tuple(x.view(L, x.shape[0] // L, *x.shape[1:]) for x in tensors)


class FlashAttention(torch.autograd.Function):
    """≙ the reference's ``_flash`` custom VJP: K1-lse forward, returning
    ``(o, lse)`` (lse not differentiable) and saving ``q, k, v, o, lse``;
    backward through :class:`FlashAttentionBackward`.

    Under ``torch.func.vmap`` (the train step's replicas) the ``vmap``
    rule folds the replica axis into the batch axis the kernel already
    takes, so one launch serves every replica with the same arithmetic.
    torch runs the backward under vmap too, on batched tensors that have
    no storage for a launch, hence the second Function with its own
    fold."""

    @staticmethod
    def forward(q, k, v, causal: bool, scale: float):
        if q.device.type == "cuda" and q.shape[-1] > max(_BWD_HEAD_DIMS):
            # refuse before the forward runs, not in the backward
            raise ValueError(
                f"training through the flash kernels takes head_dim up to "
                f"{max(_BWD_HEAD_DIMS)}: the backward (K2-K4) has no "
                f"{_HEAD_DIMS[-1]} instantiation; got {q.shape[-1]}")
        return flash_attention_fwd_lse(q, k, v, causal=causal, scale=scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, scale = inputs
        o, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale

    @staticmethod
    def backward(ctx, do, _dlse):
        dq, dk, dv = FlashAttentionBackward.apply(
            *ctx.saved_tensors, do, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, scale):
        o, lse = FlashAttention.apply(*_fold(info, in_dims[:3], q, k, v),
                                      causal, scale)
        return _unfold(info.batch_size, o, lse), (0, 0)


class FlashAttentionBackward(torch.autograd.Function):
    """The backward of :class:`FlashAttention` as a Function of its own
    — ``(dq, dk, dv)`` through :func:`flash_attention_backward` — whose
    ``vmap`` rule folds the replicas into one K2 + K3 (or K4) launch. It
    has no backward itself (no double differentiation, as the
    reference's ``_flash``)."""

    @staticmethod
    def forward(q, k, v, o, lse, do, causal: bool, scale: float):
        return flash_attention_backward(q, k, v, o, lse, do, causal=causal,
                                        scale=scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("flash attention is differentiable once")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, lse, do, causal, scale):
        grads = FlashAttentionBackward.apply(
            *_fold(info, in_dims[:6], q, k, v, o, lse, do), causal, scale)
        return _unfold(info.batch_size, *grads), (0, 0, 0)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         scale: float | None = None) -> torch.Tensor:
    """Exact attention over ``[batch, seq, heads, head_dim]``; returns a
    contiguous q-shaped tensor in q's dtype. Differentiable: under
    autograd it runs :class:`FlashAttention`, else K1 alone (whose
    launches ``flash_attention_bshd.launches`` counts)."""
    _check(q, k, v)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, float(scale))[0]
    if q.device.type == "cpu":
        return flash_attention_bshd_plain(q, k, v, causal=causal,
                                          scale=scale)
    out, _ = _launch_fwd(q, k, v, causal, float(scale), with_lse=False)
    flash_attention_bshd.launches += 1
    return out


flash_attention_bshd.layout = "bshd"  # the model skips head transposes
flash_attention_bshd.launches = 0     # K1 launches (CUDA calls only)
