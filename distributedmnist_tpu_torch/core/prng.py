"""Counter-based PRNG (≙ ``distributedmnist_tpu/core/prng.py`` and the
threefry2x32 ``jax.random`` it draws from), bitwise.

Every random stream of a run derives from one root seed by folding in
a stable stream name, the step and (when per-replica) the replica
index, exactly as the reference does, so a port run draws the same
dropout masks, straggler times, drop-connect masks and sampling noise
as a reference run with the same seed.

A key is two uint32 words. Keys live on the host as numpy ``uint32[2]``
(or ``[..., 2]`` for a batch of keys) and their hashing (``fold_in``,
``split``) runs in Python integers. Random bits for a shape are made on
the device of the caller's choice: torch has no full uint32 arithmetic,
so the threefry rounds run in int64, masked to 32 bits.

The functions follow ``jax.random`` with ``jax_threefry_partitionable``
on (the default since jax 0.5): ``split`` and ``random_bits`` hash a
64-bit counter ``(hi, lo)`` per output element
(``jax/_src/prng.py _threefry_split_foldlike``,
``_threefry_random_bits_partitionable``), and ``fold_in`` hashes the
pair ``(0, data)``.

The samplers are bitwise with ``jax.random`` as XLA computes it on the
CPU, where the reference's runs and tests live. Two things make that
more than a transcription of ``jax/_src/random.py``:

* XLA's CPU backend contracts a float32 multiply feeding an add into
  one fused multiply-add. ``uniform``'s ``u·(max − min) + min`` is one,
  so the port rounds it once too (:func:`_fma`, exact in float64).
* ``log``, ``log1p`` and ``erf_inv`` are XLA's own float32
  approximations, not libm's: a Cephes polynomial for ``log`` (with
  ``log1p`` switching to a rational function near 0) and Giles'
  polynomial for ``erf_inv``, each with the same contractions. The
  port writes them out (:func:`xla_log`, :func:`xla_log1p`,
  :func:`erf_inv`), so ``gumbel``, ``normal`` and ``truncated_normal``
  match bit for bit as well (``tests/test_torch_prng.py``).
"""

from __future__ import annotations

import functools
import hashlib
import math
from typing import Sequence

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


# -- threefry2x32 ------------------------------------------------------------

def _rounds(x0, x1, k0, k1, rotl, add):
    """The 20 rounds and 5 key injections of threefry2x32, generic over
    the integer type (``rotl``/``add`` wrap to 32 bits)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = add(x0, ks[0])
    x1 = add(x1, ks[1])
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = add(x0, x1)
            x1 = rotl(x1, r) ^ x0
        x0 = add(x0, ks[(i + 1) % 3])
        x1 = add(add(x1, ks[(i + 2) % 3]), i + 1)
    return x0, x1


def _py_rotl(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & _M32


def _py_add(a: int, b: int) -> int:
    return (a + b) & _M32


def _t_rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & _M32) | (v >> (32 - r))


def _t_add(a, b):
    return (a + b) & _M32


def threefry2x32(key: Sequence[int], x0: int, x1: int) -> tuple[int, int]:
    """The hash of one counter pair under one key, on the host."""
    return _rounds(int(x0), int(x1), int(key[0]), int(key[1]),
                   _py_rotl, _py_add)


# -- keys (host) ---------------------------------------------------------------

def _as_key(key) -> tuple[int, int]:
    k = np.asarray(key, np.uint32).reshape(-1)
    if k.shape != (2,):
        raise ValueError(f"a key is uint32[2], got shape {np.shape(key)}")
    return int(k[0]), int(k[1])


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the seed's high and low words."""
    seed = int(seed)
    return np.array([(seed >> 32) & _M32 if seed >= 0 else 0,
                     seed & _M32], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in``: hash the counter ``(0, data)``."""
    return np.array(threefry2x32(_as_key(key), 0, int(data) & _M32),
                    np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split``: key i is the hash of the counter ``(0, i)``
    (``[num, 2]`` uint32)."""
    k = _as_key(key)
    return np.array([threefry2x32(k, (i >> 32) & _M32, i & _M32)
                     for i in range(int(num))], np.uint32).reshape(num, 2)


def _stream_tag(name: str) -> int:
    """Stable 31-bit tag for a stream name (blake2s, as the reference)."""
    return int.from_bytes(hashlib.blake2s(name.encode(), digest_size=4)
                          .digest(), "big") & 0x7FFFFFFF


def root_key(seed: int) -> np.ndarray:
    return PRNGKey(seed)


def stream_key(root, name: str) -> np.ndarray:
    """Key for a named stream ("dropout", "drop_connect", ...)."""
    return np.array(_stream_key(_as_key(root), name), np.uint32)


@functools.lru_cache(maxsize=64)
def _stream_key(root: tuple[int, int], name: str) -> tuple[int, int]:
    # a run asks for the same few streams of one root every step
    return threefry2x32(root, 0, _stream_tag(name))


def step_key(root, name: str, step: int) -> np.ndarray:
    return fold_in(stream_key(root, name), int(step))


def replica_key(root, name: str, step: int, replica: int) -> np.ndarray:
    """Per-replica, per-step key."""
    return fold_in(step_key(root, name, step), int(replica))


def replica_keys(root, name: str, step: int, n: int) -> np.ndarray:
    """``[n, 2]``: ``replica_key`` for replicas 0..n-1."""
    base = step_key(root, name, step)
    return np.stack([fold_in(base, r) for r in range(n)])


# -- random bits (device) ---------------------------------------------------------

def random_bits(key, shape: Sequence[int], device=None) -> torch.Tensor:
    """32 random bits per element of ``shape`` (int64 holding uint32
    values). ``key`` is one key ``[2]`` or a batch ``[..., 2]``; a batch
    gives ``[..., *shape]`` (each key its own ``shape``). The rounds run
    in torch int64 on ``device``, the CPU and the card alike. One host
    key (numpy) enters them as two Python integers, so drawing on the
    card copies nothing to it. A key that is a torch tensor (int64
    words) is read where it lies, on ``device``: the train step keeps its
    per-step keys in a device buffer, so a CUDA graph of the step reads
    each replay's keys rather than the ones it was captured with."""
    shape = tuple(int(s) for s in shape)
    if not isinstance(key, torch.Tensor):
        keys = np.asarray(key, np.uint32)
        if keys.size != 2:
            key = torch.from_numpy(keys.astype(np.int64)).to(device)
    if isinstance(key, torch.Tensor):
        batch = tuple(key.shape[:-1])
        k = key.reshape(-1, 2).to(torch.int64)
        k0, k1 = k[:, 0:1], k[:, 1:2]
    else:
        batch = keys.shape[:-1]
        k0, k1 = (int(w) for w in keys.reshape(2))
    counts = torch.arange(math.prod(shape), dtype=torch.int64,
                          device=device)[None, :]
    b0, b1 = _rounds((counts >> 32) & _M32, counts & _M32, k0, k1,
                     _t_rotl, _t_add)
    return (b0 ^ b1).reshape(tuple(batch) + shape)


# -- samplers ------------------------------------------------------------------------

def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a·b + c`` rounded once (the product of two float32s is
    exact in float64)."""
    t = lambda x: (x.double() if isinstance(x, torch.Tensor)
                   else float(np.float32(x)))
    r = t(a) * t(b) + t(c)
    return r.float() if isinstance(r, torch.Tensor) else torch.tensor(
        r, dtype=torch.float32)


def _unit_float(bits: torch.Tensor) -> torch.Tensor:
    """Float32 in [0, 1) from 32 bits: the top 23 as the mantissa of a
    number in [1, 2), minus one (``jax.random._uniform``)."""
    fb = (bits >> 9) | 0x3F800000
    return fb.to(torch.int32).view(torch.float32) - 1.0


def uniform(key, shape: Sequence[int] = (), minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform`` in float32 on ``[minval, maxval)``."""
    f = _unit_float(random_bits(key, shape, device))
    lo, hi = np.float32(minval), np.float32(maxval)
    return _fma(f, hi - lo, lo).clamp(min=float(lo))


def bernoulli(key, p: float, shape: Sequence[int] = (),
              device=None) -> torch.Tensor:
    """``jax.random.bernoulli`` (mode "low"): ``uniform < p`` with p in
    float32, as a bool tensor."""
    return uniform(key, shape, device=device) < float(np.float32(p))


def gumbel(key, shape: Sequence[int] = (), device=None) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") in float32."""
    tiny = float(np.finfo(np.float32).tiny)
    return -xla_log(-xla_log(uniform(key, shape, tiny, 1.0, device)))


def categorical(key, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical`` with replacement: the argmax of the
    float32 logits plus Gumbel noise drawn for the logits' shape."""
    logits = logits.float()
    g = gumbel(key, logits.shape, logits.device)
    return torch.argmax(g + logits, dim=axis)


# XLA's float32 log: Cephes' polynomial on the mantissa folded into
# [sqrt(1/2), sqrt(2)), with the contractions XLA's CPU code makes.
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_SQRTHF = 0.707106781186547524


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log, bitwise XLA's on the CPU."""
    x = x.float()
    tiny = float(np.finfo(np.float32).tiny)
    bits = x.clamp(min=tiny).view(torch.int32)
    e = 1.0 + ((bits >> 23) - 127).float()
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _SQRTHF
    m1 = m - 1.0
    e = e - small.float()
    xm = m1 + torch.where(small, m, 0.0)
    x2 = xm * xm
    x3 = x2 * xm
    p = _LOG_P
    y = _fma(_fma(xm, p[0], p[1]), xm, p[2])
    y1 = _fma(_fma(xm, p[3], p[4]), xm, p[5])
    y2 = _fma(_fma(xm, p[6], p[7]), xm, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * np.float32(_LOG_Q1))
    out = _fma(_LOG_Q2, e, _fma(-0.5, x2, xm) + y)
    inf = float("inf")
    # XLA's CPU code reads subnormal inputs as zero
    out = torch.where(x.abs() < tiny, -inf, out)
    out = torch.where(x == inf, inf, out)
    return torch.where((x < 0) | torch.isnan(x), float("nan"), out)


# XLA's float32 log1p: x - x²/2 + x³·P(x)/Q(x) for |x| < sqrt(2) - 1,
# else log(1 + x).
_LOG1P_Q = (1.0, 15.062909083469192, 83.04756721880528,
            221.76239823732857, 309.09872225312057, 216.42788614495947,
            60.118660497603843)
_LOG1P_P = (4.5270000862445199e-5, 0.49854102823193375,
            6.5787325942061044, 29.911919328553073, 60.949667980987787,
            57.112963590585538, 20.039553499201282)


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 log(1 + x), bitwise XLA's on the CPU."""
    x = x.float()
    x2 = x * x
    zero = x * 0.0
    num = zero + np.float32(_LOG1P_P[0])
    for c in _LOG1P_P[1:]:
        num = _fma(num, x, c)
    den = zero + 1.0
    for c in _LOG1P_Q[1:]:
        den = _fma(den, x, c)
    r = (x * x2) * (num / den)
    near = x + _fma(x2, -0.5, r)
    return torch.where(x.abs() < np.float32(0.41421356237309503),
                       near, xla_log(x + 1.0))


# XLA's float32 ErfInv (Giles, "Approximating the erfinv function"):
# a degree-8 polynomial in w - 2.5 for w = -log1p(-x²) < 5, else in
# sqrt(w) - 3.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, bitwise XLA's on the CPU."""
    x = x.float()
    lg = xla_log1p(x * -x)
    lt = lg > -5.0
    # a correctly rounded float32 sqrt (torch's CPU kernel is not)
    w = torch.where(lt, -2.5 - lg, (-lg).double().sqrt().float() - 3.0)
    c = [torch.where(lt, float(np.float32(a)), float(np.float32(b)))
         for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = c[0]
    for ci in c[1:]:
        p = _fma(w, p, ci)
    p = torch.where(x.abs() == 1.0, float("inf"), p)
    return x * p


_SQRT2 = float(np.float32(np.sqrt(2)))


def normal(key, shape: Sequence[int] = (), device=None) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt2 · erf_inv(u)`` for u
    uniform on ``(-1, 1)``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return _SQRT2 * erf_inv(uniform(key, shape, lo, 1.0, device))


def _erf32(x: float) -> float:
    return float(torch.erf(torch.tensor(x, dtype=torch.float32)))


def truncated_normal(key, lower: float, upper: float,
                     shape: Sequence[int] = (), device=None) -> torch.Tensor:
    """``jax.random.truncated_normal`` in float32 on ``(lower, upper)``."""
    a = _erf32(float(np.float32(lower) / np.float32(_SQRT2)))
    b = _erf32(float(np.float32(upper) / np.float32(_SQRT2)))
    out = _SQRT2 * erf_inv(uniform(key, shape, a, b, device))
    lo = float(np.nextafter(np.float32(lower), np.float32(np.inf)))
    hi = float(np.nextafter(np.float32(upper), np.float32(-np.inf)))
    return out.clamp(lo, hi)
