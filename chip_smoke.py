#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU (H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``distributedmnist_tpu_torch/
csrc`` and drives the port's two paths at the full width of the widest
transformer the repository runs (d_model 2048, 16 heads of 128, 4
layers, seq_len 1024, vocab 1024, bf16 compute, float32 params), with
random weights from a seed:

* training — ``python -m distributedmnist_tpu_torch.launch train``'s
  Trainer, built in process by the CLI's ``build_trainer`` (global batch
  16, ``synthetic_lm``, sync, sgd, constant learning rate), and a short
  run at seq_len 64, where the backward takes the fused kernel K4;
* decode serving — ``launch serve --decode``'s replica (8 decode slots,
  16-token blocks, 320 blocks, prompts up to 512, up to 64 new tokens)
  serving the checkpoint the training phase wrote.

One JSON line per phase:

1. ``env``      — the card, torch and CUDA versions; fails without CUDA
                or without the port package beside this script.
2. ``build``    — seconds to compile every kernel (one nvcc per source,
                all at once).
3. ``kernels``  — each kernel against its plain PyTorch version on the
                card at the main paths' shapes, float32 and bfloat16:
                K1 flash-attention forward and K5 paged attention at
                the decode shapes; K1-lse (forward with log-sum-exp),
                K2 (dq), K3 (dk, dv) at the training shape and K4
                (fused backward) at the short run's; max abs error
                beside the stated tolerance, kernel / plain / library
                times (CUDA events), and the bound.
4. ``train``    — one step through the kernels against one step through
                their plain versions from the same params and batch;
                then 20 steps of the Trainer with every launch counter
                set to 0 just before and read just after: finite losses,
                the last below the first, K1-lse, K2 and K3 launched 4
                times a step (K4 never); the final checkpoint read back;
                a test-split eval through K1; ms per step (CUDA events),
                tokens/s, peak memory and a ``torch.profiler`` split of
                one step into GEMMs, attention kernels, other kernels
                and device idle.
5. ``train_k4`` — 5 steps at seq_len 64 (one tile): K4 launched 4 times
                a step, K2 and K3 never.
6. ``e2e``      — boots the decode replica on the training phase's
                checkpoint through the CLI's ``build_decode_replica``,
                streams 8 concurrent greedy requests over its socket,
                and checks:
                an ``ok`` terminal with exactly ``max_tokens`` tokens
                for each; each first token equal to the argmax of an
                offline prefill of its prompt; the K1 and K5 launch
                counters grown by 4 per prefill and 4 per decode
                iteration; one prefill plus 3 decode steps through the
                kernels within a stated tolerance of the plain versions.
                Prints tokens/s, TTFT p50 and inter-token p50.

Then a ``kernels`` summary line, the card's name and power limit as
``nvidia-smi`` reports them, and, last, the result line
``{"ok": true, "device": {...}}``. Any failure prints the failing
phase and exits nonzero before the result line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback

SEED = 0
DEVICE = "cuda"
MODEL = {"name": "transformer", "model_dim": 2048, "num_heads": 16,
         "num_layers": 4, "seq_len": 1024, "vocab_size": 1024,
         "num_experts": 0, "compute_dtype": "bfloat16",
         "attention_impl": "flash"}
DECODE = {"decode_slots": 8, "block_size": 16, "max_prompt_len": 512,
          "max_new_tokens": 64, "num_blocks": 320,
          "attention_kernel": "paged", "swap_policy": "pin"}
# prompt length → max_tokens of the 8 concurrent requests
REQUESTS = [(5, 32), (17, 40), (100, 48), (257, 56), (512, 64), (33, 36),
            (64, 44), (200, 60)]

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and FLOP/s by
# input type (bf16 on the tensor cores; float32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# kernel vs plain on the same inputs: float32 differs by summation
# order only; bfloat16 outputs (K1) differ by at most ~1 ulp (2^-7
# relative) where the two round differently; K5 always outputs float32
TOL = {("K1", "float32"): 1e-4, ("K1", "bfloat16"): 3e-2,
       ("K5", "float32"): 1e-4, ("K5", "bfloat16"): 1e-4}
# K1-lse, K2, K3, K4 at the training shapes, elementwise
# |kernel - plain| <= atol + rtol * |plain| (numpy's allclose): float32
# differs by summation order; bfloat16 outputs by one bf16 ulp where
# the two round differently (the gradients reach ~10 here, an ulp of
# 2^-4, hence the relative term); lse is float32 from the same inputs
BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 1e-2),
           "lse": (1e-4, 1e-4)}

# the training path (bench.py bench_transformer_flash's model and batch)
TRAIN_STEPS = 20
TRAIN = {"name": "chip_smoke_train", "model": MODEL, "decode": DECODE,
         "serve": {"default_deadline_ms": 300000.0},
         "data": {"dataset": "synthetic_lm", "batch_size": 16,
                  "synthetic_train_size": 512, "synthetic_test_size": 32,
                  "use_native_pipeline": False},
         "optim": {"name": "sgd", "initial_learning_rate": 0.1,
                   "learning_rate_decay_factor": 1.0},
         "sync": {"mode": "sync"},
         "eval": {"eval_batch_size": 16},
         "train": {"max_steps": TRAIN_STEPS, "log_every_steps": 5,
                   "save_interval_steps": 0, "save_results_period": 0,
                   "summary_every_steps": 0, "seed": SEED}}
# the short run: the same model at a sequence that fits one tile (K4)
K4_SEQ, K4_BATCH, K4_STEPS = 64, 64, 5
# one train step through the kernels vs through their plain versions
# from the same params and batch (bf16 compute): attention outputs and
# gradients differ by a bf16 ulp here and there, which moves the loss
# (~6.9) by well under 2e-2 and each float32 param, through lr 0.1
# times a gradient difference, by well under 1e-3
STEP_LOSS_TOL = 2e-2
STEP_PARAM_TOL = 1e-3
# end to end, bf16 logits of one prefill + 3 decode steps, kernels vs
# plain: per-layer attention rounding differences (one bf16 ulp here
# and there) compound through 4 layers and the 2048-wide projections;
# 0.1 is ~3 bf16 ulps at the logits' magnitude
E2E_LOGIT_TOL = 0.1


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseError(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def nvidia_smi() -> str | None:
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return p.stdout.strip().splitlines()[0] if p.returncode == 0 else None


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events over ``iters``."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))


# -- phase 1 ----------------------------------------------------------------

def phase_env() -> dict:
    import torch
    rec = {"phase": "env", "nvidia_smi": nvidia_smi(),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0],
           "cuda_available": torch.cuda.is_available()}
    emit(rec)
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    try:
        import distributedmnist_tpu_torch  # noqa: F401
    except ImportError as e:
        raise PhaseError(f"the port package is not beside this script: {e}")
    rec["device"] = torch.cuda.get_device_name(0)
    return rec


# -- phase 2 ----------------------------------------------------------------

def phase_build() -> None:
    from distributedmnist_tpu_torch.ops import _build
    t0 = time.time()
    compiled = _build.build()
    for name in _build.SOURCES:
        _build.load_library(name)
    emit({"phase": "build", "seconds": round(time.time() - t0, 3),
          "compiled": compiled})


# -- phase 3 ----------------------------------------------------------------

def _k1_case(s: int, dtype, gen, timed: bool) -> dict:
    import torch
    import torch.nn.functional as F

    from distributedmnist_tpu_torch.ops.flash_attention import (
        flash_attention_bshd, flash_attention_bshd_plain)
    b, h, d = 1, MODEL["num_heads"], MODEL["model_dim"] // MODEL["num_heads"]
    # the model's inputs: strided q/k/v views of one [b, s, 3, d] product
    qkv = torch.randn(b, s, 3, h * d, device=DEVICE, generator=gen).to(dtype)
    q, k, v = (qkv[:, :, i].view(b, s, h, d) for i in range(3))
    got = flash_attention_bshd(q, k, v)
    torch.cuda.synchronize()
    want = flash_attention_bshd_plain(q, k, v)
    name = str(dtype).split(".")[-1]
    rec = {"kernel": "K1", "dtype": name, "shape": [b, s, h, d],
           "max_abs_err": (got.float() - want.float()).abs().max().item(),
           "tol": TOL[("K1", name)]}
    if timed:
        item = qkv.element_size()
        nbytes = 4 * b * s * h * d * item
        flops = 4 * b * h * d * s * (s + 1) / 2  # causal pairs only
        t, by = bound(nbytes, flops, name)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        rec.update(
            ms=time_ms(lambda: flash_attention_bshd(q, k, v)),
            plain_ms=time_ms(lambda: flash_attention_bshd_plain(q, k, v)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)),
            bound_ms=t * 1e3, bound_by=by)
    return rec


def _k5_inputs(dtype, gen):
    import torch
    S, H = DECODE["decode_slots"], MODEL["num_heads"]
    D = MODEL["model_dim"] // H
    B, N = DECODE["block_size"], DECODE["num_blocks"]
    P = -(-(DECODE["max_prompt_len"] + DECODE["max_new_tokens"]) // B)
    kp = torch.randn(N, B, H, D, device=DEVICE, generator=gen).to(dtype)
    vp = torch.randn(N, B, H, D, device=DEVICE, generator=gen).to(dtype)
    kp[0], vp[0] = 37.0, -53.0   # poisoned null block: never read
    # mid-generation contexts of the e2e requests, one idle slot
    lengths = [p + m // 2 for p, m in REQUESTS[:S - 1]] + [0]
    tables = torch.zeros(S, P, dtype=torch.int32)
    order = torch.randperm(N - 1, generator=torch.Generator().manual_seed(
        SEED)) + 1
    used = 0
    for i, n in enumerate(lengths):
        nb = -(-n // B)
        tables[i, :nb] = order[used:used + nb].int()
        used += nb
    qkv = torch.randn(S, 3, H * D, device=DEVICE, generator=gen).to(dtype)
    q = qkv[:, 0].view(S, H, D)
    return (q, kp, vp, tables.to(DEVICE),
            torch.tensor(lengths, dtype=torch.int32, device=DEVICE))


def _k5_case(dtype, gen, timed: bool) -> dict:
    import torch

    from distributedmnist_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_dense)
    q, kp, vp, tables, lengths = _k5_inputs(dtype, gen)
    got = paged_attention(q, kp, vp, tables, lengths)
    torch.cuda.synchronize()
    want = paged_attention_dense(q, kp, vp, tables, lengths)
    name = str(dtype).split(".")[-1]
    idle = lengths == 0
    check(torch.count_nonzero(got[idle]).item() == 0,
          "K5: an idle slot's output is not exactly zero")
    rec = {"kernel": "K5", "dtype": name, "slots": q.shape[0],
           "lengths": lengths.tolist(), "pages": list(kp.shape),
           "max_abs_err": (got - want).abs().max().item(),
           "tol": TOL[("K5", name)]}
    if timed:
        S, H, D = q.shape
        ctx = int(lengths.sum().item())
        item = kp.element_size()
        nbytes = (S * H * D * q.element_size() + 2 * ctx * H * D * item
                  + tables.numel() * 4 + S * 4 + S * H * D * 4)
        flops = 4 * ctx * H * D
        t, by = bound(nbytes, flops, name)
        rec.update(
            ms=time_ms(lambda: paged_attention(q, kp, vp, tables, lengths)),
            plain_ms=time_ms(lambda: paged_attention_dense(
                q, kp, vp, tables, lengths)),
            library_ms=None, bound_ms=t * 1e3, bound_by=by)
    return rec


def _allclose_err(got, want, tol) -> tuple[float, float]:
    """(max abs error, max of |got - want| / (atol + rtol |want|))."""
    atol, rtol = tol
    diff = (got.float() - want.float()).abs()
    return (diff.max().item(),
            (diff / (atol + rtol * want.float().abs())).max().item())


def _train_attn_inputs(b: int, s: int, dtype, gen):
    """The training path's attention inputs: strided q/k/v views of one
    [b, s, 3, d] qkv product, and a cotangent."""
    import torch
    h, d = MODEL["num_heads"], MODEL["model_dim"] // MODEL["num_heads"]
    qkv = torch.randn(b, s, 3, h * d, device=DEVICE, generator=gen).to(dtype)
    q, k, v = (qkv[:, :, i].view(b, s, h, d) for i in range(3))
    do = torch.randn(b, s, h, d, device=DEVICE, generator=gen).to(dtype)
    return q, k, v, do


def _attn_pairs(b: int, s: int) -> float:
    """Causal (query, key) pairs of one call, over every head."""
    return b * MODEL["num_heads"] * s * (s + 1) / 2


def _sdpa_ms(q, k, v, do) -> tuple[float, float]:
    """Library yardstick: forward and backward ms of
    ``F.scaled_dot_product_attention(is_causal=True)`` under autograd
    (backward = forward+backward - forward), on [b, h, s, d] copies."""
    import torch
    import torch.nn.functional as F
    qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    dos = do.transpose(1, 2).contiguous()
    fwd = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    fwd_ms = time_ms(fwd, iters=10)
    total_ms = time_ms(lambda: torch.autograd.grad(fwd(), (qs, ks, vs), dos),
                       iters=10)
    return fwd_ms, total_ms - fwd_ms


def _k1_lse_case(b: int, s: int, dtype, gen, timed: bool) -> dict:
    import torch

    from distributedmnist_tpu_torch.ops import flash_attention as fa
    q, k, v, do = _train_attn_inputs(b, s, dtype, gen)
    o, lse = fa.flash_attention_fwd_lse(q, k, v)
    torch.cuda.synchronize()
    want_o, want_lse = fa.flash_attention_fwd_lse_plain(q, k, v)
    name = str(dtype).split(".")[-1]
    err, ratio = _allclose_err(o, want_o, BWD_TOL[name])
    lse_err, lse_ratio = _allclose_err(lse, want_lse, BWD_TOL["lse"])
    rec = {"kernel": "K1-lse", "dtype": name, "shape": list(q.shape),
           "max_abs_err": err, "lse_max_abs_err": lse_err,
           "tol_ratio": max(ratio, lse_ratio),
           "tol": {"o": BWD_TOL[name], "lse": BWD_TOL["lse"]}}
    if timed:
        bb, ss, h, d = q.shape
        nbytes = 4 * bb * ss * h * d * q.element_size() + bb * h * ss * 4
        t, by = bound(nbytes, 4 * d * _attn_pairs(bb, ss), name)
        fwd_ms, bwd_ms = _sdpa_ms(q, k, v, do)
        rec.update(ms=time_ms(lambda: fa.flash_attention_fwd_lse(q, k, v)),
                   plain_ms=time_ms(
                       lambda: fa.flash_attention_fwd_lse_plain(q, k, v),
                       iters=10),
                   library_ms=fwd_ms, library_bwd_ms=bwd_ms,
                   bound_ms=t * 1e3, bound_by=by)
    return rec


# per kernel: the plain-backward outputs it computes, the [b, s, h, d]
# tensors it reads and writes, and its score-sized products (each
# 2·d FLOP a causal pair: q·kᵀ and do·vᵀ recomputed, then dq = ds·k /
# dv = pᵀ·do and dk = dsᵀ·q)
_BWD = {"K2": ((0,), 5, 1, 3), "K3": ((1, 2), 5, 2, 4),
        "K4": ((0, 1, 2), 5, 3, 5)}


def _bwd_case(kernel: str, b: int, s: int, dtype, gen,
              timed: bool) -> dict:
    import torch

    from distributedmnist_tpu_torch.ops import flash_attention as fa
    fn = {"K2": fa.flash_attention_bwd_dq, "K3": fa.flash_attention_bwd_dkv,
          "K4": fa.flash_attention_bwd_fused}[kernel]
    outs, n_in, n_out, products = _BWD[kernel]
    q, k, v, do = _train_attn_inputs(b, s, dtype, gen)
    o, lse = fa.flash_attention_fwd_lse_plain(q, k, v)
    got = fn(q, k, v, o, lse, do)
    got = got if isinstance(got, tuple) else (got,)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    name = str(dtype).split(".")[-1]
    errs = [_allclose_err(g, want[i], BWD_TOL[name])
            for g, i in zip(got, outs)]
    rec = {"kernel": kernel, "dtype": name, "shape": list(q.shape),
           "route": fa.backward_route(s),
           "max_abs_err": max(e for e, _ in errs),
           "tol_ratio": max(r for _, r in errs), "tol": BWD_TOL[name]}
    if timed:
        bb, ss, h, d = q.shape
        nbytes = ((n_in + n_out) * bb * ss * h * d * q.element_size()
                  + bb * h * ss * 4)
        t, by = bound(nbytes, products * 2 * d * _attn_pairs(bb, ss), name)
        _, bwd_ms = _sdpa_ms(q, k, v, do)
        rec.update(ms=time_ms(lambda: fn(q, k, v, o, lse, do)),
                   # the plain backward computes dq, dk and dv at once
                   plain_ms=time_ms(lambda: fa.flash_attention_bwd_plain(
                       q, k, v, o, lse, do), iters=10),
                   library_ms=bwd_ms, bound_ms=t * 1e3, bound_by=by)
    return rec


def phase_kernels() -> dict:
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        # the prefill buckets the e2e prompts fall into
        for s in (8, 32, 64, 128, 256, 512):
            cases.append(_k1_case(s, dtype, gen,
                                  timed=(dtype == torch.bfloat16
                                         and s == 512)))
        cases.append(_k5_case(dtype, gen, timed=dtype == torch.bfloat16))
    emit({"phase": "kernels", "cases": cases})
    for c in cases:
        check(c["max_abs_err"] <= c["tol"],
              f"{c['kernel']} {c['dtype']} disagrees with its plain "
              f"version: max abs err {c['max_abs_err']} > {c['tol']}")
    # the training kernels: bfloat16 (the path's dtype) at the full
    # training batch, timed; float32 at a batch of 2
    seq, batch = MODEL["seq_len"], TRAIN["data"]["batch_size"]
    train_cases = []
    for dtype, b, k4_b in ((torch.float32, 2, 4),
                           (torch.bfloat16, batch, K4_BATCH)):
        timed = dtype == torch.bfloat16
        train_cases.append(_k1_lse_case(b, seq, dtype, gen, timed))
        train_cases.append(_bwd_case("K2", b, seq, dtype, gen, timed))
        train_cases.append(_bwd_case("K3", b, seq, dtype, gen, timed))
        train_cases.append(_bwd_case("K4", k4_b, K4_SEQ, dtype, gen, timed))
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "cases": train_cases})
    for c in train_cases:
        check(c["tol_ratio"] <= 1.0,
              f"{c['kernel']} {c['dtype']} disagrees with its plain "
              f"version beyond atol + rtol |plain| {c['tol']}: "
              f"max abs err {c['max_abs_err']}")
    timed = {c["kernel"]: c for c in cases + train_cases if "ms" in c}
    return timed


# -- phase 4 ----------------------------------------------------------------

def _drive(port: int, prompts, tag: str) -> tuple[list, list, float]:
    from distributedmnist_tpu_torch.servesvc import ServeClient
    client = ServeClient([("127.0.0.1", port)], deadline_s=300.0)
    check(client.meta() is not None, "the replica answers no meta probe")
    outs: list = [None] * len(prompts)
    times: list = [[] for _ in prompts]

    def go(i):
        prompt, max_tokens = prompts[i]
        outs[i] = client.generate(
            prompt, request_id=f"{tag}-{i}", max_tokens=max_tokens,
            on_token=lambda rec: times[i].append(time.time()))

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(prompts))]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return outs, times, time.time() - t0


def _kernels_vs_plain(rep, prompt) -> float:
    """One prefill + 3 decode steps through the kernels and through
    their plain versions on the card; returns the max abs logit
    difference."""
    import torch

    from distributedmnist_tpu_torch.models import transformer
    from distributedmnist_tpu_torch.ops.flash_attention import (
        flash_attention_bshd, flash_attention_bshd_plain)
    from distributedmnist_tpu_torch.servesvc.kv_cache import PagedKVCache
    L, H, D = rep.model.decode_cache_shape
    bs, slots = DECODE["block_size"], DECODE["decode_slots"]
    plen = len(prompt)
    bucket = rep._bucket(plen, DECODE["max_prompt_len"])
    toks = torch.zeros(1, bucket, dtype=torch.int64, device=DEVICE)
    toks[0, :plen] = torch.tensor(prompt)
    runs = {}
    for kind, attn, kern in (("kernel", flash_attention_bshd, "paged"),
                             ("plain", flash_attention_bshd_plain, "dense")):
        cache = PagedKVCache(L, 16, bs, H, D, rep.cache.max_blocks_per_seq,
                             dtype=torch.bfloat16, device=DEVICE)
        logits, ks, vs = transformer.prefill_with_kv(
            rep._params, toks, num_heads=H, attention_fn=attn,
            compute_dtype=torch.bfloat16)
        table = cache.alloc_sequence(plen + 3)
        cache.write_prompt(table, ks[:, 0], vs[:, 0], plen)
        runs[kind] = dict(cache=cache, table=table,
                          logits=[logits[0, :plen]], kern=kern)
    tables = torch.zeros(slots, rep.cache.max_blocks_per_seq,
                         dtype=torch.int32, device=DEVICE)
    check((runs["kernel"]["table"] == runs["plain"]["table"]).all(),
          "the two fresh caches allocated different blocks")
    tables[0] = torch.from_numpy(runs["kernel"]["table"])
    nxt = int(torch.argmax(runs["kernel"]["logits"][0][-1]))
    for step in range(3):
        z = lambda dt: torch.zeros(slots, dtype=dt, device=DEVICE)
        tokens, positions, lengths = z(torch.int64), z(torch.int64), \
            z(torch.int32)
        tokens[0], positions[0], lengths[0] = nxt, plen + step, \
            plen + step + 1
        for r in runs.values():
            lg, _, _ = transformer.decode_step(
                rep._params, tokens, positions, r["cache"].k, r["cache"].v,
                tables, lengths, num_heads=H, block_size=bs,
                compute_dtype=torch.bfloat16, attention_kernel=r["kern"])
            r["logits"].append(lg[:1])
        nxt = int(torch.argmax(runs["kernel"]["logits"][-1][0]))
    return max(float((a - b).abs().max()) for a, b in
               zip(runs["kernel"]["logits"], runs["plain"]["logits"]))


def _profile_decode_step(rep, steps: int = 10) -> dict:
    """Where a decode iteration's time goes: ``torch.profiler`` over
    ``steps`` calls of the replica's ``decode_step`` with all slots live
    at the e2e requests' mid-generation lengths. Device busy time is
    the sum of kernel times (one stream, so kernels do not overlap);
    the idle share is 1 - busy / wall, with the wall timed over the same
    steps without the profiler (whose host overhead inflates it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    slots, bs = DECODE["decode_slots"], DECODE["block_size"]
    lengths = [p + m // 2 for p, m in REQUESTS][:slots]
    tables = [rep.cache.alloc_sequence(n) for n in lengths]
    check(all(t is not None for t in tables), "no free blocks to profile")
    dev = lambda a, dt: torch.tensor(a, dtype=dt, device=DEVICE)
    args = (dev([1] * slots, torch.int64),
            dev([n - 1 for n in lengths], torch.int64))
    tab = dev([t.tolist() for t in tables], torch.int32)
    lens = dev(lengths, torch.int32)

    def step():
        rep.model.decode_step(rep._params, *args, rep.cache.k, rep.cache.v,
                              tab, lens, block_size=bs,
                              attention_kernel=DECODE["attention_kernel"])

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        profiled_ms = (time.time() - t0) * 1e3 / steps
    for t in tables:
        rep.cache.free_sequence(t)
    by_class = {"paged_attention": 0.0, "gemm": 0.0, "other": 0.0}
    launches = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = e.key.lower()
        cls = ("paged_attention" if "paged_kernel" in name else
               "gemm" if any(k in name for k in ("gemm", "gemv", "xmma",
                                                 "cutlass", "nvjet"))
               else "other")
        by_class[cls] += us / 1e3 / steps
        launches += e.count
    busy = sum(by_class.values())
    return {"wall_ms": wall_ms, "wall_ms_under_profiler": profiled_ms,
            "device_busy_ms": busy if busy > 0 else "not measured",
            "device_idle_share": 1 - busy / wall_ms if busy > 0
            else "not measured",
            "busy_ms_by_class": by_class,
            "kernels_per_step": launches / steps}


# -- phases 4 and 5 ---------------------------------------------------------

def _counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel."""
    from distributedmnist_tpu_torch.ops import flash_attention as fa
    from distributedmnist_tpu_torch.ops.paged_attention import \
        paged_attention
    return {"K1": fa.flash_attention_bshd,
            "K1-lse": fa.flash_attention_fwd_lse,
            "K2": fa.flash_attention_bwd_dq,
            "K3": fa.flash_attention_bwd_dkv,
            "K4": fa.flash_attention_bwd_fused, "K5": paged_attention}


def reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in _counters().items()}


def _build_trainer(tmp: str, name: str, *overrides: str):
    """The Trainer ``launch train`` runs, built through its own CLI
    ``build_trainer`` from a config file."""
    from distributedmnist_tpu_torch.launch.__main__ import build_trainer
    path = f"{tmp}/{name}.json"
    with open(path, "w") as f:
        json.dump(TRAIN, f)
    return build_trainer(["train", "--config", path,
                          f"train.train_dir={tmp}/{name}", *overrides,
                          "--device", DEVICE])


def _copy_state(state):
    from distributedmnist_tpu_torch.parallel.api import tree_map
    clone = lambda t: t.clone()
    return dataclasses.replace(state, params=tree_map(clone, state.params),
                               momentum=tree_map(clone, state.momentum))


def _plain_attention():
    """The model's attention through the plain versions of K1-lse and
    K2/K3 on the card: the same forward-with-lse and FlashAttention-2
    backward the kernels compute, written in PyTorch."""
    import torch

    from distributedmnist_tpu_torch.ops import flash_attention as fa

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            o, lse = fa.flash_attention_fwd_lse_plain(q, k, v)
            ctx.save_for_backward(q, k, v, o, lse)
            return o

        @staticmethod
        def backward(ctx, do):
            return fa.flash_attention_bwd_plain(*ctx.saved_tensors, do)

    def attn(q, k, v):
        return Plain.apply(q, k, v)

    attn.layout = "bshd"
    return attn


def _step_vs_plain(trainer, batch) -> tuple[float, float]:
    """One train step through the kernels and one through their plain
    versions, from copies of the same state on the same batch: (|loss
    difference|, max |param difference| after the update)."""
    import torch

    from distributedmnist_tpu_torch.models import transformer
    from distributedmnist_tpu_torch.parallel.api import (build_train_step,
                                                         tree_leaves)
    attn = _plain_attention()
    cfg = trainer.model

    def plain_apply(params, tokens, positions=None, *, train=False):
        return transformer.apply(params, tokens, num_heads=MODEL["num_heads"],
                                 attention_fn=attn, positions=positions,
                                 compute_dtype=cfg.compute_dtype)

    plain_step = build_train_step(dataclasses.replace(cfg, apply=plain_apply),
                                  trainer.cfg, trainer.schedule)
    out = []
    for step_fn in (trainer.step_fn, plain_step):
        state, m = step_fn(_copy_state(trainer.state), batch)
        out.append((m["loss"].item(), tree_leaves(state.params)))
        torch.cuda.synchronize()
    (l1, p1), (l2, p2) = out
    return abs(l1 - l2), max((a - b).abs().max().item()
                             for a, b in zip(p1, p2))


def _time_steps(trainer, batch, steps: int = 5) -> float:
    """Device ms of one train step (CUDA events around ``steps``)."""
    import torch
    state = trainer.state
    state, _ = trainer.step_fn(state, batch)  # warm
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(steps):
        state, _ = trainer.step_fn(state, batch)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / steps


def _profile_train_step(trainer, batch, wall_ms: float,
                        steps: int = 3) -> dict:
    """``torch.profiler`` over ``steps`` train steps: device time by
    class (GEMMs, the attention kernels K1-lse/K2/K3/K4, every other
    kernel) and the idle share 1 - busy / wall, with the wall the
    unprofiled CUDA-event step time (one stream: kernels do not
    overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state = trainer.state
        for _ in range(steps):
            state, _ = trainer.step_fn(state, batch)
        torch.cuda.synchronize()
    by_class = {"gemm": 0.0, "attention": 0.0, "other": 0.0}
    launches = 0
    top = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = e.key.lower()
        cls = ("attention" if any(k in name for k in (
                   "flash_fwd_kernel", "bwd_dq_kernel", "bwd_dkv_kernel",
                   "bwd_fused_kernel")) else
               "gemm" if any(k in name for k in ("gemm", "gemv", "xmma",
                                                 "cutlass", "nvjet"))
               else "other")
        by_class[cls] += us / 1e3 / steps
        launches += e.count
        top.append((us / 1e3 / steps, e.key[:60]))
    busy = sum(by_class.values())
    return {"wall_ms": wall_ms,
            "device_busy_ms": busy if busy > 0 else "not measured",
            "device_idle_share": 1 - busy / wall_ms if busy > 0
            else "not measured",
            "busy_ms_by_class": by_class,
            "kernels_per_step": launches / steps,
            "top_kernels_ms": [[round(t, 3), k] for t, k in
                               sorted(top, reverse=True)[:8]]}


def phase_train(tmp: str) -> dict:
    import torch

    from distributedmnist_tpu_torch.data.pipeline import to_device
    from distributedmnist_tpu_torch.models.convert import params_to_reference
    from distributedmnist_tpu_torch.train import checkpoint as ckpt
    trainer = _build_trainer(tmp, "train")
    check(trainer.device.type == DEVICE, f"trainer on {trainer.device}")
    B, S = TRAIN["data"]["batch_size"], MODEL["seq_len"]
    tr = trainer.datasets.train
    batch = to_device({"image": tr.images[:B], "label": tr.labels[:B]},
                      trainer.device)
    loss_diff, param_diff = _step_vs_plain(trainer, batch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    reset_counts()
    t0 = time.time()
    summary = trainer.run(
        step_callback=lambda step, rec: losses.append(rec["loss"]))
    torch.cuda.synchronize()
    run_s = time.time() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    layers = MODEL["num_layers"]
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for k in ("K1-lse", "K2", "K3"):
        check(counts[k] == layers * TRAIN_STEPS,
              f"{k} launched {counts[k]} times in {TRAIN_STEPS} steps")
    check(counts["K4"] == counts["K1"] == counts["K5"] == 0,
          f"unexpected launches {counts}")
    saved, _, step = ckpt.restore_state(trainer.train_dir)
    check(step == TRAIN_STEPS and ckpt.params_digest(saved["params"])
          == summary["params_digest"]
          == ckpt.params_digest(params_to_reference(trainer.state.params)),
          "the checkpoint read back is not the trained params")
    reset_counts()
    ev = trainer.evaluate("test")
    eval_counts = read_counts()
    n_eval = -(-trainer.datasets.test.num_examples
               // TRAIN["eval"]["eval_batch_size"])
    check(eval_counts["K1"] == layers * n_eval
          and eval_counts["K1-lse"] == 0 and math.isfinite(ev["loss"]),
          f"eval: {ev}, launches {eval_counts}")
    ms = _time_steps(trainer, batch)
    profile = _profile_train_step(trainer, batch, ms)
    d, V = MODEL["model_dim"], MODEL["vocab_size"]
    # bench.py's count: fwd matmul FLOPs per token, x3 for fwd + bwd
    flops = 3 * (layers * (24 * d * d + 2 * S * d) + 2 * d * V) * B * S
    rec = {"phase": "train", "steps": TRAIN_STEPS, "batch": B, "seq": S,
           "first_loss": losses[0], "last_loss": losses[-1],
           "launches": counts, "per_step": {
               k: counts[k] / TRAIN_STEPS for k in ("K1-lse", "K2", "K3")},
           "step_vs_plain": {"loss_abs_diff": loss_diff,
                             "loss_tol": STEP_LOSS_TOL,
                             "param_max_abs_diff": param_diff,
                             "param_tol": STEP_PARAM_TOL},
           "checkpoint_step": step, "eval": ev, "eval_launches": eval_counts,
           "run_s": run_s, "ms_per_step": ms,
           "tokens_per_s": B * S / (ms / 1e3),
           "model_tflops_per_s": flops / (ms / 1e3) / 1e12,
           "peak_mem_gb": peak_gb, "profile": profile,
           "train_dir": str(trainer.train_dir)}
    emit(rec)
    check(loss_diff <= STEP_LOSS_TOL and param_diff <= STEP_PARAM_TOL,
          f"kernel step vs plain step: loss diff {loss_diff}, param diff "
          f"{param_diff}")
    return rec


def phase_train_k4(tmp: str) -> dict:
    import torch

    from distributedmnist_tpu_torch.ops.flash_attention import backward_route
    check(backward_route(K4_SEQ) == "fused", f"seq {K4_SEQ} is not one tile")
    trainer = _build_trainer(tmp, "train_k4", f"model.seq_len={K4_SEQ}",
                             f"data.batch_size={K4_BATCH}",
                             f"train.max_steps={K4_STEPS}")
    losses = []
    reset_counts()
    trainer.run(step_callback=lambda step, rec: losses.append(rec["loss"]))
    torch.cuda.synchronize()
    counts = read_counts()
    layers = MODEL["num_layers"]
    rec = {"phase": "train_k4", "steps": K4_STEPS, "seq": K4_SEQ,
           "batch": K4_BATCH, "losses": losses, "launches": counts,
           "per_step": {k: counts[k] / K4_STEPS for k in ("K1-lse", "K4")}}
    emit(rec)
    check(len(losses) == K4_STEPS and all(map(math.isfinite, losses)),
          f"losses {losses}")
    check(counts["K4"] == counts["K1-lse"] == layers * K4_STEPS
          and counts["K2"] == counts["K3"] == 0,
          f"launches {counts}")
    return rec


def phase_e2e(train_dir: str, tmp: str) -> dict:
    """Serve the checkpoint the training phase published."""
    import numpy as np
    import torch

    from distributedmnist_tpu_torch.launch.__main__ import \
        build_decode_replica
    from distributedmnist_tpu_torch.train.checkpoint import \
        latest_checkpoint_step

    rng = np.random.default_rng(SEED)
    prompts = [(rng.integers(0, MODEL["vocab_size"], p).tolist(), m)
               for p, m in REQUESTS]
    served_step = latest_checkpoint_step(train_dir)
    check(served_step == TRAIN_STEPS,
          f"the training checkpoint is at step {served_step}")
    torch.cuda.empty_cache()
    t0 = time.time()
    rep = build_decode_replica(["serve", "--decode", "--train-dir",
                                train_dir, "--serve-dir",
                                f"{tmp}/serve", "--device", DEVICE])
    rep.start()
    boot_s = time.time() - t0
    try:
        check(rep.device.type == DEVICE, f"replica on {rep.device}")
        # warm-up: every prompt bucket once (cuBLAS picks its
        # kernels per shape on first use), so the measured run is
        # the replica's steady state
        _drive(rep.bound_port, prompts, "warmup")
        reset_counts()
        pre0, it0 = rep.prefills, rep.decode_iterations
        outs, times, wall = _drive(rep.bound_port, prompts, "smoke")
        counts = read_counts()
        k1, k5 = counts["K1"], counts["K5"]
        prefills = rep.prefills - pre0
        iters = rep.decode_iterations - it0
        for (prompt, m), out in zip(prompts, outs):
            check(out is not None and out.get("status") == "ok",
                  f"request did not end ok: {out}")
            check(out["finish_reason"] == "max_tokens"
                  and len(out["tokens"]) == m,
                  f"expected {m} tokens, got {len(out['tokens'])} "
                  f"({out['finish_reason']})")
        layers = MODEL["num_layers"]
        check(prefills == len(prompts) and iters > 0,
              f"{prefills} prefills, {iters} decode iterations")
        check(k1 == layers * prefills,
              f"K1 launched {k1} times for {prefills} prefills")
        check(k5 == layers * iters,
              f"K5 launched {k5} times for {iters} decode iterations")
        check(counts["K1-lse"] == counts["K2"] == counts["K3"]
              == counts["K4"] == 0, f"training kernels ran: {counts}")
        firsts = []
        for (prompt, _), out in zip(prompts, outs):
            bucket = rep._bucket(len(prompt), DECODE["max_prompt_len"])
            toks = torch.zeros(1, bucket, dtype=torch.int64,
                               device=DEVICE)
            toks[0, :len(prompt)] = torch.tensor(prompt)
            logits, _, _ = rep.model.decode_prefill(rep._params, toks)
            firsts.append(int(torch.argmax(logits[0, len(prompt) - 1])))
        check(firsts == [o["tokens"][0] for o in outs],
              f"first tokens {[o['tokens'][0] for o in outs]} != "
              f"offline prefill argmax {firsts}")
        logit_err = _kernels_vs_plain(rep, prompts[2][0])
        profile = _profile_decode_step(rep)
    finally:
        rep.stop()
    check(logit_err <= E2E_LOGIT_TOL,
          f"kernels vs plain logits differ by {logit_err} > "
          f"{E2E_LOGIT_TOL}")
    tokens = sum(len(o["tokens"]) for o in outs)
    gaps = [b - a for ts in times for a, b in zip(ts, ts[1:])]
    rec = {"phase": "e2e", "requests": len(outs),
           "ok": sum(o["status"] == "ok" for o in outs), "tokens": tokens,
           "prefills": prefills, "decode_iterations": iters,
           "k1_launches": k1, "k5_launches": k5,
           "tokens_per_s": tokens / wall, "wall_s": wall,
           "ttft_p50_ms": statistics.median(o["ttft_ms"] for o in outs),
           "itl_p50_ms": statistics.median(gaps) * 1e3,
           "logits_max_abs_diff_kernels_vs_plain": logit_err,
           "logits_tol": E2E_LOGIT_TOL, "served_step": served_step,
           "boot_s": boot_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "decode_step_profile": profile}
    emit(rec)
    return rec


# (kernel, name, source, replaces, the phase whose launches it reports)
KERNELS = (
    ("K1", "flash_attention_fwd", "flash_attention_fwd.cu", "54", "e2e"),
    ("K1-lse", "flash_attention_fwd_lse", "flash_attention_fwd.cu", "54",
     "train"),
    ("K2", "flash_attention_bwd_dq", "flash_attention_bwd.cu", "296",
     "train"),
    ("K3", "flash_attention_bwd_dkv", "flash_attention_bwd.cu", "327",
     "train"),
    ("K4", "flash_attention_bwd_fused", "flash_attention_bwd.cu", "368",
     "train_k4"),
    ("K5", "paged_attention", "paged_attention.cu", None, "e2e"))


def main() -> int:
    phase = "env"
    runs = {}
    try:
        env = phase_env()
        phase = "build"
        phase_build()
        phase = "kernels"
        timed = phase_kernels()
        with tempfile.TemporaryDirectory(prefix="dmt_smoke_") as tmp:
            phase = "train"
            train = runs["train"] = phase_train(tmp)
            phase = "train_k4"
            runs["train_k4"] = phase_train_k4(tmp)
            phase = "e2e"
            e2e = runs["e2e"] = phase_e2e(train["train_dir"], tmp)
    except Exception as e:  # report the failing phase, then fail
        emit({"phase": phase, "ok": False,
              "error": f"{type(e).__name__}: {e}",
              "traceback": traceback.format_exc()[-4000:]})
        return 1
    import torch
    launches = {"e2e": {"K1": e2e["k1_launches"], "K5": e2e["k5_launches"]},
                "train": runs["train"]["launches"],
                "train_k4": runs["train_k4"]["launches"]}
    rows = []
    for key, name, src, line, path in KERNELS:
        c = timed[key]
        replaces = ("distributedmnist_tpu/ops/pallas_paged_attention.py:62"
                    if line is None else
                    f"distributedmnist_tpu/ops/pallas_attention.py:{line}")
        rows.append({"name": name, "route": "cuda",
                     "source": f"distributedmnist_tpu_torch/csrc/{src}",
                     "replaces": replaces, "launches": launches[path][key],
                     "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                     "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                     "bound_by": c["bound_by"],
                     "library_ms": c["library_ms"]})
    emit({"kernels": rows})
    print(env["nvidia_smi"] or "nvidia-smi: not available", flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
