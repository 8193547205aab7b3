#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU (H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``distributedmnist_tpu_torch/
csrc`` and drives the port's main path — the decode-serving replica of
``python -m distributedmnist_tpu_torch.launch serve --decode`` — at the
full width of the widest transformer the repository runs (d_model
2048, 16 heads of 128, 4 layers, seq_len 1024, vocab 1024, bf16
compute; 8 decode slots, 16-token blocks, 320 blocks, prompts up to
512, up to 64 new tokens), with random weights from a seed.

One JSON line per phase:

1. ``env``     — the card, torch and CUDA versions; fails without CUDA
               or without the port package beside this script.
2. ``build``   — seconds to compile every kernel (one nvcc per source,
               all at once).
3. ``kernels`` — each kernel (K1 flash-attention forward, K5 paged
               attention) against its plain PyTorch version on the
               card at the main path's shapes, float32 and bfloat16:
               max abs error beside the stated tolerance, kernel /
               plain / library times (CUDA events), and the bound.
4. ``e2e``     — publishes a full-width checkpoint, boots the replica
               through the CLI's own builder, streams 8 concurrent
               greedy requests over its socket, and checks: an ``ok``
               terminal with exactly ``max_tokens`` tokens for each;
               each first token equal to the argmax of an offline
               prefill of its prompt; the K1 and K5 launch counters
               grown by 4 per prefill and 4 per decode iteration; one
               prefill plus 3 decode steps through the kernels within a
               stated tolerance of the plain versions. Prints tokens/s,
               TTFT p50 and inter-token p50.

Then a ``kernels`` summary line, the card's name and power limit as
``nvidia-smi`` reports them, and, last, the result line
``{"ok": true, "device": {...}}``. Any failure prints the failing
phase and exits nonzero before the result line.
"""

from __future__ import annotations

import json
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
    timed = {c["kernel"]: c for c in cases if "ms" in c}
    return timed


# -- phase 4 ----------------------------------------------------------------

def _publish(train_dir: str, cfg) -> float:
    import torch

    from distributedmnist_tpu_torch.models.convert import params_to_reference
    from distributedmnist_tpu_torch.models.registry import get_model
    from distributedmnist_tpu_torch.train.checkpoint import save_checkpoint
    t0 = time.time()
    model = get_model(cfg.model)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(SEED))
    save_checkpoint(train_dir, params_to_reference(params), 1,
                    extra={"config": cfg.to_dict()})
    return time.time() - t0


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


def phase_e2e() -> dict:
    import numpy as np
    import torch

    from distributedmnist_tpu_torch.core.config import ExperimentConfig
    from distributedmnist_tpu_torch.launch.__main__ import \
        build_decode_replica
    from distributedmnist_tpu_torch.ops.flash_attention import \
        flash_attention_bshd
    from distributedmnist_tpu_torch.ops.paged_attention import \
        paged_attention

    cfg = ExperimentConfig.from_dict({
        "model": MODEL, "decode": DECODE,
        "serve": {"default_deadline_ms": 300000.0}})
    rng = np.random.default_rng(SEED)
    prompts = [(rng.integers(0, MODEL["vocab_size"], p).tolist(), m)
               for p, m in REQUESTS]
    with tempfile.TemporaryDirectory(prefix="dmt_smoke_") as tmp:
        publish_s = _publish(f"{tmp}/train", cfg)
        torch.cuda.empty_cache()
        t0 = time.time()
        rep = build_decode_replica(["serve", "--decode", "--train-dir",
                                    f"{tmp}/train", "--serve-dir",
                                    f"{tmp}/serve", "--device", DEVICE])
        rep.start()
        boot_s = time.time() - t0
        try:
            check(rep.device.type == DEVICE, f"replica on {rep.device}")
            # warm-up: every prompt bucket once (cuBLAS picks its
            # kernels per shape on first use), so the measured run is
            # the replica's steady state
            _drive(rep.bound_port, prompts, "warmup")
            flash_attention_bshd.launches = 0
            paged_attention.launches = 0
            pre0, it0 = rep.prefills, rep.decode_iterations
            outs, times, wall = _drive(rep.bound_port, prompts, "smoke")
            k1, k5 = flash_attention_bshd.launches, paged_attention.launches
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
           "logits_tol": E2E_LOGIT_TOL, "publish_s": publish_s,
           "boot_s": boot_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "decode_step_profile": profile}
    emit(rec)
    return rec


def main() -> int:
    phase = "env"
    try:
        env = phase_env()
        phase = "build"
        phase_build()
        phase = "kernels"
        timed = phase_kernels()
        phase = "e2e"
        e2e = phase_e2e()
    except Exception as e:  # report the failing phase, then fail
        emit({"phase": phase, "ok": False,
              "error": f"{type(e).__name__}: {e}",
              "traceback": traceback.format_exc()[-4000:]})
        return 1
    import torch
    rows = []
    for key, name, source, replaces, launches in (
            ("K1", "flash_attention_fwd",
             "distributedmnist_tpu_torch/csrc/flash_attention_fwd.cu",
             "distributedmnist_tpu/ops/pallas_attention.py:54",
             e2e["k1_launches"]),
            ("K5", "paged_attention",
             "distributedmnist_tpu_torch/csrc/paged_attention.cu",
             "distributedmnist_tpu/ops/pallas_paged_attention.py:62",
             e2e["k5_launches"])):
        c = timed[key]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches,
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
