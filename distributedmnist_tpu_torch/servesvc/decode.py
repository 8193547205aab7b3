"""Continuous-batching autoregressive decode replica (≙
``distributedmnist_tpu/servesvc/decode.py DecodeReplica``).

The replica holds ``decode.decode_slots`` concurrently generating
sequences over one paged KV cache (:mod:`.kv_cache`). Each loop
iteration runs ONE decode step over the fixed ``[slots]`` shape,
whatever mix of lengths is in flight — every sequence reads its K/V
through its block table — and a sequence that finishes (EOS /
max_tokens / deadline / client gone) frees its blocks and its slot is
refilled from the admission queue the same iteration.

**Prefill.** Prompts pad to power-of-2 buckets up to
``decode.max_prompt_len`` and run through the model's
``decode_prefill`` (the flash kernel K1 when
``model.attention_impl=flash``); its K/V are scattered into the
sequence's blocks and the first token samples off the prefill logits.

**Decode.** ``decode_step`` with ``decode.attention_kernel="paged"``
runs the paged-attention kernel K5 once per layer per iteration.

Wire protocol (one connection per request, line-delimited JSON):

  request:  {"id": ..., "prompt": [int, ...], "max_tokens": N,
             "temperature": t, "top_k": k, "deadline_ms": ...}
  stream:   {"id": ..., "stream": "token", "token": t, "index": i,
             "model_step": s}        (one line per generated token)
  terminal: {"id": ..., "status": "ok", "tokens": [...],
             "finish_reason": "eos" | "max_tokens" | "deadline" |
             "client_gone", "model_step": s, "started_step": s0}
            {"id": ..., "status": "rejected", "reason": ...}

The replica serves the checkpoint it booted with: hot-follow and the
``pin``/``restart`` mid-generation swap policies are not ported yet
(``swap_policy`` is validated and journaled, never exercised).
"""

from __future__ import annotations

import collections
import json
import queue
import time

import numpy as np
import torch

from ..core import prng
from ..core.config import ConfigError
from ..models.registry import sample_token
from .kv_cache import PagedKVCache
from .server import ServingReplica, _Pending


class _DecodeSeq(_Pending):
    """One in-flight generation (``inputs`` holds the prompt)."""

    __slots__ = ("max_tokens", "temperature", "top_k", "block_table",
                 "length", "tokens", "params_step", "started_step",
                 "first_token_at", "conn_dead", "sample_seed", "restarts")

    def __init__(self, req_id, prompt, conn, admitted_at, deadline_at):
        super().__init__(req_id, prompt, conn, admitted_at, deadline_at)
        self.max_tokens = 0
        self.temperature = 0.0
        self.top_k = 0
        self.block_table = None
        self.length = 0            # context tokens written to the cache
        self.tokens: list[int] = []
        self.params_step = -1
        self.started_step = -1
        self.first_token_at: float | None = None
        self.conn_dead = False
        self.sample_seed = 0
        self.restarts = 0          # mid-generation restarts (none yet)


class DecodeReplica(ServingReplica):
    """Serve a published causal-LM checkpoint as streaming generations
    with continuous batching over a paged KV cache."""

    def __init__(self, train_dir, serve_dir=".", scfg=None, dcfg=None,
                 cfg=None, device=None):
        super().__init__(train_dir, serve_dir=serve_dir, scfg=scfg,
                         cfg=cfg, device=device)
        if self.tier != "fp32":
            raise ConfigError(
                f"serve.precision_tier={self.tier!r}: the decode "
                "service serves full precision only")
        if (self.model.decode_prefill is None
                or self.model.decode_step is None):
            raise ConfigError(
                f"model {self.cfg.model.name!r} exports no decode step")
        self.dcfg = dcfg or self.cfg.decode
        self.dcfg.validate()
        if (self.dcfg.max_prompt_len + self.dcfg.max_new_tokens
                > self.cfg.model.seq_len):
            raise ConfigError(
                f"decode.max_prompt_len + decode.max_new_tokens = "
                f"{self.dcfg.max_prompt_len + self.dcfg.max_new_tokens} "
                f"exceeds model.seq_len={self.cfg.model.seq_len} (the "
                "learned position table is the hard context ceiling)")
        layers, heads, head_dim = self.model.decode_cache_shape
        self.cache = PagedKVCache(
            layers, self.dcfg.num_blocks, self.dcfg.block_size, heads,
            head_dim, self.dcfg.max_blocks_per_seq(),
            dtype=self.model.compute_dtype, device=self.device)
        # decode-loop-owned state (single writer: the worker thread)
        self._slots: list[_DecodeSeq | None] = (
            [None] * self.dcfg.decode_slots)
        self._waiting: collections.deque[_DecodeSeq] = collections.deque()
        self._seq_counter = 0
        self.sequences_finished = 0
        self.prefills = 0
        self.decode_iterations = 0
        # block-table upload cache: the [slots, width] table tensor only
        # changes on admit/finish, so it is rebuilt and uploaded once
        # per table epoch, not once per generated token
        self._tables_epoch = 0
        self._tables_cache: tuple[int, torch.Tensor] | None = None

    # -- admission ------------------------------------------------------

    def _build_item(self, req: dict, conn):
        req_id = req.get("id")
        try:
            prompt = np.asarray(req["prompt"], dtype=np.int64)
            if (prompt.ndim != 1 or prompt.size < 1
                    or prompt.size > self.dcfg.max_prompt_len):
                raise ValueError("prompt length out of range")
            if (int(prompt.min()) < 0
                    or int(prompt.max()) >= self.cfg.model.vocab_size):
                raise ValueError("token id out of vocab")
            max_tokens = int(req.get("max_tokens",
                                     self.dcfg.max_new_tokens))
            if not 1 <= max_tokens <= self.dcfg.max_new_tokens:
                raise ValueError("max_tokens out of range")
            temperature = float(req.get("temperature",
                                        self.dcfg.temperature))
            top_k = int(req.get("top_k", self.dcfg.top_k))
        except (KeyError, ValueError, TypeError, OverflowError):
            self._reject(conn, req_id, "bad_request", admitted=False)
            return None
        now = time.time()
        deadline_ms = req.get("deadline_ms",
                              self.scfg.default_deadline_ms)
        # streaming sends run on the single decode-loop thread: a client
        # that stopped reading costs the loop one short bounded stall
        # (then conn_dead), never a long timeout per token
        try:
            conn.settimeout(0.5)
        except OSError:
            pass
        seq = _DecodeSeq(req_id, prompt, conn, now,
                         now + float(deadline_ms) / 1e3)
        seq.max_tokens = max_tokens
        seq.temperature = temperature
        seq.top_k = top_k
        return seq

    def _pressure_fields(self) -> dict:
        alloc = self.cache.allocator
        return {**super()._pressure_fields(),
                "kv_blocks_free": alloc.available,
                "kv_blocks_total": alloc.num_blocks - 1,
                "kv_blocks_reserved": len(alloc.in_use),
                "decode_waiting": len(self._waiting)}

    # -- the decode loop ------------------------------------------------

    def _batch_loop(self) -> None:
        while not self._stop.is_set():
            self._admit_new()
            self._step_active()
            self._maybe_heartbeat()
        # graceful drain: in-flight generations, deferred admissions and
        # everything still queued get a TYPED terminal
        for i, s in enumerate(self._slots):
            if s is not None:
                self._slots[i] = None
                self.cache.free_sequence(s.block_table)
                self._reject(s.conn, s.req_id, "shutting_down",
                             admitted=True)
        while self._waiting:
            s = self._waiting.popleft()
            self._reject(s.conn, s.req_id, "shutting_down", admitted=True)
        while True:
            try:
                it = self._queue.get_nowait()
            except queue.Empty:
                break
            self._reject(it.conn, it.req_id, "shutting_down",
                         admitted=True)
        self._maybe_heartbeat()

    def _admit_new(self) -> None:
        """Refill free slots from the admission queue. Block pressure
        defers an admission (bounded by its deadline) rather than
        evicting a running generation."""
        idle = (not self._waiting
                and all(s is None for s in self._slots))
        try:
            # _waiting is capped at the slot count: anything beyond
            # stays in the bounded queue, which sheds `overloaded`
            while len(self._waiting) < self.dcfg.decode_slots:
                self._waiting.append(
                    self._queue.get(timeout=0.05) if idle
                    else self._queue.get_nowait())
                idle = False
        except queue.Empty:
            pass
        while self._waiting:
            free = next((i for i, s in enumerate(self._slots)
                         if s is None), None)
            if free is None:
                return
            s = self._waiting[0]
            if time.time() >= s.deadline_at:
                self._waiting.popleft()
                self._reject(s.conn, s.req_id, "deadline_exceeded",
                             admitted=True)
                continue
            table = self.cache.alloc_sequence(
                int(s.inputs.size) + s.max_tokens)
            if table is None:
                return  # block pressure: retry next iteration
            self._waiting.popleft()
            s.block_table = table
            s.params_step = s.started_step = self.model_step
            s.sample_seed = self._seq_counter
            self._seq_counter += 1
            self._slots[free] = s
            self._tables_epoch += 1
            self._prefill(s)

    def _prefill(self, s: _DecodeSeq) -> None:
        """Run the prompt through the prefill export, seed the paged
        cache, and sample + stream the first token."""
        t0 = time.time()
        plen = int(s.inputs.size)
        bucket = self._bucket(plen, self.dcfg.max_prompt_len)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :plen] = s.inputs
        logits, ks, vs = self.model.decode_prefill(
            self._params, torch.from_numpy(toks).to(self.device))
        self.cache.write_prompt(s.block_table, ks[:, 0], vs[:, 0], plen)
        self.prefills += 1
        s.length = plen
        tok = self._sample(s, logits[0, plen - 1].cpu())
        s.tokens.append(tok)
        self._stream_token(s, tok)
        self._journal({"action": "prefill", "id": s.req_id,
                       "prompt_len": plen, "bucket": bucket,
                       "blocks": int(np.count_nonzero(s.block_table)),
                       "model_step": s.params_step,
                       "ttft_ms": round((time.time() - t0) * 1e3, 3)})
        self._maybe_finish(self._slots.index(s), s)

    def _tables(self) -> torch.Tensor:
        """The device-resident [slots, width] block tables. Rows of idle
        slots are zero (the null block) — load-bearing: the step writes
        every slot's token K/V through its row, and zero routes idle
        writes into the reserved null block."""
        cached = self._tables_cache
        if cached is not None and cached[0] == self._tables_epoch:
            return cached[1]
        tables = np.zeros((self.dcfg.decode_slots,
                           self.cache.max_blocks_per_seq), np.int32)
        for i, s in enumerate(self._slots):
            if s is not None:
                tables[i] = s.block_table
        dev = torch.from_numpy(tables).to(self.device)
        self._tables_cache = (self._tables_epoch, dev)
        return dev

    def _step_active(self) -> None:
        """One decode iteration over the fixed slot shape, then per-slot
        sample / stream / finish — a finished slot is free for the next
        iteration's refill."""
        now = time.time()
        for i, s in enumerate(self._slots):
            if s is not None and now >= s.deadline_at:
                self._finish_seq(i, s, "deadline")
        active = [(i, s) for i, s in enumerate(self._slots)
                  if s is not None]
        if not active:
            return
        n = self.dcfg.decode_slots
        tokens = np.zeros((n,), np.int64)
        positions = np.zeros((n,), np.int64)
        lengths = np.zeros((n,), np.int32)
        for i, s in active:
            tokens[i] = s.tokens[-1]
            positions[i] = s.length
            lengths[i] = s.length + 1
        dev = lambda a: torch.from_numpy(a).to(self.device)
        logits, _, _ = self.model.decode_step(
            self._params, dev(tokens), dev(positions), self.cache.k,
            self.cache.v, self._tables(), dev(lengths),
            block_size=self.dcfg.block_size,
            attention_kernel=self.dcfg.attention_kernel)
        self.decode_iterations += 1
        logits = logits.cpu()
        for i, s in active:
            s.length += 1  # the fed token's K/V is now cached
            tok = self._sample(s, logits[i])
            s.tokens.append(tok)
            self._stream_token(s, tok)
            self._maybe_finish(i, s)

    def _sample(self, s: _DecodeSeq, logits_row: torch.Tensor) -> int:
        """≙ the reference's ``_sample``: the key for this token is
        ``fold_in(PRNGKey(sample_seed), len(tokens) + 1000·restarts)``."""
        if s.temperature <= 0.0:
            return int(sample_token(logits_row))
        key = prng.fold_in(prng.PRNGKey(s.sample_seed),
                           len(s.tokens) + 1000 * s.restarts)
        return int(sample_token(logits_row, key, temperature=s.temperature,
                                top_k=s.top_k))

    # -- streaming + termination ----------------------------------------

    def _send_line(self, s: _DecodeSeq, payload: dict) -> None:
        if s.conn_dead:
            return
        try:
            s.conn.sendall((json.dumps(payload) + "\n").encode())
        except OSError:
            s.conn_dead = True  # finish early at the next check

    def _stream_token(self, s: _DecodeSeq, tok: int) -> None:
        if s.first_token_at is None:
            s.first_token_at = time.time()
        self._send_line(s, {"id": s.req_id, "stream": "token",
                            "token": int(tok),
                            "index": len(s.tokens) - 1,
                            "model_step": s.params_step})

    def _maybe_finish(self, i: int, s: _DecodeSeq) -> None:
        eos = self.dcfg.eos_token
        if eos >= 0 and s.tokens and s.tokens[-1] == eos:
            self._finish_seq(i, s, "eos")
        elif len(s.tokens) >= s.max_tokens:
            self._finish_seq(i, s, "max_tokens")
        elif s.conn_dead:
            self._finish_seq(i, s, "client_gone")
        elif time.time() >= s.deadline_at:
            self._finish_seq(i, s, "deadline")

    def _finish_seq(self, i: int, s: _DecodeSeq, reason: str) -> None:
        """Exactly one terminal: journal the finish, send the final
        line, free the blocks and release the slot."""
        now = time.time()
        fields = {"reason": reason, "tokens_streamed": len(s.tokens),
                  "model_step": s.params_step,
                  "started_step": s.started_step,
                  "latency_ms": round((now - s.admitted_at) * 1e3, 3)}
        if s.first_token_at is not None:
            fields["ttft_ms"] = round(
                (s.first_token_at - s.admitted_at) * 1e3, 3)
        self._terminal("decode_finish", s.req_id, **fields)
        payload = {
            "id": s.req_id, "status": "ok",
            "tokens": [int(t) for t in s.tokens],
            "finish_reason": reason, "model_step": s.params_step,
            "started_step": s.started_step}
        self._dedup_put(s.req_id, payload)
        self._respond(s.conn, payload)
        self._slots[i] = None
        self.cache.free_sequence(s.block_table)
        self._tables_epoch += 1
        self.sequences_finished += 1

    # -- metadata / lifecycle -------------------------------------------

    def _meta(self) -> dict:
        return {"status": "ok", "meta": True, "decode": True,
                "model": self.cfg.model.name,
                "vocab_size": self.cfg.model.vocab_size,
                "model_step": self.model_step,
                "model_digest": self.model_digest,
                "precision_tier": self.tier,
                "active_tier": self.model_tier,
                "device": str(self.device),
                "decode_slots": self.dcfg.decode_slots,
                "block_size": self.dcfg.block_size,
                "num_blocks": self.dcfg.num_blocks,
                "max_prompt_len": self.dcfg.max_prompt_len,
                "max_new_tokens": self.dcfg.max_new_tokens,
                "eos_token": self.dcfg.eos_token,
                "swap_policy": self.dcfg.swap_policy}

    def start(self) -> None:
        super().start()
        self._journal({"action": "decode_start",
                       "slots": self.dcfg.decode_slots,
                       "block_size": self.dcfg.block_size,
                       "num_blocks": self.dcfg.num_blocks,
                       "max_prompt_len": self.dcfg.max_prompt_len,
                       "max_new_tokens": self.dcfg.max_new_tokens,
                       "swap_policy": self.dcfg.swap_policy,
                       "model_step": self.model_step})
