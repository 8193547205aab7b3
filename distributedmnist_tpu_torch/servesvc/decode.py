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
runs the paged-attention kernel K5 once per layer per live params
version per iteration. Each params version gets its own decode step
(:class:`DecodeStep`, ≙ the reference's one compiled step per live
version) at the fixed ``[slots]`` shape over static buffers: on the card,
with ``compile.precompile`` on, it is captured as a CUDA graph when the
version is put on the device and dropped with the version, and every
iteration writes the tokens, positions and lengths into its buffer with
one host-to-device copy, copies the version's block table in when the
table changed, and replays it; elsewhere the same body runs eagerly
over the same buffers. Each version's step leaves a ``compile`` record
in the replica's ``train_log.jsonl`` (its device, ``source``
``cuda_graph`` or ``eager`` with the reason, and the kernel build
cache's hits and misses over the capture). Prefill stays eager:
prompts vary in length.

**Weight swaps mid-generation.** The follower stages digest-verified
publishes as the classification replica's does; the flip happens at a
decode-loop boundary under ``decode.swap_policy``:

* ``pin`` — every sequence in flight keeps generating on the params it
  started with; new admissions use the new ones. Each live version runs
  its own decode step over the fixed slot shape, the other versions'
  slots masked by an all-zero block table and length 0 (their writes
  land in the null block, their rows are zeros), and a version is
  dropped when its last sequence finishes.
* ``restart`` — every sequence in flight is re-prefilled on the new
  params (a ``seq_restart`` record; the stream carries a ``restart``
  line so the client resets); its sampling key moves on by 1000 a
  restart.

The swap record carries ``sequences_pinned`` / ``sequences_restarted``:
the reference's ``decode_swap`` replay invariant checks that a
sequence finishing on another step than it started on holds a
``seq_restart`` licensed by an earlier ``weight_swap``.

Wire protocol (one connection per request, line-delimited JSON):

  request:  {"id": ..., "prompt": [int, ...], "max_tokens": N,
             "temperature": t, "top_k": k, "deadline_ms": ...}
  stream:   {"id": ..., "stream": "token", "token": t, "index": i,
             "model_step": s}        (one line per generated token)
            {"id": ..., "stream": "restart", "model_step": s}
  terminal: {"id": ..., "status": "ok", "tokens": [...],
             "finish_reason": "eos" | "max_tokens" | "deadline" |
             "client_gone", "model_step": s, "started_step": s0}
            {"id": ..., "status": "rejected", "reason": ...}
"""

from __future__ import annotations

import collections
import json
import queue
import time
import weakref

import numpy as np
import torch
import torch.distributed as dist

from ..core import prng
from ..core.compile_cache import resolve_cache_dir
from ..core.config import ConfigError
from ..models.convert import params_from_reference
from ..core.log import get_logger
from ..models.registry import sample_token
from ..ops.paged_attention import paged_attention
from ..parallel.api import tree_map
from ..parallel.graphs import aot_compile
from .kv_cache import PagedKVCache
from .server import OP_DECODE, OP_PREFILL, ServingReplica, _Pending

logger = get_logger("decode")


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
        self.restarts = 0          # mid-generation restarts


class _Version(dict):
    """One params version on the device: its params tree (the dict the
    model reads) and its :class:`DecodeStep` in ``decode``, which lives
    and dies with it."""

    decode: "DecodeStep | None" = None


class DecodeStep:
    """One params version's ``decode_step`` over the replica's paged cache
    at the fixed ``[slots]`` shape, reading static buffers: ``inputs``
    ``[3, slots]`` int64 (each slot's newest token, its position, the
    context length) and ``tables`` ``[slots, width]`` int32. On the card
    with ``capture`` it is a CUDA graph (:func:`..parallel.graphs.
    aot_compile`; its warm-up and capture run over all-zero tables and
    lengths, whose cache writes land in the null block); else its body
    runs eagerly over the same buffers. ``info`` is the capture's. The
    cache tensors, whose addresses the graph (and K5's tensor maps)
    hold, live as long as the replica.

    A replay launches K5 without calling its wrapper: ``k5_recorded``
    counts the wrapper calls a capture recorded into a graph (which
    launched nothing), ``k5_replayed`` the launches replays made, both
    over the process, as the wrapper's own count is."""

    k5_recorded = 0
    k5_replayed = 0

    def __init__(self, model, params: _Version, cache: PagedKVCache, dcfg,
                 device: torch.device, capture: bool,
                 cache_dir: str | None = None, step_fn=None,
                 eager_reason: str | None = None, verify: bool = False):
        slots = dcfg.decode_slots
        inputs = torch.zeros((3, slots), dtype=torch.int64, device=device)
        tables = torch.zeros((slots, cache.max_blocks_per_seq),
                             dtype=torch.int32, device=device)
        self.inputs, self.tables = inputs, tables
        self.staging = torch.zeros((3, slots), dtype=torch.int64,
                                   pin_memory=device.type == "cuda")
        self.table_key = None
        # the params are read through a weak reference: the version owns
        # this step, not the other way round
        ref = weakref.ref(params)
        block_size, kernel = dcfg.block_size, dcfg.attention_kernel
        step_fn = step_fn or model.decode_step

        def body():
            k5 = paged_attention.launches
            logits, _, _ = step_fn(
                ref(), inputs[0], inputs[1], cache.k, cache.v, tables,
                inputs[2].to(torch.int32), block_size=block_size,
                attention_kernel=kernel)
            self.k5_a_step = paged_attention.launches - k5
            return logits

        self.body = body
        self.k5_a_step = 0
        if not capture:
            eager_reason = "compile.precompile is off"
        self.replay, self.info = aot_compile(
            {"decode": body}, device, cache_dir=cache_dir,
            eager_reason=eager_reason)
        if self.replay is not None:
            # the last call of the body was the capture's
            DecodeStep.k5_recorded += self.k5_a_step
            if verify:
                self._verify()

    def _verify(self) -> None:
        """Hold the captured step to the eager body on the same buffers
        (all-zero tables and lengths: the writes land in the null block)
        and drop the graph unless the two agree bitwise, saying so in
        ``info``. Every rank of a group runs both, in one order."""
        replayed = self.replay.replay("decode").clone()
        DecodeStep.k5_replayed += self.k5_a_step
        eager = self.body()
        self.info["bitwise_vs_eager"] = bool(torch.equal(replayed, eager))
        if not self.info["bitwise_vs_eager"]:
            self.replay = None
            self.info.update(source="eager", reason="the captured step "
                             "differs from the eager one")

    def __call__(self, tokens: np.ndarray, positions: np.ndarray,
                 lengths: np.ndarray, table: torch.Tensor,
                 table_key) -> torch.Tensor:
        """Logits ``[slots, vocab]`` (on the host) for one step: the
        per-slot numbers in one copy, ``table`` copied in when
        ``table_key`` differs from the last one's. Reading the logits
        back waits for the step, so the staging buffer is free again."""
        host = self.staging.numpy()
        host[0], host[1], host[2] = tokens, positions, lengths
        self.inputs.copy_(self.staging, non_blocking=True)
        if table_key != self.table_key:
            self.tables.copy_(table)
            self.table_key = table_key
        if self.replay is not None:
            out = self.replay.replay("decode")
            DecodeStep.k5_replayed += self.k5_a_step
        else:
            out = self.body()
        return out.cpu()


class DecodeReplica(ServingReplica):
    """Hot-follow published causal-LM checkpoints and stream
    generations with continuous batching over a paged KV cache."""

    def __init__(self, train_dir, serve_dir=".", scfg=None, dcfg=None,
                 cfg=None, device=None, topo=None):
        super().__init__(train_dir, serve_dir=serve_dir, scfg=scfg,
                         cfg=cfg, device=device, topo=topo)
        if self.tier != "fp32":
            raise ConfigError(
                f"serve.precision_tier={self.tier!r}: the decode "
                "service serves full precision only")
        if (self.model.decode_prefill is None
                or self.model.decode_step is None):
            raise ConfigError(
                f"model {self.cfg.model.name!r} exports no decode step "
                "(decode needs a dense-FFN causal LM; MoE and "
                "classifier families have no incremental export)")
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
        if self.tp:
            # this rank's heads; the allocator that hands out its blocks
            # runs on rank 0, whose tables every rank follows
            heads //= self.topo.model_parallelism
            self._prefill_fn, self._step_fn = self.model.tp_decode_factory(
                self.topo.model_group, self.topo.comm)
        else:
            # the model's own, looked up at each use
            self._prefill_fn = self._step_fn = None
        self.cache = PagedKVCache(
            layers, self.dcfg.num_blocks, self.dcfg.block_size, heads,
            head_dim, self.dcfg.max_blocks_per_seq(),
            dtype=self.model.compute_dtype, device=self.device)
        # decode-loop-owned state (single writer: the worker thread)
        self._slots: list[_DecodeSeq | None] = (
            [None] * self.dcfg.decode_slots)
        self._waiting: collections.deque[_DecodeSeq] = collections.deque()
        # the fewest free blocks since the last heartbeat (None: no
        # admission pass since): what the heartbeat reports
        self._kv_free_low: int | None = None
        self._versions: dict[int, object] = {}  # pinned older params
        self._seq_counter = 0
        self.sequences_finished = 0
        self.prefills = 0            # first prefills (admissions)
        self.restarts = 0            # re-prefills under ``restart``
        self.decode_iterations = 0   # loop iterations with a slot live
        self.version_steps = 0       # decode steps: one a live version
        # block-table upload cache: a version's [slots, width] tables
        # change only on admit/finish/restart, so they are rebuilt and
        # uploaded once per (version, table epoch), not once per token
        self._tables_epoch = 0
        self._tables_cache: dict[tuple[int, int], torch.Tensor] = {}
        # each version's decode-step info, as made (source, compile_s)
        self.decode_compiles: list[dict] = []
        self._eager_logged = False
        # a TP rank's decode steps, the all-reduces they staged through
        # the host and the broadcasts that carried them
        self.decode_steps = self.decode_staged = self.decode_broadcasts = 0

    def _params_on_device(self, tree: dict):
        """Params in the model's compute dtype, cast once here so the
        per-call casts inside the model are no-ops, with their decode
        step (captured here on the card, off the decode loop)."""
        params = _Version(params_from_reference(
            tree, device=self.device, dtype=self.model.compute_dtype))
        self._prepare_version(params)
        return params

    def _place(self, shard):
        """A TP rank's shard in the compute dtype on the device; its
        decode step is made at the group's install
        (:meth:`_prepare_version`), on every rank at once."""
        dt = self.model.compute_dtype
        return _Version(tree_map(lambda t: t.to(self.device, dt), shard))

    def _prepare_version(self, params) -> None:
        """A version's decode step. Under a TP group the step's
        all-reduces go through the group: over gloo they run on the
        host, outside any CUDA graph, so the step runs eagerly (said in
        its ``compile`` record); over NCCL it is captured and held to
        the eager step bitwise before it serves."""
        capture = self.cfg.compile.precompile
        cache_dir = resolve_cache_dir(self.cfg.compile)
        eager_reason = None
        if (self.tp and self.device.type == "cuda"
                and dist.get_backend(self.topo.model_group) == "gloo"):
            eager_reason = ("tensor-parallel group over gloo: the step's "
                            "all-reduces run on the host, outside a CUDA "
                            "graph")
            if not self._eager_logged:
                self._eager_logged = True
                logger.info("decode steps run eagerly: %s", eager_reason)
        make = lambda capture: DecodeStep(  # noqa: E731
            self.model, params, self.cache, self.dcfg, self.device,
            capture, cache_dir=cache_dir, step_fn=self._step_fn,
            eager_reason=eager_reason, verify=self.tp)
        try:
            params.decode = make(capture)
        except Exception as e:  # the version must still serve
            if self.tp:
                raise  # the other ranks captured: the group must agree
            logger.warning("decode step capture failed (%s: %s): the "
                           "version runs eagerly", type(e).__name__, e)
            params.decode = make(False)
            params.decode.info["error"] = f"{type(e).__name__}: {e}"
        self.decode_compiles.append(params.decode.info)
        # the boot log says how each version's step runs, as a
        # trainer's does: a version served eagerly says so, and why
        with self._journal_lock:
            if not self._journal_closed:
                self._heartbeat.write({
                    "event": "compile", "time": time.time(),
                    "stage": "decode_step", "device": str(self.device),
                    **params.decode.info})

    def kernel_launches(self) -> dict[str, int]:
        """As the classification replica's, with K5 counted on the
        device: the wrapper's calls less those a capture recorded into
        a graph, plus the launches the graphs' replays made."""
        out = super().kernel_launches()
        out["K5"] += DecodeStep.k5_replayed - DecodeStep.k5_recorded
        return out

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

    # -- weights: version registry + swap policies ----------------------

    def _params_for(self, step: int):
        if self.tp and self.topo.rank > 0:
            return self._held[step]
        return (self._params if step == self.model_step
                else self._versions[step])

    def _release_version(self, step: int) -> None:
        if step == self.model_step or step not in self._versions:
            return
        if not any(s is not None and s.params_step == step
                   for s in self._slots):
            self._versions.pop(step).decode = None  # its graph with it
            self._group_flipped(step)

    def _follow_op(self, op: int, f: list[int]) -> None:
        """A follower's share of a prefill and of a decode step (rank
        0's tables and tokens; this rank's heads and cache)."""
        if op == OP_PREFILL:
            ver, bucket, plen, width = f[:4]
            toks = self._group_recv((1, bucket), torch.int64)
            table = self._group_recv((width,), torch.int32)
            self._run_prefill(ver, toks, table, plen)
        elif op == OP_DECODE:
            ver, slots, width, epoch, fresh = f[:5]
            inputs = self._group_recv((3, slots), torch.int64)
            key = (ver, epoch)
            if fresh:
                table = self._group_recv((slots, width), torch.int32)
                for k in [k for k in self._tables_cache if k[1] < epoch]:
                    del self._tables_cache[k]
                self._tables_cache[key] = torch.from_numpy(table).to(
                    self.device)
            self.decode_broadcasts += 2 + fresh
            self._decode(ver, inputs[0], inputs[1],
                         inputs[2].astype(np.int32), self._tables_cache[key],
                         key)
        else:
            super()._follow_op(op, f)

    def _decode(self, ver: int, tokens, positions, lengths,
                table: torch.Tensor, key) -> torch.Tensor:
        """One decode step of version ``ver`` (its logits on the host),
        counting under a TP group the all-reduces it staged through the
        host."""
        staged = self.topo.comm.staged_all_reduces if self.tp else 0
        logits = self._params_for(ver).decode(tokens, positions, lengths,
                                              table, key)
        if self.tp:
            self.decode_steps += 1
            self.decode_staged += (self.topo.comm.staged_all_reduces
                                   - staged)
        return logits

    def _group_counts(self) -> dict:
        """The TP rank's counts, with its decode steps, the all-reduces
        they staged through the host and the work broadcasts they took."""
        out = super()._group_counts()
        if self.tp:
            out.update(decode_steps=self.decode_steps,
                       decode_all_reduces_staged=self.decode_staged,
                       decode_broadcasts=self.decode_broadcasts)
        return out

    def _run_prefill(self, ver: int, toks: np.ndarray, table: np.ndarray,
                     plen: int) -> torch.Tensor:
        """The prefill of one padded prompt on version ``ver``, its K/V
        written to the sequence's blocks: the logits."""
        prefill = self._prefill_fn or self.model.decode_prefill
        logits, ks, vs = prefill(
            self._params_for(ver), torch.from_numpy(toks).to(self.device))
        self.cache.write_prompt(table, ks[:, 0], vs[:, 0], plen)
        return logits

    def _maybe_swap(self) -> None:
        """Decode-loop-boundary flip under ``decode.swap_policy``;
        journals the swap with its per-sequence bookkeeping."""
        with self._staged_lock:
            staged, self._staged = self._staged, None
        if staged is None:
            return
        install, t0 = staged
        if install["step"] <= self.model_step:
            return  # monotone: never swap backwards
        ready = self._group_ready(install)
        if ready is None:
            self._restage(staged)
        if not ready:
            return
        in_flight = [s for s in self._slots if s is not None]
        prev_step = self.model_step
        pinned = restarted = 0
        if in_flight:
            if self.dcfg.swap_policy == "pin":
                pinned = len(in_flight)
                if any(s.params_step == prev_step for s in in_flight):
                    # keep only a version something runs on: swaps back
                    # to back must not leak the middle one
                    self._versions[prev_step] = self._params
            else:
                restarted = len(in_flight)
        self._install(install, t0,
                      extra={"sequences_pinned": pinned,
                             "sequences_restarted": restarted})
        if prev_step not in self._versions:
            self._group_flipped(prev_step)
        if restarted:
            for s in in_flight:
                self._restart_seq(s, prev_step)

    def _restart_seq(self, s: _DecodeSeq, from_step: int) -> None:
        """The restart policy's move for one sequence: discard what the
        old params generated and re-prefill on the new, journaled as the
        license the ``decode_swap`` invariant requires."""
        self._journal({"action": "seq_restart", "id": s.req_id,
                       "from_step": from_step,
                       "to_step": self.model_step,
                       "tokens_discarded": len(s.tokens)})
        self._send_line(s, {"id": s.req_id, "stream": "restart",
                            "model_step": self.model_step})
        s.tokens = []
        s.length = 0
        s.restarts += 1
        s.params_step = self.model_step
        self._bump_tables_epoch()
        # the time to first token is the kept stream's: the discarded
        # first token does not count
        s.first_token_at = None
        self._prefill(s, restart=True)

    def _bump_tables_epoch(self) -> None:
        self._tables_epoch += 1
        self._tables_cache.clear()

    def _note_kv_low(self) -> None:
        """Lower the pool's low-water mark to its free blocks now (after
        an admission pass, when the pool is fullest)."""
        free = self.cache.allocator.available
        if self._kv_free_low is None or free < self._kv_free_low:
            self._kv_free_low = free

    def _pressure_fields(self) -> dict:
        """The heartbeat's pressure fields. ``kv_blocks_free`` is the
        pool's low-water mark since the previous heartbeat, not its
        state at this one: a heartbeat lands at a completion, after the
        finishing sequences freed their blocks, and sequences admitted
        in one pass finish in one step, so under any load the pool can
        read empty just then (the reference reports that reading, and
        its broker's ``kv_free_frac`` then misses a full pool). The mark
        restarts from the pool's state at each heartbeat."""
        alloc = self.cache.allocator
        free = alloc.available
        if self._kv_free_low is not None:
            free = min(free, self._kv_free_low)
        self._kv_free_low = None
        return {**super()._pressure_fields(),
                "kv_blocks_free": free,
                "kv_blocks_total": alloc.num_blocks - 1,
                "kv_blocks_reserved": len(alloc.in_use),
                "decode_waiting": len(self._waiting)}

    # -- the decode loop ------------------------------------------------

    def _batch_loop(self) -> None:
        while not self._stop.is_set():
            self._maybe_swap()
            self._admit_new()
            self._note_kv_low()
            self._step_active()
            self._group_idle()
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
            self._bump_tables_epoch()
            self._prefill(s)

    def _prefill(self, s: _DecodeSeq, restart: bool = False) -> None:
        """Run the prompt through the prefill export on the sequence's
        params version, seed the paged cache, and sample + stream the
        first token."""
        t0 = time.time()
        plen = int(s.inputs.size)
        bucket = self._bucket(plen, self.dcfg.max_prompt_len)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :plen] = s.inputs
        if self.tp:
            self._group_send(OP_PREFILL, s.params_step, bucket, plen,
                             s.block_table.size,
                             payloads=(toks, s.block_table))
        logits = self._run_prefill(s.params_step, toks, s.block_table, plen)
        if restart:
            self.restarts += 1
        else:
            self.prefills += 1
        s.length = plen
        tok = self._sample(s, logits[0, plen - 1].cpu())
        s.tokens.append(tok)
        self._stream_token(s, tok)
        rec = {"action": "prefill", "id": s.req_id, "prompt_len": plen,
               "bucket": bucket,
               "blocks": int(np.count_nonzero(s.block_table)),
               "model_step": s.params_step,
               "ttft_ms": round((time.time() - t0) * 1e3, 3)}
        if restart:
            rec["restart"] = True
        self._journal(rec)
        self._maybe_finish(self._slots.index(s), s)

    def _table_rows(self, mine) -> np.ndarray:
        """The [slots, width] block tables of the slots ``mine``, the
        other rows zero."""
        tables = np.zeros((self.dcfg.decode_slots,
                           self.cache.max_blocks_per_seq), np.int32)
        for i, s in mine:
            tables[i] = s.block_table
        return tables

    def _tables_for(self, ver: int, mine,
                    rows: np.ndarray | None = None) -> torch.Tensor:
        """The device-resident [slots, width] block tables of one params
        version's step (``rows`` when already built). Rows of slots not
        on this version are zero (the null block) — load-bearing: the
        step writes every slot's token K/V through its row, and zero
        routes those writes into the reserved null block instead of a
        live sequence's first block."""
        key = (ver, self._tables_epoch)
        cached = self._tables_cache.get(key)
        if cached is not None:
            return cached
        if rows is None:
            rows = self._table_rows(mine)
        dev = self._tables_cache[key] = torch.from_numpy(rows).to(
            self.device)
        return dev

    def _step_active(self) -> None:
        """One decode iteration: a decode step per live params version
        over the fixed slot shape, then per-slot sample / stream /
        finish — a finished slot is free for the next iteration's
        refill."""
        now = time.time()
        for i, s in enumerate(self._slots):
            if s is not None and now >= s.deadline_at:
                self._finish_seq(i, s, "deadline")
        active = [(i, s) for i, s in enumerate(self._slots)
                  if s is not None]
        if not active:
            return
        n = self.dcfg.decode_slots
        self.decode_iterations += 1
        # pin: one step per live version (at most a handful); slots of
        # other versions read length 0 through the null table
        for ver in sorted({s.params_step for _, s in active}):
            mine = [(i, s) for i, s in active if s.params_step == ver]
            tokens = np.zeros((n,), np.int64)
            positions = np.zeros((n,), np.int64)
            lengths = np.zeros((n,), np.int32)
            for i, s in mine:
                tokens[i] = s.tokens[-1]
                positions[i] = s.length
                lengths[i] = s.length + 1
            key = (ver, self._tables_epoch)
            rows = None
            if self.tp:
                # the followers get this version's tables when they change
                fresh = key not in self._tables_cache
                rows = self._table_rows(mine) if fresh else None
                self._group_send(
                    OP_DECODE, ver, n, self.cache.max_blocks_per_seq,
                    self._tables_epoch, int(fresh),
                    payloads=((np.stack([tokens, positions,
                                         lengths.astype(np.int64)]),)
                              + ((rows,) if fresh else ())))
                self.decode_broadcasts += 2 + fresh
            logits = self._decode(ver, tokens, positions, lengths,
                                  self._tables_for(ver, mine, rows), key)
            self.version_steps += 1
            for i, s in mine:
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
        if s.restarts:
            fields["restarts"] = s.restarts
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
        self._bump_tables_epoch()
        self._release_version(s.params_step)
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
