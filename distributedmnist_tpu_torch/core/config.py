"""Typed experiment configuration — the port's own copy of the schema.

A field-for-field copy of ``distributedmnist_tpu/core/config.py``: a run
config saved in a reference checkpoint's ``extra["config"]`` parses
here exactly as it does there (same sections, same defaults, the same
``ConfigError`` on an unknown key). The port imports nothing of the JAX
package, so the schema is kept twice; ``tests/test_torch_checkpoint.py``
pins the two copies to the same ``to_dict()``.

Frozen dataclasses, safe literal config files (JSON or Python literals
via ``ast.literal_eval``, never ``eval``), and dotted-path CLI
overrides. Comments that name TPU-side mechanisms describe the
reference package, which owns those knobs' behaviour.
"""

from __future__ import annotations

import ast
import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


class ConfigError(ValueError):
    pass


@dataclass(frozen=True)
class DataConfig:
    """Dataset selection and ingest policy (≙ src/mnist_data.py)."""

    dataset: str = "mnist"  # mnist | fashion_mnist | cifar10 | synthetic
    data_dir: str = "/tmp/dmt_data"
    # Global batch size across all replicas. The reference's
    # ``batch_size`` flag (src/distributed_train.py:63) is *per worker*;
    # here per-replica batch = batch_size // num_replicas.
    batch_size: int = 128
    # "sharded": deterministic per-host split (fixes the reference's
    # ignored worker_id/n_workers args, src/mnist_data.py:156-163,212-213).
    # "independent": each replica samples its own shuffle of the full
    # train set — faithful to the reference's behavior
    # (src/mnist_data.py:55,80-84).
    shard_mode: str = "sharded"
    # Synthetic-data fallback (≙ the latent fake_data fixture,
    # src/mnist_data.py:164-172) — also the default when no idx files
    # exist on disk (this environment has no network egress).
    synthetic_train_size: int = 8192
    synthetic_test_size: int = 2048
    use_native_pipeline: bool = True  # C++ prefetch loader when built
    prefetch_batches: int = 2
    # Device-side prefetch (data.device_prefetch): stage batches
    # through Topology.device_put_batch on a producer thread, a
    # bounded queue of device_prefetch_depth ahead of the consuming
    # step — host assembly + H2D overlap device compute instead of
    # sitting on its critical path (data/device_prefetch.py). Enabled
    # by default where a producer thread pays: a spare host core, or a
    # real accelerator backend whose drains park the host GIL-free
    # (single-core CPU-backend hosts fall back to the inline feed, per
    # the same measurement behind the native-pipeline gate).
    device_prefetch: bool = True
    device_prefetch_depth: int = 2

    def effective_device_prefetch_depth(self) -> int:
        """The depth eval paths should stage ahead — 0 (inline feed)
        whenever the enable knob is off. One definition, so Trainer
        eval and the evaluator service can't drift."""
        return self.device_prefetch_depth if self.device_prefetch else 0
    # Fetch missing idx files into data_dir before loading
    # (≙ maybe_download, src/mnist_data.py:176-187). Degrades to the
    # synthetic fallback when there is no network egress.
    download: bool = True


@dataclass(frozen=True)
class ModelConfig:
    """Model family + numerics (≙ src/mnist.py)."""

    name: str = "mnist_cnn"  # mnist_cnn | resnet20 | transformer
    # Reference fixes its init seed at 66478 (src/mnist.py:32).
    init_seed: int = 66478
    dropout_rate: float = 0.5  # src/mnist.py:140
    num_classes: int = 10
    image_size: int = 28
    num_channels: int = 1
    # bfloat16 activations/matmuls feed the MXU; params stay float32.
    compute_dtype: str = "bfloat16"
    # transformer (long-context path) only:
    seq_len: int = 512
    model_dim: int = 128
    num_heads: int = 4
    num_layers: int = 2
    vocab_size: int = 256
    # "flash": fused pallas kernel (ops/pallas_attention; interpreted
    # off-TPU), "dense": XLA einsum attention.
    attention_impl: str = "flash"
    # Sequence-parallel strategy when mesh.seq_parallelism > 1:
    # "ring" (ppermute K/V rotation, any head count) or "ulysses"
    # (all-to-all head scatter; needs num_heads % seq_parallelism == 0,
    # composes with the flash kernel).
    sp_attention: str = "ring"
    # Mixture-of-experts FFNs (transformer): 0 = dense MLP. Experts
    # shard over mesh.expert_parallelism (the 'expert' axis); composes
    # with mesh.model_parallelism (TP on heads + every expert's FFN).
    num_experts: int = 0
    expert_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    # Tokens are routed in fixed per-row groups: each sequence row
    # splits into moe_num_groups contiguous chunks, and capacity +
    # load-balance aux are computed per chunk (GShard group routing).
    # Groups nest inside rows, so routing semantics are invariant to
    # the pipeline microbatch split. 0 = auto: the minimum the mesh
    # requires (one group per expert rank per seq shard per row) —
    # convenient, but mesh-dependent; set explicitly for numerics that
    # are identical across every mesh (the gold-parity tests do).
    moe_num_groups: int = 0
    # 1 = Switch top-1 (gate = raw top prob); ≥2 = GShard top-k with
    # renormalized gates and sequential capacity filling (round k's
    # queue positions start after all earlier rounds' claims).
    moe_router_top_k: int = 1
    # Rematerialize each transformer block in the backward pass
    # (jax.checkpoint): activation memory per layer drops from O(all
    # intermediates) to O(block boundary), bought with one extra
    # forward — the standard HBM/FLOPs trade for long sequences.
    remat: bool = False
    # remat_policy (only meaningful with remat=True):
    #   "full"     — recompute everything inside the block (minimum HBM)
    #   "save_attn" — keep each block's attention OUTPUT resident and
    #     recompute only the projections/norms/MLP: the backward never
    #     re-runs the attention kernel, cutting the remat recompute by
    #     the attention fraction for O(b·s·d) extra bytes per layer —
    #     the right trade once attention dominates (long
    #     sequences): measured 1.14x tokens/sec at the S=8192
    #     long-context bench shape on v5e.
    remat_policy: str = "full"


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer selection + LR schedule.

    The reference hardwires plain GradientDescentOptimizer with
    exponential staircase decay (src/distributed_train.py:88-99,
    143-156,176); ``name`` opens that into the large-batch registry
    (train/optim.py) per "Scale MLPerf-0.6 models on Google TPU-v3
    Pods" (arXiv:1909.09756):

      * ``sgd``      — plain SGD; ``momentum > 0`` adds heavyball
                       momentum (the historical behavior of this knob).
      * ``momentum`` — explicit heavyball momentum-SGD.
      * ``lars``     — layer-wise adaptive rate scaling
                       (arXiv:1708.03888): per-leaf trust ratio
                       ``eta·‖w‖/‖g + wd·w‖`` scales the momentum
                       input; ``beta1`` is its momentum coefficient.
      * ``lamb``     — layer-wise Adam (arXiv:1904.00962): Adam moments
                       (``beta1``/``beta2``/``eps``) with the per-leaf
                       trust ratio ``‖w‖/‖update‖``.

    LARS/LAMB own their momentum term (``beta1``): combining them with
    ``momentum != 0`` is a validated ConfigError, as is an unknown
    ``name`` (train/optim.py ``validate``). 1-D leaves (biases, norm
    scales) skip weight decay and trust-ratio adaptation, per both
    papers' recipes.
    """

    name: str = "sgd"  # sgd | momentum | lars | lamb
    initial_learning_rate: float = 0.1
    num_epochs_per_decay: float = 2.0
    learning_rate_decay_factor: float = 0.999
    staircase: bool = True
    # decay_steps = batches_per_epoch * num_epochs_per_decay / k where k
    # is the aggregation quorum (src/distributed_train.py:147).
    momentum: float = 0.0  # reference uses plain GradientDescentOptimizer (:176)
    # -- trust-ratio optimizer hyperparameters (lars/lamb) -------------
    beta1: float = 0.9       # lamb first moment / lars momentum
    beta2: float = 0.999     # lamb second moment
    eps: float = 1e-6        # lamb denominator floor
    weight_decay: float = 0.0
    trust_coefficient: float = 0.001  # lars eta
    # -- schedule ------------------------------------------------------
    # "exponential": the reference's staircase decay (the default path;
    #   learning_rate_decay_factor == 1.0 degrades to constant).
    # "polynomial": linear warmup over warmup_steps then polynomial
    #   decay to end_learning_rate at decay_total_steps — the MLPerf
    #   large-batch recipe (arXiv:1909.09756 §3). decay_total_steps=0
    #   resolves to train.max_steps at Trainer build.
    schedule: str = "exponential"  # exponential | polynomial
    warmup_steps: int = 0
    decay_total_steps: int = 0
    end_learning_rate: float = 0.0
    poly_power: float = 2.0


@dataclass(frozen=True)
class SyncConfig:
    """Aggregation discipline — the reference's core contribution (SURVEY §2.2).

    mode:
      * "sync"     — all replicas contribute every step (flag ≡ 1).
      * "quorum"   — k-of-n backup-worker semantics: only the k fastest
                     replicas (by modeled/measured step time) contribute
                     (≙ tf.train.SyncReplicasOptimizer(replicas_to_aggregate=k),
                     src/distributed_train.py:184-188).
      * "timeout"  — deadline straggler drop: replicas whose step time
                     exceeds ``timeout_ms`` are masked out (≙ the
                     disabled RPC-kill path, src/timeout_manager.py:38-46).
      * "interval" — wall-clock-paced windowed aggregation: gradients
                     accumulate across steps and apply when the window
                     elapses, averaging whatever arrived (take_grad(1)
                     semantics, sync_replicas_optimizer_modified.py:208-215,371-373).
      * "cdf"      — full barrier + per-replica step-time CDF collection
                     (≙ --worker_times_cdf_method, TimeoutReplicasOptimizer
                     take_grad(total), sync_replicas_optimizer_modified.py:370-376).
    """

    mode: str = "sync"
    # -1 → all replicas, matching the reference default
    # (src/distributed_train.py:118-121).
    num_replicas_to_aggregate: int = -1
    interval_ms: float = 1000.0  # ≙ FLAGS.interval_ms (sync_replicas_optimizer_modified.py:38)
    timeout_ms: float = 1000.0
    drop_connect: bool = False  # src/distributed_train.py:60
    drop_connect_probability: float = 0.9  # keep-probability (:98-99)
    # Synthetic per-replica straggler model for experiments on uniform
    # TPU hardware (replaces the reference's method of inducing
    # stragglers with slow EC2 instance types, cfg/time_cdf_cfgs/*).
    straggler_profile: str = "none"  # none | lognormal | spike
    straggler_mean_ms: float = 50.0
    straggler_sigma: float = 0.5
    straggler_spike_prob: float = 0.05
    straggler_spike_scale: float = 10.0
    # Per-replica DEVICE-side timing (obsv/timing.py:ReplicaDeviceProbe):
    # each local replica's device is probed with a trivial op enqueued
    # behind everything on its queue, and the measured drain SKEW joins
    # the per-host measured step time in the [n] vector the policies
    # rank on. Within one lockstep SPMD program replicas cannot diverge
    # (collectives barrier them), so the skew captures work queued
    # OUTSIDE the shared program — per-device callbacks, injected chaos
    # work, asymmetric host feeds. Off by default (one probe dispatch +
    # readiness poll per local replica per step).
    measure_device_skew: bool = False
    # -- adaptive straggler discipline (train/discipline.py) -----------
    # The online controller: watch the rolling per-replica step-time
    # CDF and adapt the discipline parameters (quorum k / timeout_ms)
    # at runtime — they are traced step inputs (parallel/api.py
    # make_discipline_vector), so a change swaps a scalar buffer, not a
    # compiled executable. Decision rule (pure, journal-licensed, the
    # broker decide() shape): when the window tail ratio p99/p50
    # crosses ``adaptive_tail_high`` the discipline TIGHTENS (quorum:
    # k−1 down to ceil(n·min_quorum_frac); timeout: deadline →
    # max(floor, p50·timeout_factor)); when it falls back under
    # ``adaptive_tail_low`` it RELAXES one notch toward the configured
    # static setting. Dead band between the marks, cooldown in steps
    # from the last completed change. Every change is journaled as an
    # event:"discipline" begin/complete pair and licensed by the
    # recorded crossing (obsv/invariants.py "discipline").
    adaptive: bool = False
    adaptive_window_steps: int = 20    # rolling CDF window (steps)
    adaptive_cooldown_steps: int = 40  # min steps between changes
    adaptive_tail_high: float = 2.0    # p99/p50 tighten mark
    adaptive_tail_low: float = 1.3    # p99/p50 relax mark (< high)
    adaptive_min_quorum_frac: float = 0.5   # quorum floor: ceil(n·frac)
    adaptive_timeout_factor: float = 1.5    # tightened deadline = p50·this
    adaptive_timeout_floor_ms: float = 1.0  # deadline never below this

    def validate(self, num_replicas: int | None = None) -> None:
        """Typed knob validation (ConfigError, the OptimConfig pattern)
        — called from ``build_train_step``, so every Trainer build hits
        it before any tracing. Base knobs stay permissive (timeout_ms=0
        legitimately masks every replica — pinned in tests); the
        ``adaptive`` family is strict."""
        if not (self.straggler_sigma >= 0.0):
            raise ConfigError(
                f"sync.straggler_sigma must be >= 0, got "
                f"{self.straggler_sigma}")
        if not (0.0 <= self.straggler_spike_prob <= 1.0):
            raise ConfigError(
                f"sync.straggler_spike_prob must be in [0, 1], got "
                f"{self.straggler_spike_prob}")
        if not self.adaptive:
            return
        if self.mode not in ("quorum", "timeout"):
            raise ConfigError(
                f"sync.adaptive=true requires a maskable mode "
                f"(quorum | timeout), got mode={self.mode!r} — sync/cdf "
                "have no straggler parameter to adapt, and interval "
                "pacing adapts the modeled wall clock only, not which "
                "replicas contribute")
        if self.adaptive_window_steps < 2:
            raise ConfigError(
                f"sync.adaptive_window_steps must be >= 2 (a one-sample "
                f"window has no CDF), got {self.adaptive_window_steps}")
        if self.adaptive_cooldown_steps < self.adaptive_window_steps:
            raise ConfigError(
                f"sync.adaptive_cooldown_steps "
                f"({self.adaptive_cooldown_steps}) must be >= "
                f"adaptive_window_steps ({self.adaptive_window_steps}) — "
                "a cooldown shorter than the window re-decides on "
                "samples from before the last change")
        if not (self.adaptive_tail_high > self.adaptive_tail_low >= 1.0):
            raise ConfigError(
                f"sync.adaptive tail marks need high > low >= 1.0 "
                f"(hysteresis needs a dead band; p99/p50 is >= 1 by "
                f"construction), got high={self.adaptive_tail_high} "
                f"low={self.adaptive_tail_low}")
        if not (0.0 < self.adaptive_min_quorum_frac <= 1.0):
            raise ConfigError(
                f"sync.adaptive_min_quorum_frac must be in (0, 1], got "
                f"{self.adaptive_min_quorum_frac}")
        if not (self.adaptive_timeout_factor >= 1.0):
            raise ConfigError(
                f"sync.adaptive_timeout_factor must be >= 1.0 (a "
                f"deadline under the window median masks the majority), "
                f"got {self.adaptive_timeout_factor}")
        if not (self.adaptive_timeout_floor_ms > 0.0):
            raise ConfigError(
                f"sync.adaptive_timeout_floor_ms must be > 0, got "
                f"{self.adaptive_timeout_floor_ms}")
        if num_replicas is not None and self.mode == "quorum":
            import math
            k_floor = max(1, math.ceil(num_replicas
                                       * self.adaptive_min_quorum_frac))
            k0 = (num_replicas if self.num_replicas_to_aggregate == -1
                  else self.num_replicas_to_aggregate)
            if k0 < k_floor:
                raise ConfigError(
                    f"sync.num_replicas_to_aggregate={k0} starts below "
                    f"the adaptive quorum floor ceil({num_replicas} * "
                    f"{self.adaptive_min_quorum_frac}) = {k_floor} — the "
                    "controller could never relax back to the "
                    "configured setting")


@dataclass(frozen=True)
class ParallelConfig:
    """Cross-replica weight-update sharding — ZeRO-1 per "Automatic
    Cross-Replica Sharding of Weight Update in Data-Parallel Training"
    (arXiv:2004.13336).

    ``shard_weight_update``: shard the optimizer state (momentum
    buffers) and the weight-update computation across the mesh's
    ``replica`` axis: gradients are reduce-scattered instead of
    all-reduced, each replica updates only its 1/n param shard, and the
    fresh params are allgathered back. Per-chip optimizer-state memory
    and update FLOPs drop by ~the replica count; total communication
    volume stays that of one all-reduce. A no-op (with a logged note)
    when the replica axis is 1 or ``sync.mode == "interval"`` (the
    windowed accumulator wants the full mean; see parallel/api.py).

    ``shard_min_leaf_size``: leaves with fewer elements than this stay
    replicated — slicing tiny norm/bias vectors buys nothing and costs
    a gather each. 0 = auto (the replica count, the smallest shardable
    size). Leaves already sharded over a model/stage/expert axis also
    stay on their tensor-parallel placement (they are not replicated
    across THOSE axes; only their replica-axis redundancy would be
    addressable, and the flattened composite layout is not worth the
    bookkeeping at this repo's scales).

    ``comm_buckets``: how many layer-ordered buckets the ZeRO-1
    communication is split into (arXiv:1810.11112's overlap lever).
    1 = the monolithic discipline: one collective per sharded leaf,
    all issued after the full backward. N > 1 groups the sharded
    leaves into N contiguous buckets balanced by padded size and
    issues ONE reduce-scatter (and one allgather) per bucket — each
    bucket's scatter depends only on its own leaves' gradients, so
    XLA's scheduler can overlap a bucket's communication with the
    remaining backward compute instead of serializing the whole comm
    phase behind it. Bucketing is pure regrouping: the per-element
    cross-replica sums are unchanged, so losses/params stay bitwise
    equal to the monolithic path (pinned in tests/test_zero1.py).
    Leave at 1 on CPU meshes, where collectives serialize on the host
    and regrouping buys nothing (see README Performance).

    ``resident_sharded``: keep the params THEMSELVES resident in the
    replica-sharded flat layout between steps (the arXiv:2004.13336 §5
    ending — a step toward ZeRO-3). Each step allgathers the weights
    just-in-time per bucket at the top of the forward and the update
    writes back only this replica's slice; peak per-chip param bytes
    drop toward 1/n for the sharded leaves, and the post-update
    allgather leaves the step entirely (the next forward's gather
    replaces it). Checkpoints still store the canonical logical layout,
    so artifacts (and their digests) are identical across this knob and
    restore bitwise into any other layout. Requires
    ``shard_weight_update`` (validated at build time)."""

    shard_weight_update: bool = False
    shard_min_leaf_size: int = 0
    comm_buckets: int = 1
    resident_sharded: bool = False

    def validate(self) -> None:
        """Build-time validation (called from ``zero1_plan_for``, which
        every step/state builder routes through): a bad knob combo must
        be a typed ConfigError naming the dependency at Trainer build,
        not a shape error mid-step."""
        if self.comm_buckets < 1:
            raise ConfigError(
                f"parallel.comm_buckets must be >= 1, got "
                f"{self.comm_buckets} (1 = monolithic per-leaf "
                "collectives, N > 1 = N layer-ordered overlap buckets)")
        if self.resident_sharded and not self.shard_weight_update:
            raise ConfigError(
                "parallel.resident_sharded=true requires "
                "parallel.shard_weight_update=true — resident-sharded "
                "params are a layout of the ZeRO-1 shard plan; without "
                "the sharded weight update there is no plan to shard "
                "them by")


@dataclass(frozen=True)
class PrecisionConfig:
    """Mixed precision as a config knob (arXiv:1909.09756 §2: bf16
    compute with fp32 master weights is the TPU large-batch recipe).

    ``param_dtype``: the dtype the forward/backward pass sees the
    parameters in. With ``master_weights=true``, ``TrainState.params``
    stay float32 (the master copy — what the optimizer updates, what
    the ZeRO-1 update shards/gathers, and what checkpoints store
    canonically) and the train step casts them to ``param_dtype`` just
    before ``apply``; the low-precision view is derived, never
    persistent state, so restores and digests are precision-portable.
    With ``master_weights=false`` and a low-precision ``param_dtype``,
    params are cast once at init and updated in that dtype — true
    low-precision training (optimizer moments stay float32 either way;
    gradients are accumulated and aggregated in float32).

    ``compute_dtype``: overrides ``model.compute_dtype`` when set
    (activations/matmuls); "" leaves the model section authoritative.

    When to leave it all off (the defaults): float32 params + the
    model's bf16 compute is already the MXU-native single-chip mode;
    master weights only start paying once ``param_dtype`` drops below
    float32 — at which point updates of tiny weights (lr·g below the
    bf16 ulp) would silently round to no-ops without the fp32 master.
    """

    param_dtype: str = "float32"
    compute_dtype: str = ""  # "" → model.compute_dtype
    master_weights: bool = False


@dataclass(frozen=True)
class CompileConfig:
    """The compile layer (≙ the reference's ``CompileConfig``: its
    persistent XLA cache and ahead-of-time train step), with the
    reference's keys.

    ``persistent_cache`` / ``cache_dir``: the kernel build cache. A dir
    (``cache_dir``, else ``DMT_COMPILE_CACHE_DIR``; none when
    ``persistent_cache`` is false) makes the entry points (``launch
    train``, ``eval``, ``serve``) build the CUDA kernel libraries into
    ``<dir>/kernels`` and load them from there, so a later process
    pointed at the same dir compiles nothing (``core/compile_cache.py``).
    ``min_entry_size_bytes`` and ``min_compile_time_secs`` (JAX's cache
    floors) are logged as no-ops: every library is kept.

    ``precompile``: the Trainer binds the train step's device body to
    its state before the first batch and, on the card, captures it as
    CUDA graphs that every step replays (``parallel/graphs.py``), with a
    ``compile`` record in ``train_log.jsonl``; a decode replica captures
    each params version's decode step the same way.

    ``aot_executable_cache`` and ``trust_cache_cross_process`` are
    logged as no-ops: a CUDA graph cannot be serialized, and a kernel
    library is a plain shared object that no process needs to
    quarantine.
    """

    persistent_cache: bool = True
    cache_dir: str = ""
    min_entry_size_bytes: int = 0
    min_compile_time_secs: float = 0.0
    precompile: bool = True
    aot_executable_cache: bool = True
    trust_cache_cross_process: bool = False


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh topology. Replaces ClusterSpec/ps_hosts/worker_hosts
    (src/mnist_distributed_train.py:25-31, src/distributed_train.py:41-48)."""

    # -1 → use every visible device on the 'replica' axis.
    num_replicas: int = -1
    # Reserved axes so TP/SP can be added without redesign (SURVEY §5.7).
    model_parallelism: int = 1
    seq_parallelism: int = 1
    # Layer pipelining over the 'stage' axis.
    pipeline_parallelism: int = 1
    pipeline_microbatches: int = 4
    # "gpipe": all forwards then all backwards (AD transpose; bubble
    # 2(S-1) stage-works). "1f1b": fused interleaved 1F1B — each stage
    # split into pipeline_chunks virtual chunks, one chunk-work per
    # device-tick, backward-priority schedule (ops/pipeline.py; bubble
    # ~2(S-1) chunk-works, a pipeline_chunks-fold reduction).
    pipeline_schedule: str = "gpipe"
    pipeline_chunks: int = 1
    # Mixture-of-experts expert sharding over the 'expert' axis;
    # composes with model_parallelism (TP inside every expert's FFN and
    # the attention heads).
    expert_parallelism: int = 1
    # >0: force an N-virtual-CPU-device platform before backend init —
    # the mock distributed backend (SURVEY §4) reachable from the CLI.
    simulate_devices: int = 0
    replica_axis: str = "replica"
    model_axis: str = "model"
    seq_axis: str = "seq"
    stage_axis: str = "stage"
    expert_axis: str = "expert"


@dataclass(frozen=True)
class TrainConfig:
    """Loop / checkpoint / logging cadences (≙ src/distributed_train.py:56-87)."""

    max_steps: int = 1000
    train_dir: str = "/tmp/dmt_train"
    seed: int = 0
    # Gradient accumulation (arXiv:1909.09756 §2): each loop step pulls
    # this many consecutive batches, microbatch-scans them inside the
    # compiled step accumulating gradients in float32, and applies the
    # optimizer ONCE — effective batch = data.batch_size ×
    # grad_accum_steps, past what device memory fits in one pass.
    # Sync/quorum/timeout masking, LR-schedule pacing and the
    # BatchIterator cursor all see one step per application; the cursor
    # simply advances grad_accum_steps batches per step. 1 = off.
    grad_accum_steps: int = 1
    save_interval_steps: int = 200  # ≙ save_interval_secs=20 Supervisor autosave (:76)
    save_interval_secs: float = 0.0  # optional wall-clock cadence; 0 = step-based
    # The reference logs every step (:365-371); here metrics stay on
    # device and the canonical line flushes on this cadence so the step
    # loop issues no per-step host fetch at defaults.
    log_every_steps: int = 10
    save_results_period: int = 1000  # ≙ FLAGS.save_results_period (:56-57)
    summary_every_steps: int = 100  # ≙ save_summaries_secs (:78)
    keep_checkpoints: int = 5
    # Background-thread checkpoint writes (serialization + IO off the
    # hot loop); the final save always drains before run() returns.
    async_checkpoint: bool = True
    # Donation-safe DEVICE-side snapshot for async saves: a cadence
    # save dispatches an async copy of the state into fresh un-donated
    # buffers (enqueued on the device queue BEFORE the next step's
    # program, so the copy reads the buffers before donation reuses
    # them) and the D2H fetch + canonical-layout conversion move to the
    # checkpointer's worker thread — the step loop stalls only for the
    # copy dispatch, journaled as save_stall_ms on every save event.
    # Off: the historical sync fetch (state pulled to host in the train
    # loop before the worker gets it). Ignored when async_checkpoint is
    # off or the layout needs per-host sharded saves.
    async_snapshot: bool = True
    resume: bool = True  # ≙ Supervisor restore-if-present (:262)
    profile_steps: tuple[int, int] = (0, 0)  # (start, stop) jax.profiler window
    # Recurring trace dumps: every N steps, capture a one-window trace
    # into train_dir/profile/step_<k> — the always-on trace debugging
    # mode ≙ --timeline_logging's per-iteration Chrome traces
    # (src/distributed_train.py:354-358). 0 disables.
    trace_every_steps: int = 0
    # -- self-healing guards (train/loop.py) --------------------------
    # NaN/Inf loss guard: a nonfinite loss at a flush point rolls the
    # run back to the newest checkpoint whose params are finite instead
    # of letting the poison propagate into every later step and
    # checkpoint. Bounded: after nan_guard_max_rollbacks the run fails
    # loudly (a deterministic divergence would otherwise loop forever —
    # the guard exists for transient corruption, not bad hyperparams).
    nan_guard: bool = True
    nan_guard_max_rollbacks: int = 2
    # Deliberate per-step wall throttle (sleep after each step). 0 =
    # off (every real run). What the serving chaos trials use to make
    # a CPU-fast synthetic trainer publish checkpoints across a WALL
    # window long enough for serving replicas to boot, swap, and be
    # faulted mid-traffic — numerics are untouched, only the publish
    # cadence stretches.
    step_pace_ms: float = 0.0
    # Durability policy for durable artifacts, routed through the
    # storage shim (train/storage.py): "none" keeps the historical
    # buffered writes (rename-only atomicity), "data" fsyncs
    # checkpoint/manifest payload bytes before the publishing rename,
    # "full" additionally fsyncs digest sidecars, the pointer, JSONL
    # journal appends, and the parent dir after renames (the
    # power-cut-proof bound the checkpoint_durability bench prices).
    # Unknown values raise a typed ConfigError at trainer init.
    durability: str = "none"
    # Preemption handling: SIGTERM/SIGINT flush the AsyncCheckpointer
    # and stop the loop cleanly; the CLI then exits with
    # resumable_exit_code (default 75 = EX_TEMPFAIL) so a supervisor
    # can tell "resume me" from a crash. Handlers are only installed
    # when run() executes on the main thread.
    handle_preemption: bool = True
    resumable_exit_code: int = 75


@dataclass(frozen=True)
class ServeConfig:
    """Online serving tier (``servesvc/``): a replica that hot-follows
    the trainer's published checkpoints and serves inference over a
    local socket. Robustness knobs, not an endpoint zoo:

    * ``queue_depth`` is the ADMISSION bound — a full queue load-sheds
      with a typed ``overloaded`` reject immediately instead of
      queueing into unbounded latency.
    * ``max_batch`` is the compiled batch ceiling; pending requests are
      gathered into the smallest power-of-2 bucket that fits and padded
      to it, so the step function compiles once per bucket shape.
    * ``default_deadline_ms`` bounds a request that named no deadline;
      expired requests get a typed ``deadline_exceeded`` reject, never
      silent starvation.
    * ``poll_secs`` is the checkpoint hot-follow cadence (the swap
      itself is double-buffered: the in-flight batch finishes on the
      old weights, then the reference flips atomically).
    * ``precision_tier`` picks which published representation of the
      weights the replica PREFERS: ``fp32`` (the full-precision
      artifact — the historical path), or ``bf16`` / ``int8`` (the
      quantized tiers the publish-time pass writes into the
      digest-verified ``.quant`` sidecar next to each checkpoint,
      ``quant.publish_tiers``). A sidecar that is absent, torn, or
      missing the requested tier falls back to the full-precision
      artifact for that publish — journaled, never fatal, never served
      unverified.
    * ``compute_dtype`` overrides the dtype activations/matmuls run in
      on the SERVING replica only ("" = inherit the training-side
      resolution: ``precision.compute_dtype`` then
      ``model.compute_dtype``). Resolved through the shared
      ``effective_model_config`` seam so serving can run cheaper
      numerics than training without forking the model section.
    * ``tp_ranks`` — tensor-parallel replica width. 1 (default) keeps
      the historical single-chip replica. > 1 makes replica capacity a
      MESH SHAPE: the replica builds a ``(replica=1, model=tp_ranks)``
      serving mesh, sharded-loads each published checkpoint through
      the model's TP partition rules (``restore_for_topology``), and
      serves through GSPMD-partitioned compute — behind the UNCHANGED
      socket/failover/hot-swap/heartbeat contract. Launched as a
      process group (``launch serve --tp-ranks N``): rank 0 owns the
      socket, mesh, and serve.json; non-zero ranks are followers that
      digest-verify their weight shard per publish; the supervisor
      enforces die-as-a-unit (any rank exit kills and restarts the
      whole group — a half-dead TP group never serves). See
      ``servesvc/tp_group.py``.
    * ``tp_group_max_restarts`` / ``tp_group_poll_secs`` — group
      supervisor knobs: bounded whole-group restarts after a rank
      death, and the child-liveness poll cadence.
    * ``conn_read_timeout_s`` / ``conn_write_timeout_s`` — per-
      connection protocol deadlines: the TOTAL time a peer may take to
      deliver one request line (a slowloris or half-open peer costs
      one bounded stall, journaled as ``conn_abort``, never a wedged
      handler), and the ceiling on any single response write (a peer
      that stopped reading never wedges the batcher).
    * ``dedup_cache_size`` — bound of the per-replica idempotency
      cache (request id → final ok outcome). A retried request whose
      execution already completed here answers from the cache instead
      of double-executing — the exactly-once half of the network fault
      contract. 0 disables.
    """

    host: str = "127.0.0.1"
    port: int = 0            # 0 = ephemeral; the bound port lands in serve.json
    max_batch: int = 16
    queue_depth: int = 64
    batch_window_ms: float = 2.0   # gather window after the first request
    poll_secs: float = 0.25
    default_deadline_ms: float = 2000.0
    precision_tier: str = "fp32"   # fp32 | bf16 | int8
    compute_dtype: str = ""        # "" → precision/model resolution
    tp_ranks: int = 1              # >1 = tensor-parallel serving group
    tp_group_max_restarts: int = 3
    tp_group_poll_secs: float = 0.25
    conn_read_timeout_s: float = 5.0
    conn_write_timeout_s: float = 5.0
    dedup_cache_size: int = 256


# The serving-tier grammar: what ``serve.precision_tier`` accepts, and
# (minus fp32) what the quantization pass can publish.
SERVING_PRECISION_TIERS = ("fp32", "bf16", "int8")
QUANT_TIERS = ("bf16", "int8")

# Mid-generation weight-swap disciplines for the decode service.
DECODE_SWAP_POLICIES = ("pin", "restart")

# Cache-read implementations for the decode step: the dense full-table
# gather (the oracle) and the fused Pallas paged-attention kernel.
DECODE_ATTENTION_KERNELS = ("dense", "paged")


@dataclass(frozen=True)
class DecodeConfig:
    """Continuous-batching autoregressive decode (``servesvc/decode.py``)
    — the generation face of the serving tier. A decode replica holds
    ``decode_slots`` concurrently-generating sequences over ONE paged
    KV cache, so sequences of wildly different lengths share a single
    compiled decode shape; a slot is refilled the step its sequence
    finishes (EOS / max_tokens / deadline), never held for a padded
    round.

    * ``block_size`` / ``num_blocks`` — the paged cache geometry: K/V
      live in fixed-size blocks handed out by a free-list allocator
      (block 0 is the reserved null block idle slots write into), and
      each sequence owns a block table mapping its positions to
      blocks. Admission reserves every block a sequence can need
      (prompt + ``max_new_tokens``), so an admitted sequence can
      always run to completion — block pressure defers admission, it
      never kills a running generation.
    * ``max_prompt_len`` — prompts pad to power-of-2 buckets up to
      this (each bucket's prefill compiles once); longer prompts are a
      typed ``bad_request``.
    * ``max_new_tokens`` — the per-request generation ceiling (a
      request may ask for fewer, never more).
    * ``eos_token`` — generation stops when this token is sampled;
      -1 disables (sequences run to max_tokens).
    * ``temperature`` / ``top_k`` — default sampling knobs
      (``models.registry.sample_token``; temperature <= 0 = greedy
      argmax, deterministic). Requests may override per-request.
    * ``swap_policy`` — what a weight hot-swap does to sequences
      mid-generation: ``"pin"`` keeps each in-flight sequence on the
      params it started with until it finishes (new admissions use
      the new weights; at most a handful of param versions are live
      at once), ``"restart"`` re-prefills every in-flight sequence on
      the new weights (journaled per sequence as ``seq_restart`` —
      the causal license the ``decode_swap`` replay invariant
      requires whenever a sequence finishes on a different step than
      it started on).
    * ``attention_kernel`` — how the decode step reads the paged
      cache: ``"dense"`` (default) gathers each slot's full block
      table into a dense [slots, max_context, h, hd] view before
      attending — O(max context) traffic per token, and the oracle
      the parity tests pin; ``"paged"`` runs the fused Pallas kernel
      (``ops/pallas_paged_attention.py``) that walks the table
      in-kernel — O(actual context) per token. Numerics are pinned
      equal for live slots (tests/test_paged_attention.py).
    """

    decode_slots: int = 4
    block_size: int = 16
    num_blocks: int = 128
    max_prompt_len: int = 64
    max_new_tokens: int = 32
    eos_token: int = -1
    temperature: float = 0.0
    top_k: int = 0
    swap_policy: str = "pin"
    attention_kernel: str = "dense"  # dense | paged

    def validate(self) -> None:
        """Build-time validation (DecodeReplica construction): a bad
        knob is a typed ConfigError naming the constraint, not a shape
        error mid-generation."""
        if self.attention_kernel not in DECODE_ATTENTION_KERNELS:
            raise ConfigError(
                f"decode.attention_kernel={self.attention_kernel!r} is "
                f"not a known kernel; valid kernels: "
                f"{', '.join(DECODE_ATTENTION_KERNELS)}")
        if self.swap_policy not in DECODE_SWAP_POLICIES:
            raise ConfigError(
                f"decode.swap_policy={self.swap_policy!r} is not a "
                f"known policy; valid policies: "
                f"{', '.join(DECODE_SWAP_POLICIES)}")
        if self.decode_slots < 1:
            raise ConfigError(
                f"decode.decode_slots must be >= 1, got "
                f"{self.decode_slots}")
        if self.block_size < 1 or self.num_blocks < 2:
            raise ConfigError(
                f"decode.block_size must be >= 1 and decode.num_blocks "
                f">= 2 (block 0 is the reserved null block), got "
                f"block_size={self.block_size} "
                f"num_blocks={self.num_blocks}")
        if self.max_prompt_len < 1 or self.max_new_tokens < 1:
            raise ConfigError(
                "decode.max_prompt_len and decode.max_new_tokens must "
                f"be >= 1, got {self.max_prompt_len}/"
                f"{self.max_new_tokens}")
        need = self.max_blocks_per_seq()
        if self.num_blocks - 1 < need:
            raise ConfigError(
                f"decode.num_blocks={self.num_blocks} cannot hold even "
                f"one sequence: max_prompt_len + max_new_tokens = "
                f"{self.max_prompt_len + self.max_new_tokens} tokens "
                f"need {need} blocks of {self.block_size} (+1 reserved "
                "null block)")

    def max_blocks_per_seq(self) -> int:
        """Blocks one sequence can ever need (prompt + generation) —
        the fixed block-table width every compiled decode shape uses."""
        total = self.max_prompt_len + self.max_new_tokens
        return -(-total // self.block_size)


@dataclass(frozen=True)
class QuantConfig:
    """Post-training quantization at checkpoint-publish time
    (``quant/`` — ROADMAP item 5, the serving face of the
    storage-vs-compute dtype axis ``PrecisionConfig`` opened for
    training).

    ``publish_tiers``: comma-separated tiers to write into a
    ``ckpt-<step>.quant.msgpack`` sidecar next to every published
    checkpoint — ``"int8"``, ``"bf16"``, or ``"int8,bf16"``; "" = off
    (the default: no sidecars, byte-identical publish behavior). The
    int8 tier stores per-channel symmetric int8 weights + float32
    scales (weight leaves with ndim ≥ 2; 1-D biases/norms stay fp32);
    the bf16 tier stores a straight bf16 cast. The full-precision
    artifact and its digest are BYTE-UNCHANGED by publishing — the
    sidecar is purely additive, with its own sha256 digest sidecar
    under the same atomic-write/torn-read contract.

    ``calibration_examples``: how many held-out (test-split) examples
    the pass runs through the fp32 and quantized graphs at publish
    time — it records the observed activation range and the top-1
    agreement in the sidecar metadata, and REFUSES to publish a tier
    whose calibration agreement drops more than ``parity_epsilon``
    below the full-precision predictions (speed must never silently
    buy wrongness; the refusal is logged and the serving tier falls
    back to fp32 for that publish). 0 disables calibration (tiers
    publish unchecked — for tests and trusted recipes only).
    """

    publish_tiers: str = ""        # "" | "int8" | "bf16" | "int8,bf16"
    calibration_examples: int = 128
    parity_epsilon: float = 0.02

    def resolved_publish_tiers(self) -> tuple[str, ...]:
        """The validated tier tuple (the ``optim`` pattern: a bad knob
        is a typed ConfigError naming the valid set at build time, not
        a KeyError mid-publish)."""
        if not self.publish_tiers:
            return ()
        tiers = tuple(t.strip() for t in self.publish_tiers.split(",")
                      if t.strip())
        for t in tiers:
            if t not in QUANT_TIERS:
                raise ConfigError(
                    f"quant.publish_tiers names unknown tier {t!r}; "
                    f"valid tiers: {', '.join(QUANT_TIERS)} "
                    "(fp32 is the artifact itself, never a sidecar "
                    "tier)")
        return tiers


@dataclass(frozen=True)
class EvalConfig:
    """Continuous evaluator (≙ src/nn_eval.py:36-45)."""

    eval_interval_secs: float = 1.0
    eval_dir: str = "/tmp/dmt_eval"
    # 0 → auto: static batches of ≤4096 covering the full split. The
    # reference instead builds its graph at batch = the whole 10k test
    # set (nn_eval.py:121-122) — fixed-shape tiled batches are the
    # TPU-native answer (no dynamic-shape recompile, bounded memory).
    eval_batch_size: int = 0
    run_once: bool = False
    max_evals: int = 0  # 0 = unbounded


@dataclass(frozen=True)
class BrokerConfig:
    """Resource broker (``launch/broker.py``) — demand-driven
    autoscaling across one mixed trainer + serving roster.

    The broker reads a rolling window of journaled pressure signals
    (loadgen ``window`` snapshots, replica heartbeat queue/KV fields,
    trainer step rate) and trades roster slots through the cluster's
    existing reconfigure verb. Every threshold here is a PAIR — a high
    water mark that licenses scale-up and a strictly lower low water
    mark all signals must drop below before scale-down — because a
    single threshold flaps: a signal hovering at the mark would grow
    and shrink the roster on alternate polls. ``cooldown_s`` is the
    second anti-flap guard: after any roster change the broker holds
    its fire for that long no matter what the window says.

    * ``p99_high_ms`` / ``p99_low_ms`` — serving p99 latency marks.
    * ``reject_high`` / ``reject_low`` — overloaded-reject-rate marks
      (fraction of terminal outcomes in the window).
    * ``ttft_high_ms`` / ``ttft_low_ms`` — decode time-to-first-token
      p99 marks (ignored for windows with no TTFT data).
    * ``queue_high`` / ``queue_low`` — replica queue occupancy marks
      as a fraction of the admission bound (``serve.queue_depth``).
    * ``kv_free_low`` / ``kv_free_high`` — KV block-pool FREE fraction:
      scale up when free blocks fall BELOW the low mark (pool pressure
      defers admissions), scale down only once back above the high.
    * ``min_serve_replicas`` / ``max_serve_replicas`` and
      ``min_train_workers`` / ``max_train_workers`` — hard roster
      bounds the broker never crosses, whatever the signals say.
    * ``window_s`` — how much history a signal snapshot covers (also
      the loadgen snapshot window).
    * ``poll_secs`` — broker control-loop cadence.
    * ``settle_timeout_s`` — how long a begun roster change may take to
      report new capacity live before the broker journals an error.
    """

    poll_secs: float = 1.0
    window_s: float = 10.0
    cooldown_s: float = 15.0
    p99_high_ms: float = 500.0
    p99_low_ms: float = 150.0
    reject_high: float = 0.05
    reject_low: float = 0.005
    ttft_high_ms: float = 500.0
    ttft_low_ms: float = 150.0
    queue_high: float = 0.8
    queue_low: float = 0.2
    kv_free_low: float = 0.10
    kv_free_high: float = 0.50
    min_serve_replicas: int = 1
    max_serve_replicas: int = 3
    min_train_workers: int = 1
    max_train_workers: int = 8
    settle_timeout_s: float = 60.0

    def validate(self) -> None:
        """Build-time validation (broker construction): a bad knob is
        a typed ConfigError naming the constraint, not a roster that
        flaps or a bound violated mid-campaign."""
        for name, hi, lo in (("p99", self.p99_high_ms, self.p99_low_ms),
                             ("reject", self.reject_high,
                              self.reject_low),
                             ("ttft", self.ttft_high_ms,
                              self.ttft_low_ms),
                             ("queue", self.queue_high,
                              self.queue_low)):
            if not hi > lo >= 0:
                raise ConfigError(
                    f"broker.{name} marks must satisfy high > low >= 0 "
                    f"(hysteresis needs a dead band), got high={hi} "
                    f"low={lo}")
        if not 0 <= self.kv_free_low < self.kv_free_high <= 1:
            raise ConfigError(
                "broker.kv_free marks must satisfy 0 <= low < high "
                f"<= 1, got low={self.kv_free_low} "
                f"high={self.kv_free_high}")
        if self.min_serve_replicas < 1:
            raise ConfigError(
                "broker.min_serve_replicas must be >= 1 (traffic must "
                f"keep flowing), got {self.min_serve_replicas}")
        if self.max_serve_replicas < self.min_serve_replicas:
            raise ConfigError(
                f"broker.max_serve_replicas={self.max_serve_replicas} "
                f"< min_serve_replicas={self.min_serve_replicas}")
        if self.min_train_workers < 1:
            raise ConfigError(
                "broker.min_train_workers must be >= 1, got "
                f"{self.min_train_workers}")
        if self.max_train_workers < self.min_train_workers:
            raise ConfigError(
                f"broker.max_train_workers={self.max_train_workers} "
                f"< min_train_workers={self.min_train_workers}")
        if self.poll_secs <= 0 or self.window_s <= 0:
            raise ConfigError(
                "broker.poll_secs and broker.window_s must be > 0, "
                f"got {self.poll_secs}/{self.window_s}")
        if self.cooldown_s < 0 or self.settle_timeout_s <= 0:
            raise ConfigError(
                "broker.cooldown_s must be >= 0 and "
                "broker.settle_timeout_s > 0, got "
                f"{self.cooldown_s}/{self.settle_timeout_s}")


# Dtypes an activations/matmul override may name. The model section's
# own compute_dtype predates this list and stays unvalidated here (its
# consumers jnp.dtype() it at build); the OVERRIDE knobs
# (precision.compute_dtype, serve.compute_dtype) are validated at the
# shared resolution point so a typo is a typed ConfigError naming the
# valid set — the ``optim`` validation pattern — not a downstream
# jnp.dtype TypeError in whichever consumer resolves first.
_VALID_COMPUTE_DTYPES = ("float32", "bfloat16", "float16", "float64")


def _checked_compute_dtype(value: str, where: str) -> str:
    if value not in _VALID_COMPUTE_DTYPES:
        raise ConfigError(
            f"{where}={value!r} is not a known compute dtype; valid "
            f"dtypes: {', '.join(_VALID_COMPUTE_DTYPES)}")
    return value


def effective_model_config(cfg: "ExperimentConfig",
                           serving: bool = False) -> ModelConfig:
    """The model section with the compute-dtype overrides applied —
    the ONE resolution every model-building consumer (Trainer,
    evaluator, serving replica) goes through, so the precision/serve
    sections can't drift from the model section between tiers.

    Resolution order: ``serve.compute_dtype`` (serving consumers only,
    ``serving=True``) → ``precision.compute_dtype`` → the model
    section's own knob. Unknown dtype strings on either override raise
    a typed :class:`ConfigError` naming the valid set."""
    dtype = ""
    if serving and cfg.serve.compute_dtype:
        dtype = _checked_compute_dtype(cfg.serve.compute_dtype,
                                       "serve.compute_dtype")
    elif cfg.precision.compute_dtype:
        dtype = _checked_compute_dtype(cfg.precision.compute_dtype,
                                       "precision.compute_dtype")
    if not dtype:
        return cfg.model
    return dataclasses.replace(cfg.model, compute_dtype=dtype)


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "default"
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    sync: SyncConfig = field(default_factory=SyncConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    precision: PrecisionConfig = field(default_factory=PrecisionConfig)
    compile: CompileConfig = field(default_factory=CompileConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    quant: QuantConfig = field(default_factory=QuantConfig)
    broker: BrokerConfig = field(default_factory=BrokerConfig)

    # ---- construction helpers -------------------------------------------------

    def replace(self, **sections: Any) -> "ExperimentConfig":
        return dataclasses.replace(self, **sections)

    def override(self, overrides: dict[str, Any]) -> "ExperimentConfig":
        """Apply dotted-path overrides, e.g. {"sync.mode": "quorum"}."""
        cfg = self
        for path, value in overrides.items():
            cfg = _set_path(cfg, path.split("."), value)
        return cfg

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ExperimentConfig":
        return _build(cls, dict(d))

    @classmethod
    def from_file(cls, path: str | Path) -> "ExperimentConfig":
        """Load a config from JSON or a Python-literal file.

        The reference ``eval()``s its cfg files (tools/benchmark.py:15) —
        a known quirk we deliberately do not replicate (SURVEY §7):
        literals only.
        """
        text = Path(path).read_text()
        try:
            d = json.loads(text)
        except json.JSONDecodeError:
            try:
                d = ast.literal_eval(text)
            except (ValueError, SyntaxError) as e:
                raise ConfigError(f"{path}: not valid JSON or a Python literal: {e}")
        if not isinstance(d, dict):
            raise ConfigError(f"{path}: config must be a dict, got {type(d).__name__}")
        return cls.from_dict(d)

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2, sort_keys=True))


def _build(cls: type, d: dict[str, Any]) -> Any:
    if not dataclasses.is_dataclass(cls):
        return d
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in d.items():
        if key not in fields:
            raise ConfigError(f"unknown config key {key!r} for {cls.__name__}; "
                              f"valid keys: {sorted(fields)}")
        ftype = fields[key].type
        sub = _SECTION_TYPES.get((cls.__name__, key))
        if sub is not None and isinstance(value, dict):
            kwargs[key] = _build(sub, value)
        elif ftype in ("tuple[int, int]",) and isinstance(value, list):
            kwargs[key] = tuple(value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


_SECTION_TYPES = {
    ("ExperimentConfig", "data"): DataConfig,
    ("ExperimentConfig", "model"): ModelConfig,
    ("ExperimentConfig", "optim"): OptimConfig,
    ("ExperimentConfig", "sync"): SyncConfig,
    ("ExperimentConfig", "mesh"): MeshConfig,
    ("ExperimentConfig", "parallel"): ParallelConfig,
    ("ExperimentConfig", "precision"): PrecisionConfig,
    ("ExperimentConfig", "compile"): CompileConfig,
    ("ExperimentConfig", "train"): TrainConfig,
    ("ExperimentConfig", "eval"): EvalConfig,
    ("ExperimentConfig", "serve"): ServeConfig,
    ("ExperimentConfig", "decode"): DecodeConfig,
    ("ExperimentConfig", "quant"): QuantConfig,
    ("ExperimentConfig", "broker"): BrokerConfig,
}


def _set_path(obj: Any, path: list[str], value: Any) -> Any:
    if not dataclasses.is_dataclass(obj):
        raise ConfigError(f"cannot descend into non-config value at {'.'.join(path)}")
    head, rest = path[0], path[1:]
    fields = {f.name: f for f in dataclasses.fields(obj)}
    if head not in fields:
        raise ConfigError(f"unknown config key {head!r} on {type(obj).__name__}")
    if rest:
        new_child = _set_path(getattr(obj, head), rest, value)
        return dataclasses.replace(obj, **{head: new_child})
    current = getattr(obj, head)
    if dataclasses.is_dataclass(current) and isinstance(value, dict):
        # whole-section override: build the section dataclass, don't
        # store a raw dict into the frozen config
        value = _build(type(current), value)
    elif current is not None and not isinstance(value, type(current)):
        value = _coerce(value, type(current))
    return dataclasses.replace(obj, **{head: value})


def _coerce(value: Any, target: type) -> Any:
    if target is bool:
        if isinstance(value, str):
            if value.lower() in ("true", "1", "yes"):
                return True
            if value.lower() in ("false", "0", "no"):
                return False
        return bool(value)
    if target in (int, float, str):
        return target(value)
    if target is tuple and isinstance(value, (list, str)):
        if isinstance(value, str):
            value = ast.literal_eval(value)
        return tuple(value)
    return value


def parse_cli_overrides(argv: list[str]) -> dict[str, Any]:
    """Parse ``section.key=value`` CLI args (values literal-eval'd when possible)."""
    out: dict[str, Any] = {}
    for arg in argv:
        if "=" not in arg:
            raise ConfigError(f"override {arg!r} must look like section.key=value")
        key, _, raw = arg.partition("=")
        try:
            out[key] = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            out[key] = raw
    return out
