"""The training loop (≙ ``distributedmnist_tpu/train/loop.py``
``Trainer``) for ``n`` data-parallel replicas over ``P`` processes (one
device each; ``P = 1`` without a process group).

Build the model, datasets, schedule, train and eval steps and the state
from one ``ExperimentConfig``; then feed batches, log on a cadence,
checkpoint on a cadence, resume from the newest loadable checkpoint.
The records written to ``train_dir/train_log.jsonl`` (``step``,
``save``, ``eval``) and ``recovery_journal.jsonl`` follow the
reference's event schema (``obsv/schema.py``), and a checkpoint is the
reference's whole-TrainState artifact, so either package resumes the
other's run.

Kept from the reference: the log cadence (metrics are read back only at
flush points, so the host does not wait on the device between them),
the step and wall-clock save cadences with keep-N garbage collection,
resume with the data cursor, the NaN/Inf guard that rolls back to the
newest finite checkpoint, the SIGTERM/SIGINT flush (``summary
["preempted"]``; the CLI exits with ``train.resumable_exit_code``), and
the ``time_acc.npy`` / ``step_times.npy`` dumps, the effective batch,
the step-time collector (``summary["timing"]``, the reference's keys)
and the measured ``[n]`` base times: with ``sync.straggler_profile=
"none"`` in a non-sync mode each process writes the previous step's
host time into its own replicas' rows (plus each replica's device drain
under ``sync.measure_device_skew``), else the base is zero.
``sync.adaptive`` runs the discipline controller on the collector's
rolling CDF after each flush.

Over several processes (the reference's multi-host run): each process
reads its shard of the data (``host_id``/``num_hosts``), the measured
rows are summed over the processes before the step's flags are drawn —
one small host all-reduce a step, which also carries each process's
SIGTERM/SIGINT request, so every process stops after the same step —
and only process 0 writes the journals, checkpoints and series dumps;
every process resumes from the newest loadable checkpoint. The step's
host time excludes the time spent waiting in collectives. Under tensor,
sequence, pipeline or expert parallelism (``mesh.model_parallelism`` /
``seq_parallelism`` / ``pipeline_parallelism`` / ``expert_parallelism``)
a replica spans ``m·s·S·e`` processes: they all read their
replica-process's shard of the data, the one with model shard 0,
sequence block 0, stage 0 and expert shard 0 fills its replicas'
measured rows (so every process draws the same flags), a save first
gathers the model, expert and stage shards (every process takes part,
so under tensor, pipeline or expert parallelism the cadence is by
steps: ``save_interval_secs`` is refused; rank 0 writes whole leaves,
the bytes a one-process run of that layout writes) and a restore cuts
them again. Under pipeline parallelism the params are the reference's
stacked layout (in the chunk-interleaved order under ``1f1b``), so a
checkpoint holds that layout, the reference's, and a resume under the
other schedule or chunk count is refused (the two layouts' leaves have
equal shapes and other layer orders).

Checkpoints are written as the reference writes them: the fsync
policy ``train.durability`` is installed before any durable write, a
cadence save that fails after the I/O retries is journaled as a
``save_failed`` recovery record and the run goes on (a failed
asynchronous write reports through the writer's ``on_error``; three in
a row stop the run), and with ``train.async_checkpoint`` process 0
writes on a background thread (:class:`..train.checkpoint.
AsyncCheckpointer`). With ``train.async_snapshot`` too the step loop
only enqueues a copy of every state tensor on the compute stream (the
optimizer updates params and slots in place, so the next step must not
be enqueued before the copy) and records an event; the writer's thread
waits on the event on a stream of its own, copies to pinned host
memory, converts, packs and writes. Without it the loop fetches the
state to the host and the thread packs and writes. The ``save`` record's
``save_stall_ms`` is what the loop paid. The writer is drained before
the final save returns, before a NaN rollback reads the directory and
when ``run`` ends, on every exit. TensorBoard scalars go to
``train_dir/tb`` every ``train.summary_every_steps`` steps.

The slice's train-step knobs come from the config and need nothing
here but their plumbing: ``train.grad_accum_steps`` feeds ``accum``
consecutive batches a step (:class:`..data.pipeline.GradAccumFeed`; the
effective batch, images/sec and the epoch-based decay count all of
them); ``precision.*`` sets the params' storage dtype; under a ZeRO-1
plan (``parallel.shard_weight_update``) the live slots — and, with
``resident_sharded``, the params — are flat chunks, and everything that
reads params (the evaluator, the digest, the quant publisher via the
saved state, the NaN guard via the checkpoints) sees the logical ones
(:func:`..parallel.api.logical_params`). Checkpoints hold the logical
layout (``canonical_save_state``); where a process holds only its
replicas' chunks (ZeRO-1 over several replica-processes) each
replica-process writes its part of the per-host layout, synchronously,
on the step cadence (``save_interval_secs`` is refused: the processes'
clocks would not agree on the steps). Under tensor, pipeline or expert
parallelism every rank first takes part in gathering the split leaves,
then only each replica-process's leader (model shard 0, sequence block
0, stage 0, expert shard 0) writes its chunks, and rank 0 the gathered
whole leaves: one shard file a replica-process, the reference's
manifest and leaf paths. A resume, and a NaN rollback, go through
:func:`..parallel.api.restore_for_topology`: a checkpoint of another
replica or process count is repacked for this run (and journaled as
``cross_world_restore``), one of another optimizer-state kind raises
``OptimizerStateMismatchError``.

With ``quant.publish_tiers`` the writer process builds a
:class:`..quant.ptq.QuantPublisher` (calibrating on the first
``quant.calibration_examples`` test examples, on the trainer's device):
every save writes the step's int8/bf16 sidecar before its artifact and
pointer — inline for a synchronous save, on the writer thread
otherwise — and its ``save`` record lists the tiers (``quant_tiers``).

The profiler windows run on ``torch.profiler`` (CPU and, on the card,
CUDA activities) in the writer process, in the reference's directory
layout: ``train.profile_steps = (start, stop)`` traces steps ``[start,
stop)`` into ``<train_dir>/profile/``, ``train.trace_every_steps = k``
traces one step in every ``k`` into ``profile/step_<s>/``; each window
is one Chrome trace file (``trace.json``). Both set is the reference's
ValueError. On the card a window synchronizes before its trace stops,
so the trace holds the device work of its steps; a NaN rollback and
every exit close an open window.

``compile.precompile`` (default on, as in the reference) runs
:meth:`Trainer.precompile` before the first batch: the train step's
device body is bound to the Trainer's state and, on the card, captured
as CUDA graphs (``parallel/graphs.py``), which every later step replays;
the run journals one ``compile`` record before its first ``step``
record, and ``summary["compile"]`` is the same info (the record also
names the run's ``device``). On the CPU, and on
the card under a ZeRO-1 plan, over a process group or under
``model.remat``, nothing is captured: the record says ``source:
"eager"`` with the reason, and the same bodies run eagerly over the
same buffers. A capture that fails is journaled with its ``error`` and
the run goes on eagerly, as the reference's failed precompile does.
A resume or a NaN rollback copies the restored state into the captured
tensors in place (:func:`..parallel.api.load_state_into`).

Accepted and not run (each logs one line a Trainer): device prefetch
(``data.device_prefetch``; batches are staged inline),
``compile.aot_executable_cache`` (a CUDA graph cannot be serialized)
and ``compile.trust_cache_cross_process`` (a kernel library is never
quarantined).

:meth:`Trainer.adopt_train_dir` is the warm standby's promotion: a
parked Trainer that has precompiled re-roots onto a dead worker's
``train_dir`` and resumes from its checkpoints into the captured
tensors.
"""

from __future__ import annotations

import dataclasses
import math
import signal
import threading
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from ..core.config import ExperimentConfig, effective_model_config
from ..core.device import resolve_device
from ..core.log import JsonlSink, get_logger
from ..core.mesh import make_topology
from ..data.datasets import Datasets, load_datasets
from ..data.pipeline import GradAccumFeed, make_train_iterator, to_device
from ..models.convert import params_to_reference, state_to_reference
from ..models.registry import Model, get_model
from ..obsv.tb import SummaryWriter
from ..obsv.timing import ReplicaDeviceProbe, StepTimeCollector
from ..parallel.api import (TrainState, build_eval_step, build_train_step,
                            canonical_save_state, gather_state,
                            init_train_state, load_state_into,
                            logical_params, make_discipline_vector,
                            restore_for_topology, tp_gather, tree_leaves,
                            tree_map, world_signature, zero1_plan_for)
from ..parallel.partition_rules import Zero1Plan
from ..parallel.policies import resolve_aggregate_k
from ..quant.ptq import QuantPublisher
from . import checkpoint as ckpt
from . import storage
from .discipline import DisciplineController, WindowStats
from .evaluation import run_full_eval
from .lr_schedule import (constant, decay_steps_for, exponential_decay,
                          warmup_polynomial_decay)
from .optim import is_slot_dict

logger = get_logger("train")


def step_line(worker: int, step: int, loss: float, train_acc: float,
              examples_per_sec: float, sec_per_batch: float) -> str:
    """The reference's canonical per-step log line."""
    return ("Worker %d: step %d, loss = %.6f, train_acc = %.6f "
            "(%.1f examples/sec; %.3f sec/batch)"
            % (worker, step, loss, train_acc, examples_per_sec,
               sec_per_batch))


class _NonFiniteLoss(Exception):
    def __init__(self, step: int, loss: float):
        super().__init__(f"nonfinite loss {loss!r} at step {step}")
        self.step = step
        self.loss = loss


def make_schedule(cfg: ExperimentConfig, num_train_examples: int,
                  effective_batch: int, aggregate_k: int):
    """The reference Trainer's schedule choice, keyed to applied
    updates; the staircase decays every ``decay_steps ÷ k`` updates."""
    o = cfg.optim
    if o.schedule == "polynomial":
        return warmup_polynomial_decay(
            o.initial_learning_rate, o.warmup_steps,
            o.decay_total_steps or cfg.train.max_steps,
            o.end_learning_rate, o.poly_power)
    if o.learning_rate_decay_factor == 1.0:
        return constant(o.initial_learning_rate)
    steps = decay_steps_for(num_train_examples, effective_batch,
                            o.num_epochs_per_decay, aggregate_k)
    return exponential_decay(o.initial_learning_rate, steps,
                             o.learning_rate_decay_factor, o.staircase)


_NOOP_COMPILE_KNOBS = {
    "aot_executable_cache": "a CUDA graph cannot be serialized, so the "
                            "kernel build cache is the warm path",
    "trust_cache_cross_process": "a kernel library is a plain shared "
                                 "object, never quarantined"}


def _log_noop_knobs(cfg: ExperimentConfig) -> None:
    """One line for each knob a config asks for that the port accepts
    and does not run: device prefetch and two ``compile.*`` knobs (the
    native loader logs its own, ``data/pipeline.py``)."""
    if cfg.data.device_prefetch:
        logger.info("data.device_prefetch (depth %d) is a no-op in the "
                    "port: batches are staged inline",
                    cfg.data.device_prefetch_depth)
    for name, why in _NOOP_COMPILE_KNOBS.items():
        if getattr(cfg.compile, name):
            logger.info("compile.%s is a no-op in the port: %s", name, why)


class ProfilerWindows:
    """The Trainer's ``torch.profiler`` windows (≙ the reference's
    ``jax.profiler`` ones, ``train/loop.py``): ``profile_steps`` as one
    window over ``[start, stop)`` into ``<train_dir>/profile/``,
    ``trace_every_steps = k`` as a one-step window every ``k`` steps
    into ``profile/step_<s>/``; one Chrome trace (``trace.json``) a
    window. ``enabled`` is False off the writer process."""

    def __init__(self, cfg: ExperimentConfig, root: Path,
                 device: torch.device, enabled: bool):
        self.start, self.stop = cfg.train.profile_steps
        self.every = max(0, cfg.train.trace_every_steps)
        if self.every and self.stop > self.start:
            raise ValueError("set either train.profile_steps or "
                             "train.trace_every_steps, not both "
                             "(profiler traces cannot nest)")
        self.root, self.device, self.enabled = root, device, enabled
        self._prof = None
        self._dir: Path | None = None

    def before_step(self, step: int) -> None:
        """Open a window if ``step`` (about to run) starts one."""
        if not self.enabled or self._prof is not None:
            return
        if self.start <= step < self.stop:
            self._open(self.root)
        elif self.every and step % self.every == 0:
            self._open(self.root / f"step_{step}")

    def after_step(self, done: int) -> None:
        """Close the open window once its steps (``done`` so far) ran."""
        if self._prof is not None and (self.every or done >= self.stop):
            self.close()

    def _open(self, out: Path) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof, self._dir = profile(activities=acts), out
        self._prof.start()

    def close(self) -> None:
        """Stop the open window (after the device's work on the card)
        and write its trace; a no-op with none open."""
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        self._dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(self._dir / "trace.json"))


def device_snapshot(state: TrainState
                    ) -> tuple[TrainState, torch.cuda.Event | None]:
    """Fresh copies of every tensor of ``state`` (params, slots, the
    interval window), enqueued on the current stream, and on the card
    an event recorded after them. The optimizer updates the live
    tensors in place, so the copies must be enqueued before the next
    step is; the counters are Python numbers and are read now."""
    clone = lambda t: t.clone()  # noqa: E731
    snap = dataclasses.replace(
        state, params=tree_map(clone, state.params),
        momentum=tree_map(clone, state.momentum),
        window_acc=tree_map(clone, state.window_acc),
        root_key=np.array(state.root_key))
    event = None
    device = tree_leaves(state.params)[0].device
    if device.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
    return snap, event


def snapshot_to_host(snapshot: tuple[TrainState, torch.cuda.Event | None],
                     plan: Zero1Plan | None = None) -> dict:
    """The writer thread's half of :func:`device_snapshot`: the state
    dict in the reference layout (canonical under ``plan``). On the
    card: wait on the event on a stream of the snapshot's own device,
    copy into pinned host memory, synchronize that stream (the device
    copies are dropped only after it), then convert."""
    snap, event = snapshot
    if event is not None:
        device = tree_leaves(snap.params)[0].device
        with torch.cuda.device(device):
            stream = torch.cuda.Stream(device=device)
            stream.wait_event(event)
            with torch.cuda.stream(stream):
                def fetch(t):
                    host = torch.empty(t.shape, dtype=t.dtype,
                                       pin_memory=True)
                    return host.copy_(t, non_blocking=True)
                snap = dataclasses.replace(
                    snap, params=tree_map(fetch, snap.params),
                    momentum=tree_map(fetch, snap.momentum),
                    window_acc=tree_map(fetch, snap.window_acc))
            stream.synchronize()
    return state_to_reference(canonical_save_state(snap, plan))


def _host_copy(x: Any) -> Any:
    return x.clone() if isinstance(x, torch.Tensor) else np.copy(x)


class Trainer:
    """Builds the training stack from one config: ``n`` replicas
    (:func:`..core.mesh.make_topology`), this process's ``L`` of them on
    its one device. Call :func:`..core.mesh.initialize_distributed`
    first to run over a process group.

    ``device`` defaults to ``cuda:$LOCAL_RANK`` (``cuda:0``; an error
    without CUDA); the tests pass ``"cpu"``, where the attention kernels
    run their plain versions. Its steps run cuDNN's deterministic algorithms unless
    ``cudnn_deterministic`` is False (set for each step and restored
    after it, :func:`..core.device.cudnn_policy`)."""

    def __init__(self, cfg: ExperimentConfig,
                 datasets: Datasets | None = None,
                 device: str | torch.device | None = None, *,
                 cudnn_deterministic: bool = True):
        _log_noop_knobs(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        split = [f"mesh.{k} > 1" for k in ("model_parallelism",
                                            "pipeline_parallelism",
                                            "expert_parallelism")
                 if getattr(cfg.mesh, k) > 1]
        if split and cfg.train.save_interval_secs > 0:
            # a save gathers the shards, a collective every rank enters;
            # the ranks' clocks would not agree on its step
            raise ValueError(
                f"{' and '.join(split)} gathers the shards at every save, "
                "which needs a checkpoint cadence every process agrees on: "
                "set train.save_interval_steps (and save_interval_secs=0)")
        self.topo = make_topology(cfg.mesh)
        n = self.topo.num_replicas
        if cfg.data.batch_size % n != 0:
            raise ValueError(f"global batch {cfg.data.batch_size} not "
                             f"divisible by {n} replicas")
        if cfg.train.grad_accum_steps < 1:
            raise ValueError(f"train.grad_accum_steps must be >= 1, got "
                             f"{cfg.train.grad_accum_steps}")
        self.grad_accum = int(cfg.train.grad_accum_steps)
        # images/sec and the epoch-based decay key off the effective
        # batch: one optimizer application takes batch_size × accum
        self.effective_batch = cfg.data.batch_size * self.grad_accum
        # DP×SP: each process takes one block of every sequence
        n_seq = self.topo.seq_parallelism
        if n_seq > 1 and cfg.model.seq_len % n_seq != 0:
            raise ValueError(f"seq_len {cfg.model.seq_len} not divisible by "
                             f"seq_parallelism {n_seq}")
        n_stage = self.topo.pipeline_parallelism
        if n_stage > 1:
            mb = cfg.mesh.pipeline_microbatches
            if (cfg.data.batch_size // n) % mb != 0:
                raise ValueError(
                    f"per-replica batch {cfg.data.batch_size // n} not "
                    f"divisible by pipeline_microbatches {mb}")
            if cfg.model.num_layers % n_stage != 0:
                raise ValueError(
                    f"num_layers {cfg.model.num_layers} not divisible by "
                    f"pipeline_parallelism {n_stage}")
        self.model: Model = get_model(effective_model_config(cfg))
        self.datasets = datasets if datasets is not None else load_datasets(
            cfg.data, cfg.model.image_size, cfg.model.num_channels,
            cfg.model.num_classes, cfg.model.seq_len, cfg.model.vocab_size)
        self.schedule = make_schedule(cfg, self.datasets.train.num_examples,
                                      self.effective_batch,
                                      resolve_aggregate_k(cfg.sync, n))
        # the step object (precompile binds and captures it); step_fn is
        # what the loop calls, which a caller may wrap
        self._train_step = build_train_step(
            self.model, cfg, self.schedule, self.topo,
            cudnn_deterministic=cudnn_deterministic)
        self.step_fn = self._train_step
        self._compile_info: dict[str, Any] | None = None
        self._compile_logged = False
        self.eval_fn = build_eval_step(
            self.model, cfg, self.topo,
            cudnn_deterministic=cudnn_deterministic)
        # the ZeRO-1 plan (None when it does not apply): the live layout
        # of the slots (and resident params) and the checkpoint packing
        self._zero1_plan = zero1_plan_for(self.model, cfg, self.topo)
        self.state: TrainState = init_train_state(self.model, cfg,
                                                  self.device, self.topo)
        self.train_iter = make_train_iterator(
            self.datasets.train, cfg.data, seed=cfg.train.seed,
            host_id=self.topo.process_index,
            num_hosts=self.topo.process_count)
        if self.grad_accum > 1:
            self.train_iter = GradAccumFeed(self.train_iter, self.grad_accum)
        # one process writes: under TP/SP every process of replica-process
        # 0 reads its data, but only rank 0 journals and saves
        self.is_writer = self.topo.rank == 0
        # each replica-process writes its chunks when none holds them all
        self._sharded_ckpt = (self._zero1_plan is not None
                              and self._zero1_plan.any_sharded
                              and self.topo.process_count > 1)
        if self._sharded_ckpt and cfg.train.save_interval_secs > 0:
            raise ValueError(
                "a cross-process sharded layout needs a deterministic "
                "checkpoint cadence every process agrees on: set "
                "train.save_interval_steps (and save_interval_secs=0)")
        self.collector = StepTimeCollector(num_replicas=n)
        # every process runs the same controller on the same [n] times,
        # so all swap alike; only the writer journals (_sink_write)
        self._discipline: DisciplineController | None = None
        if cfg.sync.adaptive:
            self._discipline = DisciplineController(
                cfg.sync, n, self._sink_write, make_discipline_vector)
            self.collector.enable_rolling_cdf(cfg.sync.adaptive_window_steps)
        self._device_probe = (ReplicaDeviceProbe(self.topo, self.device)
                              if cfg.sync.measure_device_skew else None)
        self._last_device_skew: np.ndarray | None = None
        # fault-injection seam: {global replica: (fn, arg)}, fn(arg)
        # dispatched after each step onto this process's device and
        # noted for that replica, so its device drains later and the
        # probe sees it
        self.device_work_injection: dict[int, tuple] | None = None
        self.train_dir = Path(cfg.train.train_dir)
        # the fsync policy, installed before any durable write (the
        # resume below included); an unknown one is a ConfigError
        storage.set_durability(cfg.train.durability)
        # only the writer owns a checkpointer, built at its first save
        # (the per-host layout is written synchronously by every process)
        self._use_async_ckpt = (cfg.train.async_checkpoint and self.is_writer
                                and not self._sharded_ckpt)
        self._async_snapshot = (self._use_async_ckpt
                                and cfg.train.async_snapshot)
        self._checkpointer: ckpt.AsyncCheckpointer | None = None
        # the quantized tiers' publish-time pass, on the writer only (a
        # bad tier name is a ConfigError here, at build)
        self._quant_publisher: QuantPublisher | None = None
        if self.is_writer and cfg.quant.resolved_publish_tiers():
            self._quant_publisher = QuantPublisher(
                self.model, cfg, calib_inputs=self.datasets.test.images,
                calib_labels=self.datasets.test.labels, device=self.device)
        self._tb: SummaryWriter | None = None
        if self.is_writer and cfg.train.summary_every_steps > 0:
            self._tb = SummaryWriter(self.train_dir / "tb")
        self._sink: JsonlSink | None = None
        self._recovery_sink: JsonlSink | None = None
        self._preempt_requested: str | None = None
        self._series: list[tuple[float, int, float, float]] = []
        self._last_save_time = time.time()
        self._start_step = 0
        self._log_opened = False
        if cfg.train.resume:
            self._maybe_resume()

    # -- journals --------------------------------------------------------

    def _sink_write(self, record: dict) -> None:
        if not self.is_writer:
            return
        if self._sink is None:
            log_path = self.train_dir / "train_log.jsonl"
            if not self._log_opened and self._start_step == 0:
                # a fresh run into a reused train_dir starts a new series
                log_path.unlink(missing_ok=True)
            self._log_opened = True
            self._sink = JsonlSink(log_path)
        self._sink.write(record)

    def _recovery_event(self, record: dict) -> None:
        if not self.is_writer:
            return
        if self._recovery_sink is None:
            self._recovery_sink = JsonlSink(
                self.train_dir / "recovery_journal.jsonl")
        self._recovery_sink.write({"event": "recovery", "time": time.time(),
                                   **record})

    def _close_sinks(self) -> None:
        for attr in ("_sink", "_recovery_sink"):
            sink = getattr(self, attr)
            if sink is not None:
                sink.close()
                setattr(self, attr, None)

    # -- checkpoints -----------------------------------------------------

    def logical_params(self) -> Any:
        """The live params in their logical shapes (gathered from every
        process under a resident plan, and from the model and expert
        groups' shards under tensor or expert parallelism: every process
        calls it)."""
        return tp_gather(logical_params(self.state.params, self._zero1_plan,
                                        self.topo), self.model, self.topo)

    def _restore(self, step: int | None = None, on_event=None):
        return restore_for_topology(self.model, self.cfg, self.topo,
                                    self.train_dir, self.state, step=step,
                                    on_event=on_event)

    def _adopt(self, state: TrainState, extra: dict) -> None:
        if (state.momentum is None) != (self.state.momentum is None):
            raise ValueError(
                "checkpoint optimizer state does not match optim "
                f"{self.cfg.optim.name!r} (momentum={self.cfg.optim.momentum})"
                f": saved slots {'absent' if state.momentum is None else 'present'}")
        # in place: a captured step keeps updating the live tensors
        load_state_into(self.state, state)
        if "data_iter" in extra:
            try:
                self.train_iter.restore(extra["data_iter"])
            except (KeyError, ValueError):
                logger.warning("could not restore data-iterator state; "
                               "restarting stream")

    def _maybe_resume(self) -> None:
        restored = self._restore(
            on_event=lambda r: self._recovery_event({"layer": "checkpoint",
                                                     **r}))
        if restored is None:
            return
        state, extra, step = restored
        # the gpipe layer-stacked and 1f1b chunk-interleaved layouts
        # have identical tree structure and leaf shapes but DIFFERENT
        # layer order — a shape-matched restore across schedules would
        # silently permute the model. Refuse instead.
        saved_mesh = ((extra or {}).get("config") or {}).get("mesh", {})
        if self.topo.pipeline_parallelism > 1:
            saved = (saved_mesh.get("pipeline_schedule", "gpipe"),
                     saved_mesh.get("pipeline_chunks", 1))
            want = (self.cfg.mesh.pipeline_schedule,
                    self.cfg.mesh.pipeline_chunks)
            if saved != want:
                raise ValueError(
                    f"checkpoint was written with pipeline layout "
                    f"(schedule, chunks)={saved} but this run uses "
                    f"{want}; the stacked layer orders differ — "
                    "restoring would silently permute the model")
        self._adopt(state, extra)
        self._start_step = self.state.step
        logger.info("resumed from checkpoint step=%d (loop step %d)", step,
                    self._start_step)

    def adopt_train_dir(self, train_dir: str | Path) -> None:
        """Re-root this trainer onto ``train_dir`` and resume from
        whatever checkpoints live there — the warm-standby promotion
        hook: a parked, precompiled process adopts a dead worker's
        logdir and continues its run without paying boot, kernel build
        or capture again. The journals and the TB writer are reopened
        in the new dir, the restored state is copied into the captured
        tensors (:meth:`_maybe_resume`), and the ``compile`` record is
        journaled again there, so the adopted log carries the
        episode's compile evidence."""
        self._close_sinks()
        self.train_dir = Path(train_dir)
        self.train_dir.mkdir(parents=True, exist_ok=True)
        if self._tb is not None:
            self._tb.close()
            self._tb = SummaryWriter(self.train_dir / "tb")
        self._compile_logged = False
        self._log_opened = False
        self._series.clear()
        self._start_step = 0
        if self.cfg.train.resume:
            self._maybe_resume()

    def _save(self) -> None:
        """Process 0 writes; the others go on (no barrier: nothing waits
        on a save, as in the reference) — except in the per-host layout,
        where each replica-process's leader writes its part. A save that
        fails after the I/O retries is journaled as ``save_failed`` and
        skipped."""
        # under tensor, pipeline or expert parallelism the checkpoint
        # holds whole leaves: every rank takes part in gathering them,
        # then the writers write
        source = gather_state(self.state, self.model, self.topo)
        if not (self.is_writer or (self._sharded_ckpt
                                   and self.topo.replica_leader)):
            return
        t0 = time.perf_counter()
        at_step = self.state.step
        extra = {"config": self.cfg.to_dict(),
                 "world": world_signature(self.topo),
                 "data_iter": self.train_iter.state()}
        publish = None
        if self._quant_publisher is not None:
            pub, tdir = self._quant_publisher, self.train_dir
            publish = lambda st, s: pub.publish(tdir, st, s)  # noqa: E731
        # arms the at_step-gated disk fault scripts for this save
        storage.note_step(at_step)
        try:
            self._save_inner(source, at_step, extra, publish)
        except OSError as e:
            logger.error("checkpoint save for step=%d failed (%s) — "
                         "skipping this cadence", at_step, e)
            self._recovery_event({"layer": "train", "action": "save_failed",
                                  "step": at_step,
                                  "error": f"{type(e).__name__}: {e}",
                                  "errno": getattr(e, "errno", None),
                                  "where": "sync"})
            self._last_save_time = time.time()
            return
        stall_ms = (time.perf_counter() - t0) * 1e3
        self.collector.add_snapshot_stall_ms(stall_ms)
        # "at_step", not "step": progress watchers read "step" records
        self._sink_write({"event": "save", "time": time.time(),
                          "at_step": at_step,
                          "save_stall_ms": round(stall_ms, 3),
                          "async_snapshot": self._async_snapshot,
                          **({"quant_tiers":
                              list(self._quant_publisher.tiers)}
                             if publish is not None else {})})
        self._last_save_time = time.time()

    def _ckpt_save_failed(self, step: int, e: Exception) -> None:
        """The writer's ``on_error`` hook (its thread): a failed
        background write is journaled as ``save_failed``."""
        self._recovery_event({"layer": "train", "action": "save_failed",
                              "step": step,
                              "error": f"{type(e).__name__}: {e}",
                              "errno": getattr(e, "errno", None),
                              "where": "async"})

    def _save_sharded(self, source: TrainState, at_step: int,
                      extra: dict) -> None:
        """This replica-process's part of the per-host layout, from
        ``source`` (the live state, its model, expert and stage shards
        gathered whole): its replicas' chunks of every ZeRO-1 leaf as one
        slab (at ``first·chunk`` of the ``[pad]`` layout), the whole
        leaves from rank 0 only."""
        plan, topo = self._zero1_plan, self.topo
        by_path = dict(ckpt.flat_state_items(plan.leaf_plans))
        host = state_to_reference(source)
        split = {"momentum"} | ({"params"} if plan.params_sharded else set())
        local, meta = {}, {}
        for key, leaf in ckpt.flat_state_items(host):
            field, _, rest = key.partition("/")
            if field == "momentum" and is_slot_dict(source.momentum):
                rest = rest.partition("/")[2]  # drop LAMB's m/v level
            lp = by_path.get(rest) if field in split else None
            if lp is None or not lp.sharded:
                meta[key] = {"full": True}
                if self.is_writer:
                    local[key] = leaf
                continue
            lo = topo.first_replica * lp.chunk
            meta[key] = {"shape": [lp.pad],
                         "dtype": ("bfloat16" if isinstance(leaf, torch.Tensor)
                                   else str(leaf.dtype))}
            local[key] = {"indices": [[[lo, lo + leaf.shape[0]]]],
                          "datas": [leaf]}
        ckpt.save_sharded_state(self.train_dir, local, meta, at_step,
                                topo.process_index, topo.process_count,
                                extra=extra,
                                keep=self.cfg.train.keep_checkpoints)

    def _save_inner(self, source: TrainState, at_step: int, extra: dict,
                    publish) -> None:
        """Write ``source`` (the live state, or under tensor parallelism
        its gathered copy) as step ``at_step``'s checkpoint."""
        keep = self.cfg.train.keep_checkpoints
        if self._sharded_ckpt:
            self._save_sharded(source, at_step, extra)
            return
        canonical = canonical_save_state(source, self._zero1_plan)
        if not self._use_async_ckpt:
            host = state_to_reference(canonical)
            if publish is not None:
                publish(host, at_step)  # the sidecar before the pointer
            ckpt.save_state(self.train_dir, host, at_step, extra=extra,
                            keep=keep)
            return
        if self._checkpointer is None or self._checkpointer.closed:
            self._checkpointer = ckpt.AsyncCheckpointer(
                on_error=self._ckpt_save_failed)
        if not self._async_snapshot:
            # the host fetch on the loop; the writer packs and writes
            host = state_to_reference(canonical)
            if self.device.type == "cpu":
                # a CPU tensor's numpy view aliases the live state, which
                # the next steps update in place while the writer works
                host = tree_map(_host_copy, host)
            self._checkpointer.save(self.train_dir, host, at_step,
                                    extra=extra, keep=keep, publish=publish)
            return
        plan = self._zero1_plan
        try:
            snap = device_snapshot(source)
            prepare = lambda s: snapshot_to_host(s, plan)  # noqa: E731
        except Exception as e:  # reported as a failed write, below
            # no fallback to the synchronous path: a snapshot that
            # cannot be taken is a failed write (save_failed, and wait
            # raises), reported through the writer like any other
            def prepare(_snap, e=e):
                raise e
            snap = None
        self._checkpointer.save(self.train_dir, snap, at_step, extra=extra,
                                keep=keep, prepare=prepare, publish=publish)

    def _drain_writer(self) -> None:
        """Wait for the writer's queued and running writes before the
        directory is read. A failure there was journaled through
        ``on_error`` already and does not stop the caller."""
        if self._checkpointer is None:
            return
        try:
            self._checkpointer.wait()
        except RuntimeError as e:
            logger.warning("draining the checkpoint writer: %s (%s)", e,
                           e.__cause__)

    def _close_writer(self) -> None:
        """Drain and join the writer; raises if the last write failed."""
        if self._checkpointer is not None:
            cp, self._checkpointer = self._checkpointer, None
            cp.close()

    def _rollback_to_last_good(self, err: _NonFiniteLoss) -> int:
        """Restore the newest checkpoint whose params are finite; return
        the loop step to continue from."""
        self._drain_writer()
        for s in sorted(ckpt.loadable_steps(self.train_dir), reverse=True):
            try:
                saved, _, _ = ckpt.restore_state(self.train_dir, step=s)
                leaves = [np.asarray(x) for x in tree_leaves(saved["params"])]
                finite = all(np.isfinite(a).all() for a in leaves
                             if np.issubdtype(a.dtype, np.floating))
                state, extra, _ = (self._restore(step=s) if finite
                                   else (None, None, None))
            except (*ckpt._FALLBACK_ERRORS, KeyError, TypeError) as e:
                self._recovery_event({"layer": "train",
                                      "action": "rollback_candidate_unusable",
                                      "step": s, "error": str(e)})
                continue
            if not finite:
                self._recovery_event({"layer": "train",
                                      "action": "rollback_candidate_poisoned",
                                      "step": s})
                continue
            self._adopt(state, extra)
            logger.warning("nonfinite loss at step %d — rolled back to "
                           "checkpoint step=%d", err.step, self.state.step)
            self._recovery_event({"layer": "train", "action": "nan_rollback",
                                  "from_step": err.step,
                                  "to_step": self.state.step,
                                  "loss": repr(err.loss)})
            return self.state.step
        raise RuntimeError(f"nonfinite loss at step {err.step} and no finite "
                           "checkpoint to roll back to") from err

    def _install_preempt_handlers(self) -> dict | None:
        """SIGTERM/SIGINT → finish the current step, flush a checkpoint,
        stop. Main thread only."""
        if (not self.cfg.train.handle_preemption
                or threading.current_thread() is not threading.main_thread()):
            return None

        def handler(signum, frame):
            self._preempt_requested = signal.Signals(signum).name
            logger.warning("received %s — will flush a checkpoint and stop "
                           "(resumable)", self._preempt_requested)

        return {sig: signal.signal(sig, handler)
                for sig in (signal.SIGTERM, signal.SIGINT)}

    def _dump_series(self) -> None:
        """``time_acc.npy`` rows (time, step, loss, acc) and the
        ``[steps, n]`` modeled step-time matrix ``step_times.npy``
        (process 0 only)."""
        if self.is_writer and self._series:
            self.train_dir.mkdir(parents=True, exist_ok=True)
            np.save(self.train_dir / "time_acc.npy", np.asarray(self._series))
            m = self.collector.matrix()
            if m.size:
                np.save(self.train_dir / "step_times.npy", m)

    # -- precompile --------------------------------------------------------

    def precompile(self) -> dict[str, Any]:
        """Bind the train step's device body to this Trainer's state
        before the first batch and, on the card, capture it as CUDA
        graphs (≙ the reference's AOT compile): the capture's time is
        measured and journaled as its own ``compile`` record instead of
        hiding in the first steps, and later steps replay it. The warm-up
        leaves the state as it was. Idempotent per Trainer. With a cache
        dir (``compile.cache_dir`` / ``DMT_COMPILE_CACHE_DIR``) the info
        carries what the kernel build cache did meanwhile
        (``persistent_cache``). The build cache itself is switched on
        only by the entry points (``launch train``/``eval``/``serve``),
        as the reference's persistent cache is."""
        if self._compile_info is not None:
            return self._compile_info
        from ..core.compile_cache import resolve_cache_dir
        img = self.datasets.train.images
        lbl = self.datasets.train.labels
        # the process's batch: its share of the global batch, accum of
        # them concatenated
        rows = (self.cfg.data.batch_size // self.topo.process_count
                * self.grad_accum)
        batch = to_device({"image": np.zeros((rows, *img.shape[1:]),
                                             img.dtype),
                           "label": np.zeros((rows, *lbl.shape[1:]),
                                             lbl.dtype)}, self.device)
        info = self._train_step.prepare(
            self.state, batch, cache_dir=resolve_cache_dir(self.cfg.compile))
        if info["source"] == "eager":
            logger.info("train step runs eagerly (%s)", info["reason"])
        else:
            logger.info("captured the train step as %d CUDA graphs in %.2fs",
                        info["graphs"], info["compile_s"])
        self._compile_info = info
        return info

    # -- eval and run ----------------------------------------------------

    def evaluate(self, split: str = "test") -> dict[str, float]:
        """One full-split eval pass; also journals an ``eval`` record."""
        # under tensor, expert or pipeline parallelism the eval step
        # runs on this rank's shard (its ZeRO-1 chunks gathered)
        topo = self.topo
        params = (logical_params(self.state.params, self._zero1_plan, topo)
                  if (topo.model_parallelism > 1
                      or topo.expert_parallelism > 1
                      or topo.pipeline_parallelism > 1)
                  else self.logical_params())
        res = run_full_eval(self.eval_fn, params,
                            getattr(self.datasets, split),
                            self.cfg.eval.eval_batch_size,
                            device=self.device, topo=self.topo)
        self._sink_write({"event": "eval", "time": time.time(),
                          "step": self.state.step,
                          "num_examples": res["num_examples"],
                          "precision_at_1": res["accuracy"],
                          "loss": res["loss"], "seconds": res["seconds"]})
        self._close_sinks()
        return res

    def _step_inputs(self, inject_measured: bool, host_dt: float
                     ) -> tuple[torch.Tensor | None, bool]:
        """This step's measured ``[n]`` base (None when the policies
        rank on the synthetic model alone) and whether any process asked
        to stop. Each process writes its previous step's host time (and
        its replicas' device drain) into its own rows and its signal
        number beside them; over a process group one host all-reduce of
        the ``[n, 2]`` rows gives every process the same vector and the
        same stop (≙ the reference's ``MeasuredStage``)."""
        topo = self.topo
        if not (inject_measured or topo.distributed):
            return None, self._preempt_requested is not None
        rows = torch.zeros(topo.local_replica_count, 2, dtype=torch.float32)
        if inject_measured:
            rows[:, 0] = host_dt * 1000.0
            if self._last_device_skew is not None:
                rows[:, 0] += torch.from_numpy(self._last_device_skew)
        if topo.sharded and not topo.replica_leader:
            # a replica spans m·s·e processes: its leader's time fills its
            # rows (gather_scalars takes the max of what is written)
            rows[:, 0] = float("-inf")
        if self._preempt_requested is not None:
            rows[:, 1] = signal.Signals[self._preempt_requested].value
        rows = topo.gather_scalars(rows)
        signums = [int(x) for x in rows[:, 1].tolist() if x > 0]
        if signums and self._preempt_requested is None:
            self._preempt_requested = signal.Signals(signums[0]).name
        return (rows[:, 0].contiguous() if inject_measured else None,
                bool(signums))

    def run(self, max_steps: int | None = None,
            step_callback: Callable[[int, dict], None] | None = None
            ) -> dict[str, Any]:
        """Run the loop to ``max_steps`` (default ``train.max_steps``);
        returns the reference's summary dict."""
        cfg = self.cfg.train
        total = max_steps if max_steps is not None else cfg.max_steps
        log_every = max(1, cfg.log_every_steps)
        batch = self.effective_batch
        last_log_t = time.time()
        last_log_step = self._start_step
        pending: list[tuple[int, dict, float]] = []
        final_metrics: dict[str, Any] = {}
        # the reference's rule (train/loop.py:757-759): with no synthetic
        # straggler model, the policies rank on the measured host time
        inject_measured = (self.cfg.sync.straggler_profile == "none"
                           and self.cfg.sync.mode in ("interval", "timeout",
                                                      "quorum", "cdf"))
        host_dt = 0.0

        def flush(now: float) -> None:
            nonlocal final_metrics, last_log_t, last_log_step
            if not pending:
                return
            upto = pending[-1][0]
            rate = (upto - last_log_step) * batch / max(now - last_log_t,
                                                        1e-9)
            rows = [(s, float(m["loss"]), float(m["train_acc"]), m, t)
                    for s, m, t in pending]
            if cfg.nan_guard:
                # scan the whole window before writing any of it
                for s, loss, acc, _, _ in rows:
                    if not (math.isfinite(loss) and math.isfinite(acc)):
                        self._recovery_event(
                            {"layer": "train",
                             "action": "nonfinite_loss_detected",
                             "step": s, "loss": repr(loss)})
                        raise _NonFiniteLoss(s, loss)
            for s, loss, acc, m, t in rows:
                self._series.append((t, s, loss, acc))
                record = {
                    "event": "step", "step": s, "time": t, "loss": loss,
                    "train_acc": acc, "lr": float(m["lr"]),
                    "updates_applied": int(m["updates_applied"]),
                    "num_contributors": float(m["num_contributors"]),
                    "examples_per_sec": rate,
                    "flags": [int(f) for f in m["flags"]],
                    # adaptive: the [k, timeout_ms] every pending step
                    # ran under (changes happen after the flush)
                    **({"discipline": self._discipline.params_list()}
                       if self._discipline is not None else {})}
                self._sink_write(record)
                final_metrics = record
                if (self._tb is not None
                        and s % self.cfg.train.summary_every_steps == 0):
                    self._tb.add_scalars(
                        {"train/loss": loss, "train/accuracy": acc,
                         "train/learning_rate": record["lr"],
                         "train/examples_per_sec": rate,
                         "train/num_contributors":
                             record["num_contributors"]},
                        step=s, wall_time=t)
                    self._tb.flush()
                if step_callback:
                    step_callback(s, record)
            logger.info(step_line(self.topo.process_index, upto,
                                  final_metrics["loss"],
                                  final_metrics["train_acc"], rate,
                                  (now - last_log_t)
                                  / max(upto - last_log_step, 1)))
            pending.clear()
            last_log_t, last_log_step = now, upto
            # a change licensed here governs from the next step, so the
            # records above carry the pair in force when they ran
            if self._discipline is not None:
                rolling = self.collector.rolling_cdf()
                if rolling is not None:
                    self._discipline.maybe_adapt(upto, WindowStats(
                        p50_ms=rolling["p50_ms"], p90_ms=rolling["p90_ms"],
                        p99_ms=rolling["p99_ms"],
                        n_samples=rolling["window_steps"],
                        fast_p50_ms=rolling["fast_p50_ms"]))

        windows = ProfilerWindows(self.cfg, self.train_dir / "profile",
                                  self.device, self.is_writer)
        self.train_dir.mkdir(parents=True, exist_ok=True)
        if self.cfg.compile.precompile and self._compile_info is None:
            try:
                self.precompile()
            except Exception as e:  # the run must outlive a failed capture
                logger.warning("precompile failed (%s: %s): the step runs "
                               "eagerly", type(e).__name__, e)
                self._compile_info = {"compile_s": None, "source": "eager",
                                      "serialized": False,
                                      "reason": "capture failed",
                                      "error": f"{type(e).__name__}: {e}"}
        if self._compile_info is not None and not self._compile_logged:
            self._sink_write({"event": "compile", "time": time.time(),
                              "device": str(self.device),
                              **self._compile_info})
            self._compile_logged = True
        step = self._start_step
        rollbacks = 0
        self._preempt_requested = None
        saved_handlers = self._install_preempt_handlers()
        try:
            while True:
                try:
                    while step < total:
                        windows.before_step(step)
                        t0 = time.perf_counter()
                        blocked0 = self.topo.blocked_s
                        measured, stop = self._step_inputs(inject_measured,
                                                           host_dt)
                        if stop:
                            break
                        b = to_device(next(self.train_iter), self.device)
                        disc = (None if self._discipline is None
                                else self._discipline.vector)
                        inputs = (() if measured is None and disc is None
                                  else (measured, disc))
                        self.state, metrics = self.step_fn(self.state, b,
                                                           *inputs)
                        # this process's own time: waits for peers in
                        # collectives are not its work
                        host_dt = (time.perf_counter() - t0
                                   - (self.topo.blocked_s - blocked0))
                        if self._device_probe is not None:
                            for r, (fn, arg) in (self.device_work_injection
                                                 or {}).items():
                                at = time.perf_counter()
                                self._device_probe.note(r, fn(arg), at)
                            self._last_device_skew = (
                                self._device_probe.measure_skew_ms())
                        step += 1
                        self.collector.add(metrics["step_times_ms"], host_dt)
                        pending.append((step, metrics, time.time()))
                        windows.after_step(step)
                        if cfg.step_pace_ms > 0:
                            time.sleep(cfg.step_pace_ms / 1e3)
                        if step % log_every == 0:
                            flush(time.time())
                        if cfg.save_interval_secs > 0:
                            if (time.time() - self._last_save_time
                                    >= cfg.save_interval_secs):
                                self._save()
                        elif (cfg.save_interval_steps > 0
                              and step % cfg.save_interval_steps == 0):
                            self._save()
                        if (cfg.save_results_period > 0
                                and step % cfg.save_results_period == 0):
                            self._dump_series()
                    flush(time.time())
                    break
                except _NonFiniteLoss as e:
                    pending.clear()
                    windows.close()
                    rollbacks += 1
                    if rollbacks > cfg.nan_guard_max_rollbacks:
                        raise RuntimeError(
                            f"nonfinite loss recurred after {rollbacks - 1} "
                            "rollback(s) — deterministic divergence, giving "
                            "up") from e
                    step = self._rollback_to_last_good(e)
                    last_log_step, last_log_t = step, time.time()
            if self._preempt_requested:
                self._recovery_event({"layer": "train",
                                      "action": "preempt_flush",
                                      "signal": self._preempt_requested,
                                      "step": step})
            self._save()  # the final save
        except BaseException:
            # leave no writer thread behind an escaping error; a failed
            # last write was journaled and must not mask this one
            try:
                self._close_writer()
            except RuntimeError as e:
                logger.warning("closing the checkpoint writer: %s", e)
            raise
        finally:
            windows.close()
            if saved_handlers is not None:
                for sig, old in saved_handlers.items():
                    signal.signal(sig, old)
        # drained before run returns; raises if the final write failed
        self._close_writer()
        self._dump_series()
        if self._tb is not None:
            self._tb.flush()
        self._close_sinks()
        summary = {
            "final_step": step,
            "updates_applied": self.state.updates_applied,
            "last_metrics": final_metrics,
            "params_digest": ckpt.params_digest(
                params_to_reference(self.logical_params(),
                                    keep_bfloat16=True)),
            "timing": self.collector.report(),
            "preempted": self._preempt_requested,
            "nan_rollbacks": rollbacks,
            # where the step came from (None when precompile is off):
            # journaled in train_log.jsonl too
            "compile": self._compile_info,
        }
        if self._discipline is not None:
            summary["discipline"] = self._discipline.summary()
        return summary

