"""Chaos campaign engine (≙ ``distributedmnist_tpu/launch/chaos.py``):
stop imagining fault scenarios by hand.

The source paper's regime is synchronous training that *survives* dead
and slow workers (arXiv:1604.00981); its descendants treat replica loss
as a routine runtime event with automatic recovery (TF-Replicator,
arXiv:1902.00465; TensorFlow fault tolerance, arXiv:1605.08695). This
module searches the fault space mechanically:

* :class:`ChaosSchedule` — a SEEDED random composition of fault
  primitives (kill / hang / transient stall / corrupt-checkpoint /
  exec delay / resize, or the storage faults of ``disk=true``) over
  workers × step windows with bounded intensity. Same seed ⇒ same
  schedule, bitwise the reference's: any journaled trial is
  replayable from its seed alone. The serving and network generators
  are here too (pure functions of the seed).
* :class:`ChaosCampaign` — runs N trials against a real
  :class:`~.cluster.LocalProcessCluster` of the port's ``launch
  train`` workers under a :class:`~.supervisor.ClusterSupervisor`,
  plus one fault-free same-seed REFERENCE run, then replays every
  trial's artifacts through ``obsv/invariants.py`` — terminal-state
  legality, metrics-log splicing, bitwise exact-resume determinism vs
  the reference, journal causality, checkpoint-dir integrity, the
  world reshapes and the storage faults.
* **Shrinking** — a failing schedule is greedily reduced (drop faults
  while the violation persists, re-running each candidate) and the
  minimal reproducer is emitted as a plain FaultPlan JSON anyone can
  rerun with ``cluster supervise --fault-plan``.

``payload="serving"`` puts the serving tier under fire: worker 0
publishes checkpoints (a paced ``launch train``), workers 1..N are
``launch serve`` replicas following it (``serve_decode``: decode
replicas streaming tokens), a closed-loop load generator drives them
for the whole trial, and the serving invariants replay beside the
training ones. ``network`` swaps the process faults for transport
faults through seeded chaos proxies (:mod:`.netchaos`) in front of the
replicas. ``broker`` adds donor trainers to the roster, drives a seeded
diurnal load trace and lets the resource broker (:mod:`.broker`) trade
slots between training and serving on the trial's journaled pressure.
``serve_tp_ranks`` > 1 raises :class:`~.cluster.ClusterError` at config
build.

CLI: ``python -m distributedmnist_tpu_torch.launch cluster chaos
--trials N --seed S --until-step M [--payload train|shell|serving]
[--serve-decode] [--network] [--device cpu]``. The campaign leaves
``chaos_report.jsonl`` (one record per trial: schedule, outcome,
invariant verdicts) under its workdir and prints the one-line summary
from ``obsv.journal.summarize_chaos`` last.
"""

from __future__ import annotations

import dataclasses
import json
import random
import shutil
import time
from pathlib import Path
from typing import Any

from ..core.log import get_logger
from ..obsv.invariants import check_run, shrink_faults
from ..obsv.schema import maybe_check_event
from .cluster import (ClusterError, LocalClusterConfig, LocalProcessCluster,
                      worker_logged_since_spawn,
                      worker_resumed_step_since_spawn)
from .exec import CommandExecutor, FaultPlan, RetryPolicy
from .supervisor import ClusterSupervisor, SupervisorConfig

logger = get_logger("chaos")

FAULT_KINDS = ("kill", "hang", "stall", "corrupt", "delay", "resize",
               "net_latency", "net_bandwidth", "net_reset",
               "net_blackhole", "net_partition",
               "disk_enospc_after_bytes", "disk_eio", "disk_slow_io_ms",
               "disk_torn_write_at_byte", "disk_crash_rename")

# schedule kind → the action name the worker's DiskFaultInjector
# journals when it fires (train/storage.py) — the fired-fault
# accounting and the storage_faults invariant both read firings from
# the per-worker storage_faults.jsonl under these names
DISK_FAULT_ACTIONS = {"disk_enospc_after_bytes": "disk_enospc",
                      "disk_eio": "disk_eio",
                      "disk_slow_io_ms": "disk_slow_io",
                      "disk_torn_write_at_byte": "disk_torn_write",
                      "disk_crash_rename": "disk_crash_rename"}

# The cheap non-torch payload (the supervisor tests' resuming shell loop):
# ~20 steps/s, a file "checkpoint" every 5 steps so restarts observably
# resume. {limit} = step bound. No real checkpoints → the determinism
# and integrity invariants report skipped, not fail.
_SHELL_PAYLOAD = ('i=$( [ -f ckpt ] && cat ckpt || echo 0 ); '
                  'echo $i >> boots.txt; '
                  'while [ $i -lt {limit} ]; do i=$((i+1)); '
                  'echo "{{\\"step\\": $i, \\"loss\\": 1.0}}" '
                  '>> train_log.jsonl; '
                  'if [ $((i % 5)) -eq 0 ]; then echo $i > ckpt; fi; '
                  'sleep 0.05; done')

# The real payload: an actual `launch train` worker — deterministic by
# construction (fixed seed, synthetic data, float32, exact-resume
# checkpoints), so a fully recovered trial must reproduce the
# reference bitwise. {max_steps}/{save} templated from the config.
# Runs a 2-replica simulated mesh with momentum and the ZeRO-1 sharded
# weight update ON — with the comm split into 2 layer-ordered buckets
# (parallel.comm_buckets) — so every campaign exercises
# replica-sharded optimizer state AND the bucketed-overlap collectives
# end-to-end: kill/corrupt/resume must round-trip the canonical
# checkpoint layout exactly, and invariant 3's opt-state digest covers
# it instead of reporting vacuously on a stateless SGD.
_TRAIN_PAYLOAD = (
    "python -m distributedmnist_tpu_torch.launch train "
    "train.train_dir=. data.dataset=synthetic data.batch_size=32 "
    "data.synthetic_train_size=256 data.synthetic_test_size=64 "
    "model.compute_dtype=float32 mesh.simulate_devices=2 "
    "optim.momentum=0.9 parallel.shard_weight_update=true "
    "parallel.comm_buckets=2 "
    "train.max_steps={max_steps} "
    "train.log_every_steps=1 train.save_interval_steps={save} "
    "train.async_checkpoint=false train.save_results_period=0")

# Serving-mode publisher (worker 0 of a serving trial, and the serving
# campaign's fault-free reference): a deterministic single-device
# trainer whose job is to PUBLISH a stream of checkpoints across a
# wall window long enough for serving replicas to boot, hot-swap, and
# be faulted mid-traffic — train.step_pace_ms stretches the publish
# cadence without touching numerics, so the publisher still reproduces
# the reference bitwise.
_SERVE_PUBLISHER_PAYLOAD = (
    "python -m distributedmnist_tpu_torch.launch train "
    "train.train_dir=. data.dataset=synthetic data.batch_size=32 "
    "data.synthetic_train_size=256 data.synthetic_test_size=64 "
    "model.compute_dtype=float32 "
    "train.max_steps={max_steps} train.step_pace_ms={pace} "
    "train.log_every_steps=1 train.save_interval_steps={save} "
    "train.async_checkpoint=false train.save_results_period=0")

# Serving replicas (workers 1..N of a serving trial): hot-follow the
# publisher's logdir. Their ``train_log.jsonl`` carries heartbeat
# records whose step is the terminal-outcome count, so the supervisor's
# liveness/stall/progress machinery applies unchanged.
_SERVE_PAYLOAD = (
    "python -m distributedmnist_tpu_torch.launch serve "
    "--train_dir ../worker0 --serve-dir . --port 0 "
    "--poll-secs 0.2 --queue-depth {queue} --max-batch 8")

# Decode-mode publisher (serve_decode=true): the published model must
# be a dense-FFN causal LM for the replicas' incremental decode
# export — a compact transformer on the synthetic LM stream, float32
# and dense attention for CPU-affordable chaos trials, paced exactly
# like the classification publisher.
_DECODE_PUBLISHER_PAYLOAD = (
    "python -m distributedmnist_tpu_torch.launch train "
    "train.train_dir=. data.dataset=synthetic_lm data.batch_size=32 "
    "data.synthetic_train_size=256 data.synthetic_test_size=64 "
    "data.use_native_pipeline=false "
    "model.name=transformer model.seq_len=64 model.model_dim=64 "
    "model.num_heads=4 model.num_layers=2 model.vocab_size=32 "
    "model.compute_dtype=float32 model.attention_impl=dense "
    "train.max_steps={max_steps} train.step_pace_ms={pace} "
    "train.log_every_steps=1 train.save_interval_steps={save} "
    "train.async_checkpoint=false train.save_results_period=0")


@dataclasses.dataclass(frozen=True)
class ChaosFault:
    """One scheduled fault. ``ms`` is the stall duration (kind=stall)
    or injected delay (kind=delay); ``verb`` names the delayed command
    class (kind=delay only, worker ignored); ``world`` the target
    world size (kind=resize only — cluster-level, worker ignored: the
    supervisor shrinks/grows the whole roster at the trigger step);
    ``net`` carries a network fault's script parameters as sorted
    key/value pairs (kind=net_* only — a tuple, not a dict, so the
    frozen dataclass stays hashable; ``worker`` is the PROXIED
    replica and ``step`` is unused: transport faults trigger on
    traffic/wall-time, not train steps). ``disk`` carries a storage
    fault's script parameters the same way (kind=disk_* only;
    ``step`` is the earliest train step the script may fire at — the
    worker's injector arms it against the next durable save at or
    after that step)."""

    kind: str
    worker: int = 0
    step: int = 0
    ms: float = 0.0
    verb: str = ""
    world: int = 0
    net: tuple[tuple[str, float], ...] = ()
    disk: tuple[tuple[str, Any], ...] = ()

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"kind": self.kind}
        if self.kind == "delay":
            d.update(verb=self.verb, ms=self.ms)
        elif self.kind == "resize":
            d.update(step=self.step, world=self.world)
        elif self.kind.startswith("net_"):
            d.update(worker=self.worker, **dict(self.net))
        elif self.kind.startswith("disk_"):
            d.update(worker=self.worker, step=self.step,
                     **dict(self.disk))
        else:
            d.update(worker=self.worker, step=self.step)
            if self.kind == "stall":
                d["ms"] = self.ms
        return d


@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    """A seeded fault composition for one trial."""

    seed: int
    trial: int
    faults: tuple[ChaosFault, ...]

    def to_fault_plan(self) -> FaultPlan:
        kill: dict[int, int] = {}
        hang: dict[int, int] = {}
        stall: dict[int, tuple[int, float]] = {}
        corrupt: dict[int, int] = {}
        delay: dict[str, float] = {}
        resize: tuple[int, int] | None = None
        net: dict[int, list[dict]] = {}
        disk: dict[int, list[dict]] = {}
        for f in self.faults:
            if f.kind == "kill":
                kill[f.worker] = f.step
            elif f.kind == "hang":
                hang[f.worker] = f.step
            elif f.kind == "stall":
                stall[f.worker] = (f.step, f.ms)
            elif f.kind == "corrupt":
                corrupt[f.worker] = f.step
            elif f.kind == "delay":
                delay[f.verb] = f.ms
            elif f.kind == "resize":
                resize = (f.step, f.world)
            elif f.kind.startswith("net_"):
                # one proxy script per proxied replica; the script
                # grammar is launch/netchaos.py's (kind sans prefix)
                net.setdefault(f.worker, []).append(
                    {"kind": f.kind[len("net_"):], **dict(f.net)})
            elif f.kind.startswith("disk_"):
                # per-worker storage scripts; the grammar is
                # train/storage.py's (kind sans prefix, at_step from
                # the fault's step axis)
                disk.setdefault(f.worker, []).append(
                    {"kind": f.kind[len("disk_"):], "at_step": f.step,
                     **dict(f.disk)})
            else:
                raise ClusterError(f"unknown chaos fault kind {f.kind!r}")
        return FaultPlan(kill_worker_at_step=kill,
                         hang_worker_at_step=hang,
                         stall_worker_for_ms_at_step=stall,
                         corrupt_latest_checkpoint_at_step=corrupt,
                         delay_ms=delay,
                         resize_world_at_step=resize,
                         net_faults=net,
                         disk_faults=disk)

    def to_json_dict(self) -> dict[str, Any]:
        return {"seed": self.seed, "trial": self.trial,
                "faults": [f.to_dict() for f in self.faults]}

    def describe(self) -> str:
        if not self.faults:
            return "fault-free"
        return " + ".join(
            (f"{f.kind}(verb={f.verb}, {f.ms:.0f}ms)" if f.kind == "delay"
             else f"{f.kind}(→{f.world}w@{f.step})" if f.kind == "resize"
             else f"{f.kind}(w{f.worker}: "
                  + ", ".join(f"{k}={v:g}" for k, v in f.net) + ")"
             if f.kind.startswith("net_")
             else f"{f.kind}(w{f.worker}@{f.step}: "
                  + ", ".join(f"{k}={v}" for k, v in f.disk) + ")"
             if f.kind.startswith("disk_")
             else f"{f.kind}(w{f.worker}@{f.step}"
                  + (f", {f.ms:.0f}ms)" if f.kind == "stall" else ")"))
            for f in self.faults)


def generate_schedule(seed: int, trial: int, num_workers: int,
                      step_window: tuple[int, int],
                      max_faults: int = 3, min_faults: int = 1,
                      stall_ms_range: tuple[float, float] = (500.0, 3000.0),
                      delay_prob: float = 0.15,
                      resize_worlds: tuple[int, ...] = (),
                      resize_prob: float = 0.5) -> ChaosSchedule:
    """Sample one bounded-intensity schedule. Deterministic in
    (seed, trial). At most one fault of each kind per worker (the
    FaultPlan dicts are worker-keyed). A ``corrupt`` draw always rides
    with a ``kill`` at the SAME step — the torn checkpoint must
    actually be HIT by a restarted worker's restore, not silently
    overwritten — so if that worker's kill was already armed elsewhere
    the corruption moves to the kill's step. ``max_faults`` bounds
    intensity UNITS (a corrupt+kill pair is one unit; the fault list
    may hold up to ``max_faults + 1`` entries).

    ``resize_worlds``: candidate world sizes for the sixth fault kind
    — at most one cluster-level ``resize`` per schedule, drawn with
    ``resize_prob`` when the candidate set is non-empty. Drawn AFTER
    every legacy draw, so any (seed, trial) schedule from a
    resize-less config is byte-identical to what it always was."""
    import random
    rng = random.Random(seed * 1_000_003 + trial)
    lo, hi = step_window
    hi = max(hi, lo)
    n = rng.randint(min_faults, max(min_faults, max_faults))
    combos = [(kind, w) for kind in ("kill", "hang", "stall", "corrupt")
              for w in range(num_workers)]
    rng.shuffle(combos)
    faults: list[ChaosFault] = []
    used: set[tuple[str, int]] = set()
    units = 0

    def arm(kind: str, w: int, step: int, ms: float = 0.0) -> bool:
        if (kind, w) in used:
            return False
        used.add((kind, w))
        faults.append(ChaosFault(kind=kind, worker=w, step=step, ms=ms))
        return True

    for kind, w in combos:
        if units >= n:
            break
        step = rng.randint(lo, hi)
        if kind == "stall":
            if ("hang", w) in used:
                continue  # the stall's timed SIGCONT would silently
                # resume the "permanent" hang — mutually exclusive
            units += arm(kind, w, step, ms=rng.uniform(*stall_ms_range))
        elif kind == "hang":
            if ("stall", w) in used:
                continue
            units += arm(kind, w, step)
        elif kind == "corrupt":
            paired_already = ("kill", w) in used
            if paired_already:
                # align with the worker's existing kill so the pairing
                # invariant (same step) holds regardless of draw order
                step = next(f.step for f in faults
                            if f.kind == "kill" and f.worker == w)
            if arm(kind, w, step):
                arm("kill", w, step)
                # the pair costs ONE unit total — the kill's unit was
                # already charged when it was drawn first
                units += 0 if paired_already else 1
        else:
            units += arm(kind, w, step)
    if rng.random() < delay_prob:
        faults.append(ChaosFault(
            kind="delay", verb=rng.choice(("poll", "status", "progress")),
            ms=rng.uniform(5.0, 50.0)))
    if resize_worlds and rng.random() < resize_prob:
        faults.append(ChaosFault(
            kind="resize", step=rng.randint(lo, hi),
            world=int(rng.choice(tuple(resize_worlds)))))
    return ChaosSchedule(seed=seed, trial=trial, faults=tuple(faults))


def generate_serving_schedule(seed: int, trial: int,
                              serve_workers: list[int],
                              serve_window: tuple[int, int],
                              publish_window: tuple[int, int],
                              max_faults: int = 3, min_faults: int = 1,
                              stall_ms_range: tuple[float, float]
                              = (1000.0, 4000.0)) -> ChaosSchedule:
    """Serving-mode schedules (deterministic in (seed, trial)); its
    own generator rather than a branch of the training one because the
    fault GRAMMAR differs:

    * ALWAYS one kill of a serving replica — mid-traffic replica loss
      is the scenario the tier exists for; every seeded serving trial
      must exercise the failover/restart/zero-drop path.
    * ALWAYS one corruption of the PUBLISHED checkpoint (worker 0's
      newest artifact), UNPAIRED with any kill: in the serving tier
      the torn publish is observed by the replicas' checkpoint
      FOLLOWERS on their next poll — nothing needs to die for the
      fault to be hit, unlike training, where only a restarted
      worker's restore reads the file.
    * Extra kills/hangs/stalls on serving replicas up to
      ``max_faults`` intensity units. Kill/hang/stall trigger steps
      are in HEARTBEAT units (terminal outcomes served by that
      replica); the corruption step is in publisher train steps.
    """
    import random
    rng = random.Random(seed * 2_000_003 + trial)
    s_lo, s_hi = serve_window
    p_lo, p_hi = publish_window
    faults: list[ChaosFault] = [
        ChaosFault(kind="kill", worker=rng.choice(list(serve_workers)),
                   step=rng.randint(s_lo, max(s_lo, s_hi))),
        ChaosFault(kind="corrupt", worker=0,
                   step=rng.randint(p_lo, max(p_lo, p_hi))),
    ]
    used = {("kill", faults[0].worker)}
    n = rng.randint(min_faults, max(min_faults, max_faults))
    combos = [(kind, w) for kind in ("kill", "hang", "stall")
              for w in serve_workers]
    rng.shuffle(combos)
    units = 1  # the mandatory kill; the mandatory corrupt rides free
    for kind, w in combos:
        if units >= n:
            break
        if (kind, w) in used:
            continue
        if kind == "stall" and ("hang", w) in used:
            continue  # the stall's timed SIGCONT would resume the hang
        if kind == "hang" and ("stall", w) in used:
            continue
        used.add((kind, w))
        step = rng.randint(s_lo, max(s_lo, s_hi))
        ms = rng.uniform(*stall_ms_range) if kind == "stall" else 0.0
        faults.append(ChaosFault(kind=kind, worker=w, step=step, ms=ms))
        units += 1
    return ChaosSchedule(seed=seed, trial=trial, faults=tuple(faults))


def generate_network_schedule(seed: int, trial: int,
                              serve_workers: list[int],
                              max_faults: int = 3, min_faults: int = 2,
                              reset_after_bytes: tuple[int, int]
                              = (450, 800),
                              partition_start_s: tuple[float, float]
                              = (1.0, 4.0),
                              partition_duration_s: tuple[float, float]
                              = (0.75, 2.0)) -> ChaosSchedule:
    """Network-mode schedules (deterministic in (seed, trial)); its own
    generator — and its own rng stream (K=3_000_003, disjoint from the
    training and serving arms') — because the fault GRAMMAR differs:

    * ALWAYS one mid-stream ``net_reset`` against a serving replica:
      ``after_bytes`` is drawn ABOVE any single meta/classifier
      response (≲400 bytes) and INSIDE a decode token stream's
      cumulative size (~70 bytes/token line), so on a decode replica
      the cut lands after tokens flowed and before the terminal —
      the exactly-once retry path the proxy exists to exercise.
    * ALWAYS one timed ``net_partition`` window, anchored at the
      proxied replica's first live connection so it opens under load.
    * Extra latency/bandwidth/blackhole scripts up to ``max_faults``
      intensity units, at most one of each kind per worker (a proxy
      script list holds one script per kind).

    All triggers are traffic- or wall-clock-based — network faults
    have no train-step axis."""
    import random
    rng = random.Random(seed * 3_000_003 + trial)
    faults: list[ChaosFault] = [
        ChaosFault(kind="net_reset",
                   worker=rng.choice(list(serve_workers)),
                   net=(("after_bytes",
                         rng.randint(*reset_after_bytes)),)),
        ChaosFault(kind="net_partition",
                   worker=rng.choice(list(serve_workers)),
                   net=(("duration_s",
                         round(rng.uniform(*partition_duration_s), 3)),
                        ("start_s",
                         round(rng.uniform(*partition_start_s), 3)))),
    ]
    used = {(f.kind, f.worker) for f in faults}
    n = rng.randint(min_faults, max(min_faults, max_faults))
    combos = [(kind, w)
              for kind in ("net_latency", "net_bandwidth",
                           "net_blackhole")
              for w in serve_workers]
    rng.shuffle(combos)
    units = 2  # the mandatory reset + partition
    for kind, w in combos:
        if units >= n:
            break
        if (kind, w) in used:
            continue
        used.add((kind, w))
        if kind == "net_latency":
            net = (("delay_ms", round(rng.uniform(10.0, 60.0), 1)),
                   ("jitter_ms", round(rng.uniform(0.0, 30.0), 1)))
        elif kind == "net_bandwidth":
            # floor well above a response size per second: the cap
            # slows the wire without starving the request deadline
            net = (("bytes_per_s", rng.randint(8_192, 65_536)),)
        else:
            net = (("conn", rng.randint(0, 4)),
                   ("hold_s", round(rng.uniform(1.0, 2.5), 3)))
        faults.append(ChaosFault(kind=kind, worker=w, net=net))
        units += 1
    return ChaosSchedule(seed=seed, trial=trial, faults=tuple(faults))


def generate_disk_schedule(seed: int, trial: int, num_workers: int,
                           step_window: tuple[int, int],
                           save_interval_steps: int,
                           max_faults: int = 4, min_faults: int = 3,
                           io_attempts: int | None = None
                           ) -> ChaosSchedule:
    """Disk-mode schedules (deterministic in (seed, trial)); its own
    generator — and its own rng stream (K=4_000_003, disjoint from the
    training, serving and network arms') — because the fault GRAMMAR
    differs:

    * ALWAYS one ``disk_enospc_after_bytes`` against a worker's
      checkpoint writes, with ``times`` = the writer's retry budget so
      every attempt of ONE cadence save hits a full disk: the save
      must fail all the way through, the worker must journal
      ``save_failed`` and keep training — the graceful-degradation
      path the storage shim exists for.
    * ALWAYS one ``disk_torn_write_at_byte``: a write that lands only
      a prefix. One firing is absorbed by the retry loop (journaled,
      save still lands); the retry-budget variant turns it into a
      second failed cadence — both are drawn.
    * ALWAYS one ``disk_crash_rename`` (the power-cut model: rename
      applied, data lost) aligned to a SAVE step, paired with a kill
      just after it — silent corruption is only observable when a
      restarted worker's restore walks the pointer into the corrupt
      artifact and falls back, so the pair rides together the way the
      training arm pairs corrupt+kill. ``times=2`` covers the race
      where the kill lands after one more cadence save: the next
      artifact is corrupted too, and the fallback walk is exercised
      regardless of poll latency. The ENOSPC script is kept off this
      worker so a skipped save cannot swallow the rename the crash
      needs.
    * Extra write-path ``disk_eio`` / ``disk_slow_io_ms`` scripts up
      to ``max_faults`` intensity units, at most one of each kind per
      worker.

    Disk triggers are on the TRAIN-STEP axis (``at_step`` arms the
    script against the next durable save at or after that step), so
    the step window is the training one."""
    import random
    if io_attempts is None:
        # the writer's retry budget IS the "exhaust every attempt"
        # threshold — read it from the one place it's defined so the
        # generator can't drift from the checkpoint writer
        from ..train.checkpoint import _IO_ATTEMPTS as io_attempts
    rng = random.Random(seed * 4_000_003 + trial)
    lo, hi = step_window
    hi = max(hi, lo)
    w_crash = rng.randrange(num_workers)
    w_enospc = rng.randrange(num_workers)
    if num_workers > 1 and w_enospc == w_crash:
        w_enospc = (w_crash + 1) % num_workers
    # align the crash_rename with an actual save cadence step so the
    # paired kill can land between the corrupted save and the next one
    save_steps = [s for s in range(lo, hi + 1)
                  if s % max(1, save_interval_steps) == 0] or [lo]
    crash_step = rng.choice(save_steps)
    torn_times = rng.choice((1, io_attempts))
    faults: list[ChaosFault] = [
        ChaosFault(kind="disk_enospc_after_bytes", worker=w_enospc,
                   step=rng.randint(lo, hi),
                   disk=(("bytes", rng.randint(0, 512)),
                         ("match", ".msgpack"),
                         ("times", io_attempts))),
        ChaosFault(kind="disk_torn_write_at_byte",
                   worker=rng.randrange(num_workers),
                   step=rng.randint(lo, hi),
                   disk=(("at_byte", rng.randint(64, 4096)),
                         ("match", ".msgpack"),
                         ("times", torn_times))),
        ChaosFault(kind="disk_crash_rename", worker=w_crash,
                   step=crash_step,
                   disk=(("match", ".msgpack"), ("times", 2))),
        ChaosFault(kind="kill", worker=w_crash, step=crash_step + 1),
    ]
    used = {(f.kind, f.worker) for f in faults}
    n = rng.randint(min_faults, max(min_faults, max_faults))
    combos = [(kind, w) for kind in ("disk_eio", "disk_slow_io_ms")
              for w in range(num_workers)]
    rng.shuffle(combos)
    units = 3  # the mandatory trio; the paired kill rides free
    for kind, w in combos:
        if units >= n:
            break
        if (kind, w) in used:
            continue
        used.add((kind, w))
        step = rng.randint(lo, hi)
        if kind == "disk_eio":
            # write-path EIO, one firing: absorbed by the retry loop
            # (journaled; the save still lands) — read-path EIO only
            # fires on a restore, which an unfaulted worker never runs
            disk = (("match", ".msgpack"), ("nth", 1), ("op", "write"),
                    ("times", 1))
        else:
            disk = (("match", ".msgpack"),
                    ("ms", round(rng.uniform(5.0, 40.0), 1)),
                    ("times", 2))
        faults.append(ChaosFault(kind=kind, worker=w, step=step,
                                 disk=disk))
        units += 1
    return ChaosSchedule(seed=seed, trial=trial, faults=tuple(faults))


def count_fired_faults(trial_dir: Path,
                       schedule: ChaosSchedule) -> dict[str, Any]:
    """Scheduled-vs-actually-fired accounting for one trial, from the
    command journal alone: "the kill lands after run-end → zero
    episodes, still green" must be distinguishable from a real
    all-quiet run, a report fact a gate can assert on
    (``fired > 0``). Every injector
    journals its firing: worker faults as ``event: "fault"`` records,
    exec delays as ``injected_delay_ms`` on command records, the
    resize fault as the supervisor's ``event: "reconfigure"`` begin
    with ``trigger: "fault_plan"``, and disk faults as the WORKER
    process's own ``event: "fault"`` records in its
    ``storage_faults.jsonl`` (the injector lives inside the worker's
    durable-write path, not the supervisor)."""
    from ..obsv.report import load_jsonl
    records = load_jsonl(trial_dir / "command_journal.jsonl")
    fault_actions = {"kill": "kill_worker", "hang": "hang_worker",
                     "stall": "stall_worker",
                     "corrupt": "corrupt_latest_checkpoint"}
    fault_actions.update(DISK_FAULT_ACTIONS)
    fired_kw = {(r.get("action"), r.get("worker"))
                for r in records if r.get("event") == "fault"}
    if any(f.kind.startswith("disk_") for f in schedule.faults):
        for d in sorted(trial_dir.glob("worker*")):
            for r in load_jsonl(d / "storage_faults.jsonl"):
                if r.get("event") == "fault":
                    fired_kw.add((r.get("action"), r.get("worker")))
    delay_fired = any(r.get("event") == "command"
                      and r.get("injected_delay_ms")
                      for r in records)
    resize_fired = any(r.get("event") == "reconfigure"
                       and r.get("action") == "begin"
                       and r.get("trigger") == "fault_plan"
                       for r in records)
    out: dict[str, Any] = {"scheduled": len(schedule.faults), "fired": 0,
                           "unfired": []}
    for f in schedule.faults:
        if f.kind == "delay":
            fired = delay_fired
        elif f.kind == "resize":
            fired = resize_fired
        else:
            # net_* faults journal under their own kind name (the
            # proxy's action IS the schedule kind), so the identity
            # fallback covers them
            fired = (fault_actions.get(f.kind, f.kind),
                     f.worker) in fired_kw
        if fired:
            out["fired"] += 1
        else:
            out["unfired"].append(f.to_dict())
    return out


# ---------------------------------------------------------------------------
# campaign
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Campaign knobs (JSON-loadable like every launch config: the
    reference's keys plus ``device``)."""

    name: str = "chaos"
    trials: int = 5
    seed: int = 0
    until_step: int = 40
    num_workers: int = 2
    workdir: str = "/tmp/dmt_chaos"
    # "train" = real `launch train` workers (all invariants apply,
    # incl. bitwise determinism); "shell" = the cheap 20-steps/s shell
    # loop (no real checkpoints: determinism reports skipped) — for CI
    # smoke and generator/checker development; "serving" = the online
    # serving tier under fire: worker 0 is a paced checkpoint PUBLISHER
    # (`launch train`), workers 1..serve_replicas are serving replicas
    # (`launch serve` hot-following ../worker0), a closed-loop load
    # generator drives traffic for the whole trial, and the three
    # serving invariants (exactly-one terminal outcome, never serve a
    # failed digest, monotone served step) replay alongside the
    # training ones on the publisher
    payload: str = "train"
    train_command: str = ""     # override; "" = built-in payload
    save_interval_steps: int = 5
    # the torch device of every worker that runs a port verb: "" = the
    # verb's own default (cuda:0); "cpu" appends `--device cpu` to
    # each such payload (LocalClusterConfig.device)
    device: str = ""
    # -- serving mode ---------------------------------------------------
    serve_replicas: int = 2
    load_concurrency: int = 2
    request_deadline_s: float = 3.0
    publisher_pace_ms: float = 150.0   # publish-cadence stretch (wall only)
    serve_queue_depth: int = 32
    # kill/hang/stall triggers on serving replicas are in HEARTBEAT
    # units (terminal outcomes that replica produced)
    serve_fault_window: tuple[int, int] = (5, 40)
    # Per-replica serving precision tiers (quantized serving under
    # fire): entry i names replica i+1's serve.precision_tier; missing
    # entries default to fp32. Any non-fp32 entry makes the PUBLISHER
    # payload write the matching quant sidecars
    # (quant.publish_tiers), so the corrupt-published-artifact fault —
    # which tears the .quant sidecar alongside the checkpoint — also
    # exercises the sidecar's digest refusal on a live replica.
    # None/() = every replica full precision.
    serve_precision_tiers: tuple[str, ...] | None = None
    # Decode-mode serving trials: the publisher trains a compact
    # causal LM and the replicas run `launch serve --decode` —
    # continuous-batching streaming generation over the paged KV
    # cache, with the loadgen driving token prompts through the
    # generate path. Kill/hang/stall triggers stay in heartbeat units
    # (finished generations); the decode_swap invariant replays
    # alongside 7-9. Incompatible with non-fp32 precision tiers (the
    # decode service serves full precision only).
    serve_decode: bool = False
    # --decode knobs threaded to every decode replica (kept small so
    # generations finish fast enough for chaos's heartbeat triggers,
    # and so prompt+generation fit the compact LM's seq_len=64
    # position table)
    decode_max_new_tokens: int = 16
    decode_max_prompt_len: int = 16
    decode_slots: int = 4
    # the reference boots every serving replica as an N-rank
    # tensor-parallel process group (serve.tp_ranks); the port serves
    # one rank a replica, and refuses N > 1 (Queue A item 9)
    serve_tp_ranks: int = 1
    # network=true swaps the serving arm's process-fault grammar for
    # the TRANSPORT one (generate_network_schedule): every trial
    # interposes seeded chaos proxies (launch/netchaos.py) between the
    # load generator and the net-faulted replicas — always a
    # mid-stream reset plus a partition window under live load — and
    # the exactly-once net_faults invariant (13) replays alongside
    # 7-10. Requires payload=serving AND serve_decode=true: the
    # mandatory reset must cut a token STREAM mid-generation, and
    # only the decode wire protocol streams.
    network: bool = False
    # disk=true swaps the training arm's process-fault grammar for the
    # STORAGE one (generate_disk_schedule): every trial scripts
    # deterministic disk faults (ENOSPC budgets, EIO, torn writes,
    # power-cut renames, slow I/O) into the workers' own durable-write
    # path (train/storage.py, armed via the fault plan's disk_faults →
    # DMT_DISK_FAULTS), always including a retry-exhausting ENOSPC, a
    # torn write, and a crash_rename paired with a kill — and the
    # storage_faults invariant (14) replays alongside the training
    # ones. Requires payload=train: the faults target real checkpoint
    # saves, which the shell and serving payloads don't perform (the
    # serving arm's published-artifact corruption is the existing
    # ``corrupt`` fault).
    disk: bool = False
    # -- resource broker (serving mode only) ------------------------------
    # broker=true arms demand-driven autoscaling (launch/broker.py)
    # over the trial's roster: DONOR train workers join it
    # (broker_train_workers TOTAL trainers incl. the publisher — the
    # capacity the broker trades into serving slots, never the
    # publisher itself), the load generator drives a seeded bursty
    # diurnal trace (trough/peak concurrency phases with jittered
    # durations) with rolling-window pressure snapshots journaled, and
    # the ResourceBroker rides supervise_until_step's per-tick
    # callback. Every roster change must replay against the
    # "autoscale" invariant — the campaign's gate is at least one
    # scale-up AND one scale-back with dropped==0 throughout.
    broker: bool = False
    broker_train_workers: int = 2   # total trainers incl. the publisher
    broker_standbys: int = 0        # warm serving spares for scale-up
    broker_phases: int = 4          # diurnal phases; odd = trough first
    broker_low_concurrency: int = 1
    broker_high_concurrency: int = 8
    broker_phase_secs: float = 10.0
    broker_window_s: float = 3.0    # loadgen rolling-window width
    broker_config: dict | None = None  # BrokerConfig field overrides
    # -- straggler-discipline controller (train payload only) -------------
    # discipline_controller=true arms the adaptive straggler-discipline
    # controller (train/discipline.py) inside every train worker: the
    # payload runs quorum aggregation over a seeded synthetic SPIKE
    # straggler profile, so the per-window tail ratio the controller
    # reads derives from the run seed alone — trial and reference make
    # IDENTICAL decisions, the discipline traces match, and invariant 3
    # keeps its full bitwise claim (a mid-run restart resets the
    # controller's in-memory state, diverges the trace, and exercises
    # the epoch-splice path instead). Every parameter change must
    # replay against the "discipline" invariant — the campaign's gate
    # is at least one licensed change with zero flaps.
    discipline_controller: bool = False
    discipline_window_steps: int = 8
    discipline_cooldown_steps: int = 8
    discipline_spike_prob: float = 0.25
    discipline_spike_scale: float = 8.0
    # schedule intensity
    max_faults: int = 3
    min_faults: int = 1
    last_fault_frac: float = 0.5   # faults land in the run's first half
    stall_ms_range: tuple[float, float] | None = None  # None = per-payload
    # The sixth fault kind: elastic shrink/grow mid-run. 0 disables
    # (default — resize-less configs reproduce their historical
    # schedules exactly); the nightly chaos CI turns it on. Candidate
    # worlds None = auto: shrink to num_workers-1, plus grow to
    # num_workers+1 when warm standbys exist to absorb it.
    resize_prob: float = 0.0
    resize_worlds: tuple[int, ...] | None = None
    # supervisor policy under test
    quorum: int = 1
    max_restarts: int = 2
    restart_backoff_s: float = 0.3
    stall_timeout_s: float | None = None  # None = per-payload default
    standby_workers: int = 0              # pre-booted spares per trial
    poll_secs: float | None = None        # None = per-payload default
    # One persistent compile cache shared by the reference run and
    # every trial (<campaign root>/compile_cache): the reference pays
    # the cold compile once and every later worker boot — including
    # every restart the faults force — is warm. What makes the
    # boot-derived stall timeout below safe.
    share_compile_cache: bool = True
    # Adaptive stall timeout (train payload): once a run has MEASURED
    # its spawn→first-log boot cost, trials stop paying the hardcoded
    # 90 s worst case — detection drops to
    # max(floor, mult × measured_boot), still capped at 90 s. The
    # floor keeps a noisy fast measurement from turning boot jitter
    # into false hang detections.
    stall_timeout_floor_s: float = 20.0
    stall_timeout_boot_mult: float = 3.0
    trial_timeout_s: float = 900.0
    drain_timeout_s: float = 180.0
    # drain gives up early on live workers whose logs stop moving for
    # this long (a permanently-stopped straggler would otherwise hold
    # every such trial for the full drain timeout); generous enough for
    # a restarted worker's boot and a final save+eval tail
    drain_stall_s: float = 45.0
    # shrinking
    shrink: bool = True
    shrink_max_probes: int = 8

    def __post_init__(self) -> None:
        # the repo's knob contract: a typo is a typed error naming the
        # valid set at config build — not a replica crash-looping
        # against its restart budget mid-trial
        from ..core.config import SERVING_PRECISION_TIERS
        if self.payload not in ("train", "shell", "serving"):
            raise ClusterError(f"unknown chaos payload {self.payload!r} "
                               "(choices: train, shell, serving)")
        for t in (self.serve_precision_tiers or ()):
            if t not in SERVING_PRECISION_TIERS:
                raise ClusterError(
                    f"serve_precision_tiers names unknown tier {t!r}; "
                    f"valid tiers: "
                    f"{', '.join(SERVING_PRECISION_TIERS)}")
        if self.serve_tp_ranks > 1:
            raise ClusterError(
                f"serve_tp_ranks={self.serve_tp_ranks} is not ported: "
                "the port serves one rank a replica (tensor-parallel "
                "serving groups are ROADMAP Queue A item 9)")
        if self.serve_decode and any(
                t and t != "fp32"
                for t in (self.serve_precision_tiers or ())):
            raise ClusterError(
                "serve_decode=true is incompatible with non-fp32 "
                "serve_precision_tiers: the decode service serves "
                "full precision only (quant sidecars hold weights for "
                "the one-shot predict export)")
        if self.network:
            if self.payload != "serving":
                raise ClusterError(
                    "network=true requires payload=serving: the chaos "
                    "proxies interpose on the serving wire protocol")
            if not self.serve_decode:
                raise ClusterError(
                    "network=true requires serve_decode=true: the "
                    "mandatory mid-stream reset must cut a decode "
                    "token stream, and only the decode protocol "
                    "streams multi-line responses")
            if self.broker:
                raise ClusterError(
                    "network=true is incompatible with broker=true: "
                    "the broker's traded roster would outgrow the "
                    "boot-time proxy set, leaving new replicas "
                    "unproxied mid-trial")
        if self.disk:
            if self.payload != "train":
                raise ClusterError(
                    "disk=true requires payload=train: storage faults "
                    "target the trainer's durable checkpoint writes, "
                    "which the shell and serving payloads don't "
                    "perform")
            if self.save_interval_steps < 2:
                raise ClusterError(
                    "disk=true requires save_interval_steps >= 2: the "
                    "crash_rename fault pairs with a kill one step "
                    "after the save it corrupts, so at least one step "
                    "must separate consecutive cadence saves")
        if self.broker:
            # the broker recognizes serving slots by command EQUALITY
            # with one uniform serving payload — a mixed-tier roster
            # (per-replica command suffixes) would misclassify every
            # non-fp32 replica as a trainer
            if self.payload != "serving":
                raise ClusterError(
                    "broker=true requires payload=serving: the broker "
                    "trades training slots for serving replicas")
            if any(t and t != "fp32"
                   for t in (self.serve_precision_tiers or ())):
                raise ClusterError(
                    "broker=true is incompatible with non-fp32 "
                    "serve_precision_tiers: the broker identifies "
                    "serving slots by payload equality, so the roster "
                    "must run one uniform serving command")
            if self.broker_train_workers < 2:
                raise ClusterError(
                    "broker=true requires broker_train_workers >= 2: "
                    "the publisher is never a scale-up victim, so at "
                    "least one donor trainer must exist for the broker "
                    "to trade")
        if self.discipline_controller:
            if self.payload != "train":
                raise ClusterError(
                    "discipline_controller=true requires payload=train: "
                    "the straggler-discipline controller lives in the "
                    "training step (quorum over a synthetic straggler "
                    "profile), not the shell or serving payloads")
            if self.train_command:
                raise ClusterError(
                    "discipline_controller=true is incompatible with a "
                    "train_command override: the controller knobs are "
                    "appended to the built-in train payload, and a "
                    "custom command owns its own sync.* flags")

    @classmethod
    def from_file(cls, path: str | Path,
                  overrides: dict | None = None) -> "ChaosConfig":
        # `--chaos-config` accepts a file path or inline JSON — a path
        # can't start with "{", so the sniff is unambiguous. CLI flag
        # overrides merge BEFORE construction: __post_init__ validates
        # cross-field constraints (network requires payload=serving),
        # so the config must be built once, already merged.
        text = str(path)
        d = (json.loads(text) if text.lstrip().startswith("{")
             else json.loads(Path(path).read_text()))
        d.update(overrides or {})
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ClusterError(f"unknown chaos config keys: {sorted(unknown)}")
        if "stall_ms_range" in d and d["stall_ms_range"] is not None:
            d["stall_ms_range"] = tuple(d["stall_ms_range"])
        if "serve_fault_window" in d:
            d["serve_fault_window"] = tuple(d["serve_fault_window"])
        if "serve_precision_tiers" in d and \
                d["serve_precision_tiers"] is not None:
            d["serve_precision_tiers"] = tuple(
                str(t) for t in d["serve_precision_tiers"])
        if "resize_worlds" in d and d["resize_worlds"] is not None:
            d["resize_worlds"] = tuple(int(w) for w in d["resize_worlds"])
        return cls(**d)

    # -- per-payload defaults -------------------------------------------

    def resolved_poll_secs(self) -> float:
        return self.poll_secs if self.poll_secs is not None else (
            0.2 if self.payload == "shell" else 1.0)

    def resolved_stall_timeout_s(self,
                                 measured_boot_s: float | None = None
                                 ) -> float:
        if self.stall_timeout_s is not None:
            return self.stall_timeout_s
        if self.payload == "shell":
            return 2.5
        # the stall clock starts at the first poll, BEFORE the worker
        # has logged anything — the timeout must clear a full boot
        # (a cold kernel build included) or healthy boots read as
        # hangs. With a MEASURED boot cost (the reference run's
        # spawn→first-log latency) the default derives from reality
        # instead of the hardcoded worst case.
        if measured_boot_s is not None and measured_boot_s > 0:
            return min(90.0, max(self.stall_timeout_floor_s,
                                 self.stall_timeout_boot_mult
                                 * measured_boot_s))
        return 90.0

    def resolved_stall_ms_range(self) -> tuple[float, float]:
        if self.stall_ms_range is not None:
            return self.stall_ms_range
        # shell: straddle the stall timeout so the restart-vs-wait race
        # runs both ways; train: always below it (a transient straggler
        # the supervisor should WAIT out, never restart)
        return (500.0, 4000.0) if self.payload == "shell" else (
            2000.0, 8000.0)

    def resolved_resize_worlds(self) -> tuple[int, ...]:
        if self.resize_prob <= 0:
            return ()
        if self.resize_worlds is not None:
            return tuple(self.resize_worlds)
        worlds: list[int] = []
        if self.num_workers > 1:
            worlds.append(self.num_workers - 1)  # shrink
        if self.standby_workers > 0:
            worlds.append(self.num_workers + 1)  # warm grow
        return tuple(worlds)

    def resolved_publisher_pace_ms(self,
                                   measured_boot_s: float | None = None
                                   ) -> float:
        """The serving publisher's ``train.step_pace_ms``. The pace
        ADAPTS to the measured boot (the reference run's spawn→first-log
        cost): serving replicas pay roughly the same boot the publisher
        did, so the publishing window must outlast it with margin or a
        loaded box finishes the trial before any replica ever serves —
        the same derive-from-reality move the stall timeout makes."""
        pace = self.publisher_pace_ms
        if measured_boot_s is not None and measured_boot_s > 0:
            floor = 2500.0 * measured_boot_s / max(1, self.until_step)
            pace = min(2000.0, max(pace, floor))
        return round(pace, 1)

    def resolved_train_command(self, measured_boot_s: float | None = None
                               ) -> str:
        if self.train_command:
            return self.train_command
        if self.payload == "shell":
            return _SHELL_PAYLOAD.format(limit=self.until_step + 20)
        if self.payload == "serving":
            # worker 0 AND the campaign reference: the paced publisher
            pace = self.resolved_publisher_pace_ms(measured_boot_s)
            if self.serve_decode:
                # decode trials publish a causal LM — no quant
                # sidecars (validated fp32-only above)
                return _DECODE_PUBLISHER_PAYLOAD.format(
                    max_steps=self.until_step, pace=pace,
                    save=self.save_interval_steps)
            cmd = _SERVE_PUBLISHER_PAYLOAD.format(
                max_steps=self.until_step, pace=pace,
                save=self.save_interval_steps)
            quant = self.resolved_quant_publish_tiers()
            if quant:
                # the publisher writes the sidecars the quantized
                # replicas prefer (also runs in the fault-free
                # reference — same payload, bitwise determinism holds:
                # sidecars never touch the train state)
                cmd += f" quant.publish_tiers={','.join(quant)}"
            return cmd
        cmd = _TRAIN_PAYLOAD.format(max_steps=self.until_step,
                                    save=self.save_interval_steps)
        if self.discipline_controller:
            # quorum over the seeded synthetic spike profile: the
            # controller's CDF signal derives from the run seed alone,
            # so the fault-free reference adapts identically and the
            # bitwise determinism claim survives the armed controller
            cmd += (
                " sync.mode=quorum sync.adaptive=true"
                f" sync.adaptive_window_steps={self.discipline_window_steps}"
                f" sync.adaptive_cooldown_steps="
                f"{self.discipline_cooldown_steps}"
                " sync.straggler_profile=spike"
                f" sync.straggler_spike_prob={self.discipline_spike_prob}"
                f" sync.straggler_spike_scale={self.discipline_spike_scale}")
        return cmd

    def resolved_quant_publish_tiers(self) -> tuple[str, ...]:
        """The distinct non-fp32 tiers any replica serves — what the
        publisher must write sidecars for (order-stable)."""
        tiers: list[str] = []
        for t in (self.serve_precision_tiers or ()):
            if t and t != "fp32" and t not in tiers:
                tiers.append(t)
        return tuple(tiers)

    def resolved_serve_command(self) -> str:
        """The uniform serving payload (fp32, no tier suffix) — the
        broker's serving-slot identity and the command every replica
        and warm standby runs under broker=true."""
        cmd = _SERVE_PAYLOAD.format(queue=self.serve_queue_depth)
        if self.serve_decode:
            cmd += (f" --decode --decode-slots {self.decode_slots}"
                    f" --max-new-tokens {self.decode_max_new_tokens}"
                    f" --max-prompt-len {self.decode_max_prompt_len}")
        return cmd

    def resolved_donor_command(self,
                               measured_boot_s: float | None = None
                               ) -> str:
        """A donor trainer's payload: the publisher's command with a
        10× step budget so donors never finish inside the trial window
        (the broker reaps them by reshape, not the supervisor by
        restart). Safe for determinism — the LR schedule is an
        epoch-indexed staircase, independent of max_steps."""
        base = self.resolved_train_command(measured_boot_s)
        return base.replace(f"train.max_steps={self.until_step}",
                            f"train.max_steps={self.until_step * 10}")

    def resolved_worker_commands(self,
                                 measured_boot_s: float | None = None
                                 ) -> dict[str, str]:
        """Per-worker payload overrides — serving mode's mixed roster
        (publisher + replicas); empty for the uniform payloads.
        ``serve_precision_tiers`` entry i pins replica i+1's tier (a
        mixed fp32/int8 roster exercises both weight paths under one
        fault plan). Under broker=true the roster also carries donor
        trainers after the replicas — overridden slots the broker may
        trade for serving capacity."""
        if self.payload != "serving":
            return {}
        tiers = self.serve_precision_tiers or ()
        out: dict[str, str] = {}
        for k in range(1, 1 + self.serve_replicas):
            cmd = self.resolved_serve_command()
            tier = tiers[k - 1] if k - 1 < len(tiers) else ""
            if tier and tier != "fp32":
                cmd += f" --precision-tier {tier}"
            out[str(k)] = cmd
        if self.broker:
            donor = self.resolved_donor_command(measured_boot_s)
            for k in range(1 + self.serve_replicas,
                           self.trial_num_workers()):
                out[str(k)] = donor
        return out

    def trial_num_workers(self) -> int:
        if self.payload != "serving":
            return self.num_workers
        donors = max(0, self.broker_train_workers - 1) if self.broker \
            else 0
        return 1 + self.serve_replicas + donors

    def step_window(self) -> tuple[int, int]:
        lo = max(2, self.save_interval_steps + 1)
        return (lo, max(lo, int(self.until_step * self.last_fault_frac)))

    @property
    def root(self) -> Path:
        return Path(self.workdir) / self.name


def _merge_load_summaries(summaries: list[dict | None]) -> dict | None:
    """Fold the per-phase ``summarize_outcomes`` dicts of a diurnal
    load trace into one trial-level summary: counters SUM, tail
    latencies take the worst phase (the bound the chaos gate checks —
    a per-request-weighted percentile across phases would launder a
    bad burst through a long calm trough), serving evidence sets
    union. Phases that never ran (``None``) are skipped; all-``None``
    merges to ``None``."""
    real = [s for s in summaries if s]
    if not real:
        return None
    counters = ("issued", "terminal", "dropped", "responses",
                "rejected", "errors", "tokens_streamed")
    out: dict[str, Any] = {k: sum(int(s.get(k, 0)) for s in real)
                           for k in counters}
    if not out["tokens_streamed"]:
        del out["tokens_streamed"]
    by_reason: dict[str, int] = {}
    for s in real:
        for k, v in (s.get("by_reason") or {}).items():
            by_reason[k] = by_reason.get(k, 0) + int(v)
    out["by_reason"] = by_reason
    out["reject_rate"] = round(out["rejected"] / max(1, out["terminal"]),
                               4)
    out["duration_s"] = round(sum(float(s.get("duration_s", 0.0))
                                  for s in real), 3)
    out["throughput_rps"] = round(
        out["terminal"] / max(out["duration_s"], 1e-9), 2)
    out["model_steps_served"] = sorted(
        {st for s in real for st in s.get("model_steps_served", ())})
    out["tiers_served"] = sorted(
        {t for s in real for t in s.get("tiers_served", ())})
    for key in ("latency_ms", "ttft_ms", "inter_token_ms"):
        dists = [s[key] for s in real if s.get(key)]
        if dists:
            out[key] = {q: max(d[q] for d in dists if q in d)
                        for q in dists[0]}
    out["phases_merged"] = len(real)
    return out


class ChaosCampaign:
    """N seeded trials + a fault-free reference + invariant replay +
    failing-schedule shrinking, over real local worker processes."""

    def __init__(self, cfg: ChaosConfig):
        self.cfg = cfg
        self.reference_dir: Path | None = None
        # latest observed spawn→first-log cost (reference first, then
        # each completed trial): what resolved_stall_timeout_s derives
        # the trial detection window from
        self._measured_boot_s: float | None = None

    # -- one trial ------------------------------------------------------

    def _run_trial(self, rel: str, plan: FaultPlan, seed: int,
                   num_workers: int,
                   measured_boot_s: float | None = None,
                   serving: bool = False) -> dict[str, Any]:
        """Execute one supervised run under ``plan`` in
        ``<root>/<rel>``; returns the outcome record (also written to
        ``outcome.json`` there so the invariant replay is
        artifact-only). ``measured_boot_s``: a previous run's observed
        spawn→first-log cost — lets the stall timeout derive from the
        measured boot instead of the hardcoded worst case.

        ``serving``: the mixed serving roster (worker 0 publishes,
        workers 1..N serve) with the closed-loop load generator driving
        traffic for the whole supervised window; progress toward the
        target counts from the PUBLISHER only (a replica's heartbeat
        step is its request counter, not run progress)."""
        cfg = self.cfg
        target = cfg.until_step
        broker = None
        brokered = serving and cfg.broker
        lcfg = LocalClusterConfig(
            name=rel, num_workers=num_workers, workdir=str(cfg.root),
            train_command=cfg.resolved_train_command(measured_boot_s),
            worker_commands=(cfg.resolved_worker_commands(measured_boot_s)
                             if serving else {}),
            # brokered rosters park their warm spares on the SERVING
            # payload: a scale-up promotes one into the new slot with
            # its boot already paid
            standby_command=(cfg.resolved_serve_command()
                             if brokered and cfg.broker_standbys > 0
                             else ""),
            # ONE cache for the whole campaign, not per-trial: the
            # reference's cold build warms every later boot
            compile_cache=cfg.share_compile_cache,
            compile_cache_dir=(str(cfg.root / "compile_cache")
                               if cfg.share_compile_cache else ""),
            device=cfg.device)
        executor = CommandExecutor(
            journal=lcfg.root / "command_journal.jsonl",
            retry=RetryPolicy(max_attempts=1, seed=seed),
            fault_plan=plan)
        cluster = LocalProcessCluster(lcfg, executor)
        scfg = SupervisorConfig(
            quorum=min(cfg.quorum, num_workers),
            max_restarts_per_worker=cfg.max_restarts,
            restart_backoff_s=cfg.restart_backoff_s,
            stall_timeout_s=cfg.resolved_stall_timeout_s(measured_boot_s),
            standby_workers=cfg.standby_workers,
            seed=seed)
        sup = ClusterSupervisor(cluster, scfg)
        if brokered:
            broker = self._make_broker(sup, lcfg)
        outcome: dict[str, Any] = {
            "name": rel, "seed": seed, "target": target,
            "num_workers": num_workers,
            "fault_plan": plan.to_json_dict(),
            "supervisor": dataclasses.asdict(scfg),
            "train_command": lcfg.train_command,
            "reference_dir": (str(self.reference_dir)
                              if self.reference_dir else None),
        }
        t0 = time.monotonic()
        loadgen_thread: Any = None
        load_stop = None
        load_result: dict[str, Any] = {}
        proxies: dict[int, Any] = {}
        try:
            # inside the try: a spawn that fails halfway (fork pressure
            # mid-campaign) must still hit the kill_all/close below, or
            # already-spawned detached workers outlive the campaign
            cluster.create()
            cluster.run_train()
            if broker is not None:
                broker.start()  # provision the warm serving spares
            if plan.net_faults:
                # one seeded chaos proxy per net-faulted replica,
                # journaling its net_* firings into the same command
                # journal the process faults use; the loadgen below
                # routes those replicas' endpoints through the proxy
                # ports (upstreams re-resolve from serve.json per
                # connection, so replica restarts stay reachable)
                from .netchaos import start_proxies
                proxies = start_proxies(lcfg.root, plan.net_faults,
                                        journal=executor.journal,
                                        seed=seed)
            if serving:
                loadgen_thread, load_stop = self._start_loadgen(
                    lcfg, load_result, proxies=proxies)
            got = sup.supervise_until_step(
                target, poll_secs=cfg.resolved_poll_secs(),
                timeout_secs=cfg.trial_timeout_s,
                target_worker=0 if serving else None,
                on_tick=broker.tick if broker is not None else None)
            outcome.update(outcome="completed", step=got["step"])
            if serving:
                self._stop_serving(cluster, sup, num_workers,
                                   loadgen_thread, load_stop)
                loadgen_thread = None
            self._drain(cluster, sup)
            # the drain may have closed recovery episodes the
            # supervised loop left open (a worker restarted near
            # run-end finishes its boot DURING the drain) — the
            # outcome's recovery/MTTR summary must include them
            outcome["recovery"] = sup.summary()
            # spawn→first-log cost of THIS run's workers: the adaptive
            # stall timeout for later trials derives from it
            outcome["boot_s"] = cluster.measured_boot_s()
            # the world the trial ENDED at (a resize fault or elastic
            # shrink reshaped the roster mid-run; the reconfigure
            # invariant cross-checks this against the journal)
            st = cluster.status()
            if st is not None:
                outcome["final_world"] = len(st["workers"])
        except ClusterError as e:
            aborted = any(ev.get("action") == "below_quorum_abort"
                          for ev in sup.events)
            outcome.update(outcome="aborted" if aborted else "failed",
                           step=None, error=str(e),
                           recovery=sup.summary())
        finally:
            if loadgen_thread is not None:  # error path: stop the load
                load_stop.set()
                loadgen_thread.join(timeout=30)
            for p in proxies.values():
                p.stop()
            cluster.kill_all()
            executor.close()
        if serving:
            outcome["mode"] = "serving"
            if brokered:
                # the roster TRADED slots mid-run: the serving workers
                # are whichever dirs actually served (grown ids
                # included), not the boot-time range — the serving
                # invariants replay exactly these journals
                outcome["broker"] = True
                outcome["autoscale"] = (broker.summary()
                                        if broker is not None else None)
                outcome["serve_workers"] = sorted(
                    int(p.parent.name[len("worker"):])
                    for p in lcfg.root.glob("worker*/serve_log.jsonl"))
            else:
                outcome["serve_workers"] = list(range(1, num_workers))
            outcome["serving"] = load_result.get("summary")
            if load_result.get("phases") is not None:
                outcome["load_phases"] = load_result["phases"]
            # weight-swap-by-tier accounting over every replica's
            # serve journal (tier-less legacy swaps count as fp32) —
            # the evidence a quantized campaign arm actually served
            # its tier, and that sidecar digest refusals fired
            from ..obsv.journal import (summarize_net_chaos,
                                        summarize_serving_swaps)
            from ..obsv.report import load_jsonl
            serve_recs: list[dict] = []
            for k in outcome["serve_workers"]:
                serve_recs += load_jsonl(
                    lcfg.worker_dir(k) / "serve_log.jsonl", "serve")
            outcome["serve_swaps"] = summarize_serving_swaps(serve_recs)
            # network-fault evidence (None when the trial saw none):
            # proxy firings by kind, dedup-cache hits, retry
            # amplification — the chaos report's ``net`` slot
            outcome["net"] = summarize_net_chaos(lcfg.root)
        if cfg.discipline_controller and not serving:
            # worker 0's decision journal is the trial's discipline
            # evidence (every worker runs the identical seeded program,
            # so one trace represents them all; per-worker divergence
            # is the invariant's job, not the summary's)
            from ..obsv import schema as _schema
            from ..obsv.journal import summarize_discipline
            from ..obsv.report import load_jsonl
            outcome["discipline"] = summarize_discipline(load_jsonl(
                lcfg.worker_dir(0) / "train_log.jsonl",
                _schema.DISCIPLINE))
        outcome["duration_s"] = round(time.monotonic() - t0, 3)
        (lcfg.root / "outcome.json").write_text(
            json.dumps(outcome, indent=2, default=str))
        return outcome

    # -- serving-mode plumbing ------------------------------------------

    def _make_broker(self, sup: ClusterSupervisor,
                     lcfg: LocalClusterConfig):
        """A brokered trial's :class:`~.broker.ResourceBroker` over the
        trial's supervisor: ``broker_config``'s marks, the uniform
        serving payload as the serving-slot identity, the trial's
        ``loadgen.jsonl`` as its window source. A method, so that a
        campaign can wrap the broker it runs."""
        from ..core.config import BrokerConfig
        from .broker import ResourceBroker
        cfg = self.cfg
        return ResourceBroker(
            sup, BrokerConfig(**(cfg.broker_config or {})),
            serve_command=cfg.resolved_serve_command(),
            loadgen_journal=lcfg.root / "loadgen.jsonl",
            warm_standbys=cfg.broker_standbys)

    def _start_loadgen(self, lcfg: LocalClusterConfig,
                       load_result: dict[str, Any],
                       proxies: dict[int, Any] | None = None):
        """Launch the closed-loop load generator on a background
        thread: wait for the first replica to become ready (its
        ``serve.json`` + a meta answer), then drive traffic through
        the round-robin failover shim until told to stop. The
        per-request journal lands in ``<trial root>/loadgen.jsonl`` —
        the artifact the serving invariants replay.

        ``proxies``: network-mode chaos proxies keyed by proxied
        worker — those replicas' discovered endpoints are rewritten to
        the proxy's listen port, so every request to a net-faulted
        replica crosses its fault scripts."""
        import threading

        from ..servesvc.client import ServeClient, discover_endpoints
        from ..servesvc.loadgen import (make_input_fn, make_prompt_fn,
                                        run_load)
        cfg = self.cfg
        root = lcfg.root
        stop = threading.Event()

        def endpoints() -> list[dict]:
            eps = discover_endpoints(root)
            if not proxies:
                return eps
            out = []
            for e in eps:
                p = proxies.get(e.get("worker"))
                if p is not None and p.bound_port:
                    e = {**e, "host": p.listen_host,
                         "port": p.bound_port}
                out.append(e)
            return out

        def drive() -> None:
            client = ServeClient(endpoints,
                                 deadline_s=cfg.request_deadline_s,
                                 max_attempts=6,
                                 seed=cfg.seed)
            meta = None
            while meta is None and not stop.is_set():
                meta = client.meta(deadline_s=1.0)
                if meta is None:
                    time.sleep(0.5)
            if meta is None:
                load_result["summary"] = None  # nothing ever came up
                return
            if meta.get("decode"):
                # decode replicas: drive token prompts through the
                # streaming generate path (ttft/itl recorded per
                # request, tokens bounded so generations finish
                # inside heartbeat-trigger cadence)
                make_input = make_prompt_fn(meta["vocab_size"],
                                            meta["max_prompt_len"])
            else:
                make_input = make_input_fn(meta["input_shape"],
                                           meta["input_dtype"])
            decode = bool(meta.get("decode"))
            if not cfg.broker:
                load_result["summary"] = run_load(
                    client, None, cfg.load_concurrency, make_input,
                    journal_path=root / "loadgen.jsonl", stop_event=stop,
                    decode=decode)
                return
            # broker mode: a seeded bursty DIURNAL trace — trough and
            # peak concurrency phases with jittered durations, each a
            # run_load leg appending to the one shared loadgen.jsonl
            # with rolling-window pressure snapshots the broker reads.
            # A final trough leg holds until the trial ends so the
            # window stays fresh — the calm evidence the scale-back
            # needs. Each leg's ids start where the last leg's ended:
            # the replicas' dedup caches key on the id, so a leg that
            # numbered from 0 again (the reference) would be answered
            # from cache and its requests counted twice.
            rng = random.Random(f"{cfg.seed}:{lcfg.name}:diurnal")
            snap = max(0.5, cfg.broker_window_s / 3.0)
            phases: list[dict[str, Any]] = []
            next_id = [0]

            def leg(conc: int, phase_stop) -> dict[str, Any] | None:
                s = run_load(
                    client, None, conc, make_input,
                    journal_path=root / "loadgen.jsonl",
                    stop_event=phase_stop, decode=decode,
                    window_s=cfg.broker_window_s, snapshot_every_s=snap,
                    first_id=next_id[0])
                next_id[0] += s["issued"]
                return s

            for i in range(max(0, cfg.broker_phases)):
                if stop.is_set():
                    break
                conc = (cfg.broker_low_concurrency if i % 2 == 0
                        else cfg.broker_high_concurrency)
                dur = cfg.broker_phase_secs * (0.8 + 0.4 * rng.random())
                phase_stop = threading.Event()

                def pace(deadline=time.monotonic() + dur, ps=phase_stop):
                    while time.monotonic() < deadline \
                            and not stop.is_set():
                        time.sleep(0.1)
                    ps.set()

                pacer = threading.Thread(target=pace, daemon=True,
                                         name=f"chaos-load-pace{i}")
                pacer.start()
                s = leg(conc, phase_stop)
                pacer.join(timeout=5)
                phases.append({"phase": i, "concurrency": conc,
                               "duration_s": round(dur, 3),
                               "summary": s})
            if not stop.is_set():
                s = leg(cfg.broker_low_concurrency, stop)
                phases.append({"phase": len(phases),
                               "concurrency": cfg.broker_low_concurrency,
                               "duration_s": None, "summary": s})
            load_result["summary"] = _merge_load_summaries(
                [p["summary"] for p in phases])
            load_result["phases"] = [
                {k: v for k, v in p.items() if k != "summary"}
                for p in phases]

        t = threading.Thread(target=drive, daemon=True, name="chaos-load")
        t.start()
        return t, stop

    def _stop_serving(self, cluster: LocalProcessCluster,
                      sup: ClusterSupervisor, num_workers: int,
                      loadgen_thread, load_stop) -> None:
        """Orderly serving teardown once the publisher hit its target:
        stop the offered load, then SIGTERM the replicas so their
        graceful drain sheds anything still queued with a TYPED reject
        (the zero-drop evidence), closing any recovery episodes their
        heartbeats can prove resumed."""
        load_stop.set()
        loadgen_thread.join(timeout=60)
        st = cluster.status()
        if st is not None and sup.open_episodes:
            for w in st["workers"]:
                if w["worker"] in sup.open_episodes:
                    resumed = worker_resumed_step_since_spawn(
                        w, events=("step", "heartbeat"))
                    if resumed is not None:
                        sup.close_episode(w["worker"], *resumed)
        # stop whatever the roster holds NOW (a brokered trial's ids
        # grow past the boot-time range), never worker 0 — the
        # publisher already finished and its final save must not race
        # a SIGTERM
        live = (sorted(w["worker"] for w in st["workers"])
                if st is not None else list(range(num_workers)))
        for k in live:
            if k != 0:
                cluster.stop_all(worker=str(k))
        cluster.wait_drained(15.0)

    def _drain(self, cluster: LocalProcessCluster,
               sup: ClusterSupervisor | None = None) -> None:
        """The supervisor returns when the FASTEST worker hits the
        target; wait for the rest to finish their final save and exit
        before teardown, or the determinism check would compare
        checkpoints torn short by our own kill_all. Workers that died
        for good (exhausted budget) are not waited for, and a live
        worker whose log stops moving for a whole stall window (a
        permanently SIGSTOPped straggler past its restart budget —
        alive to kill -0 forever) is given up on early rather than
        riding out the full drain timeout.

        The stall clock is PER WORKER and does not start until that
        worker has logged at least one line since its own (re)spawn: a
        worker restarted near the end of the run may spend a whole boot
        (> drain_stall_s with a cold kernel build) producing no log
        movement, and a global clock would kill it mid-boot — silently
        downgrading the trial to determinism-skipped. A worker that
        never logs at all is still bounded by drain_timeout_s.

        With ``sup``, the drain also CLOSES recovery episodes the
        supervised loop left open: a worker restarted near run-end
        finishes its boot here, and the tick its first STEP record
        since its own spawn lands is its first-moved-step (the compile
        record alone is not a resume — see
        ``worker_resumed_step_since_spawn``) —
        the ``resume`` event (with MTTR) would otherwise never be
        journaled and the trial would undercount its episodes."""
        deadline = time.monotonic() + self.cfg.drain_timeout_s
        stall_window = self.cfg.drain_stall_s
        last_progress: dict[int, Any] = {}
        moved_at: dict[int, float] = {}
        while time.monotonic() < deadline:
            st = cluster.status()
            if st is not None and sup is not None and sup.open_episodes:
                # swept BEFORE the all-dead return: a restarted worker
                # that resumed, finished, and exited between supervise
                # and the first drain tick still closes its episode
                for w in st["workers"]:
                    if w["worker"] in sup.open_episodes:
                        resumed = worker_resumed_step_since_spawn(w)
                        if resumed is not None:
                            sup.close_episode(w["worker"], *resumed)
            if st is None or not any(w["alive"] for w in st["workers"]):
                return
            # below the all-dead return: the stall loop is prog's only
            # consumer, and every drain ends through that return — the
            # final tick must not pay the per-worker tail sweep
            prog = cluster.worker_progress()
            now = time.monotonic()
            stalled: list[bool] = []
            for w in st["workers"]:
                if not w["alive"]:
                    continue
                k = w["worker"]
                if k not in moved_at or prog.get(k) != last_progress.get(k):
                    last_progress[k] = prog.get(k)
                    moved_at[k] = now
                if not worker_logged_since_spawn(w):
                    moved_at[k] = now  # booting: hold its clock at zero
                    stalled.append(False)
                else:
                    stalled.append(now - moved_at[k] >= stall_window)
            if stalled and all(stalled):
                logger.warning("drain: no log movement for %.0fs on any "
                               "live worker — giving up early",
                               stall_window)
                return
            time.sleep(self.cfg.resolved_poll_secs())
        logger.warning("drain timed out with workers still alive — "
                       "tearing down anyway")

    # -- the campaign ---------------------------------------------------

    def run(self) -> dict[str, Any]:
        from ..obsv.journal import summarize_disk_chaos
        cfg = self.cfg
        if cfg.root.exists():
            shutil.rmtree(cfg.root)  # stale trial state must not bleed in
        cfg.root.mkdir(parents=True, exist_ok=True)
        report_path = cfg.root / "chaos_report.jsonl"
        records: list[dict[str, Any]] = []

        # fault-free same-seed reference: ONE worker (every local
        # worker runs the identical independent program, so one
        # reference serves all of them)
        logger.info("chaos: reference run (fault-free, 1 worker)")
        ref = self._run_trial("reference", FaultPlan(), cfg.seed,
                              num_workers=1)
        if ref["outcome"] != "completed":
            raise ClusterError(
                f"chaos reference run did not complete: "
                f"{ref.get('error', ref['outcome'])} — no baseline to "
                "judge trials against")
        self.reference_dir = cfg.root / "reference" / "worker0"
        # the reference's measured boot (cold compile into the shared
        # cache) drives every trial's stall timeout; trials re-measure,
        # so warm boots keep tightening it
        self._measured_boot_s = ref.get("boot_s")
        if self._measured_boot_s:
            logger.info(
                "chaos: reference boot %.1fs → trial stall timeout %.1fs "
                "(was %.1fs un-measured)", self._measured_boot_s,
                cfg.resolved_stall_timeout_s(self._measured_boot_s),
                cfg.resolved_stall_timeout_s())

        reproducer: dict[str, Any] | None = None
        serving = cfg.payload == "serving"
        nw = cfg.trial_num_workers()
        for t in range(cfg.trials):
            if serving and cfg.broker and cfg.max_faults == 0:
                # broker-only campaign: the load trace IS the chaos —
                # a fault-free schedule isolates the autoscale path
                # (the gate: roster changes licensed, dropped==0)
                schedule = ChaosSchedule(seed=cfg.seed, trial=t,
                                         faults=())
            elif serving and cfg.network:
                # transport faults only: the proxies carry the whole
                # chaos load, so the protocol-hardening claims are
                # tested in isolation from process death
                schedule = generate_network_schedule(
                    cfg.seed, t, list(range(1, 1 + cfg.serve_replicas)),
                    max_faults=cfg.max_faults,
                    min_faults=max(2, cfg.min_faults))
            elif serving:
                # faults target the BOOT-TIME replicas only: a donor
                # trainer's slot may be traded away mid-run, and a
                # fault addressed to a dead id would no-op silently
                schedule = generate_serving_schedule(
                    cfg.seed, t, list(range(1, 1 + cfg.serve_replicas)),
                    cfg.serve_fault_window, cfg.step_window(),
                    max_faults=cfg.max_faults, min_faults=cfg.min_faults,
                    stall_ms_range=cfg.resolved_stall_ms_range())
            elif cfg.disk:
                # storage faults only: the workers' own durable-write
                # shims carry the whole chaos load, so the atomic-save
                # protocol's claims are tested in isolation from
                # supervisor-injected process faults (bar the one kill
                # the crash_rename pairing needs)
                schedule = generate_disk_schedule(
                    cfg.seed, t, cfg.num_workers, cfg.step_window(),
                    cfg.save_interval_steps,
                    max_faults=cfg.max_faults,
                    min_faults=max(3, cfg.min_faults))
            else:
                schedule = generate_schedule(
                    cfg.seed, t, cfg.num_workers, cfg.step_window(),
                    max_faults=cfg.max_faults, min_faults=cfg.min_faults,
                    stall_ms_range=cfg.resolved_stall_ms_range(),
                    resize_worlds=cfg.resolved_resize_worlds(),
                    resize_prob=cfg.resize_prob)
            logger.info("chaos trial %d/%d: %s", t + 1, cfg.trials,
                        schedule.describe())
            rel = f"trial{t:03d}"
            # the serving kwarg rides only when armed: train/shell
            # campaigns keep the historical _run_trial signature (test
            # harnesses subclass and override it)
            outcome = self._run_trial(rel, schedule.to_fault_plan(),
                                      cfg.seed, nw,
                                      measured_boot_s=self._measured_boot_s,
                                      **({"serving": True} if serving
                                         else {}))
            if outcome.get("boot_s"):
                # warm boots keep tightening (never loosening past the
                # cap) the next trial's detection window
                self._measured_boot_s = outcome["boot_s"]
            check = check_run(cfg.root / rel, outcome=outcome,
                              reference_dir=self.reference_dir)
            rec = {"event": "chaos_trial", "trial": t, "seed": cfg.seed,
                   "schedule": schedule.to_json_dict(),
                   "described": schedule.describe(),
                   "outcome": outcome["outcome"], "step": outcome.get("step"),
                   "target": cfg.until_step,
                   "duration_s": outcome["duration_s"],
                   # per-trial MTTR: detect→first-moved-step per episode
                   # (summarize_recovery_events), the chaos report's
                   # first-class recovery-latency metric
                   "mttr": (outcome.get("recovery") or {}).get("mttr"),
                   "boot_s": outcome.get("boot_s"),
                   "stall_timeout_s": (outcome.get("supervisor") or {})
                   .get("stall_timeout_s"),
                   # scheduled vs actually-fired: a fault that never
                   # landed (kill after run-end) must be visible, not
                   # silently green
                   "faults": count_fired_faults(cfg.root / rel, schedule),
                   # elastic world reshapes this trial performed
                   "reconfigures": ((outcome.get("recovery") or {})
                                    .get("reconfigure") or {}).get("count", 0),
                   "final_world": outcome.get("final_world"),
                   # serving mode: the load generator's one-line sweep
                   # summary (requests, dropped, p50/p99, rejects,
                   # model steps served) rides into the campaign report
                   "serving": outcome.get("serving"),
                   "serve_swaps": outcome.get("serve_swaps"),
                   # network-mode evidence (net_* firings by kind,
                   # dedup hits, retry percentiles); None off-mode
                   "net": outcome.get("net"),
                   # disk-mode evidence (storage-fault firings by
                   # action, failed/skipped saves, fallback restores);
                   # None off-mode
                   "disk": (summarize_disk_chaos(cfg.root / rel)
                            if cfg.disk else None),
                   "verdicts": check["verdicts"],
                   "violations": check["violations"]}
            if outcome.get("broker"):
                rec["broker"] = True
                rec["autoscale"] = outcome.get("autoscale")
            if outcome.get("discipline") is not None:
                rec["discipline"] = outcome["discipline"]
            if check["violations"] and cfg.shrink and reproducer is None:
                shrunk = self._shrink(t, schedule, check)
                rec["shrunk"] = shrunk
                reproducer = shrunk
            records.append(rec)
            # the one journal write that bypasses JsonlSink: same
            # debug-gated schema enforcement (obsv/schema.py)
            maybe_check_event(rec, source="chaos_report.jsonl")
            with open(report_path, "a") as fh:
                fh.write(json.dumps(rec, default=str) + "\n")

        from ..obsv.journal import summarize_chaos
        summary = summarize_chaos(report_path)
        summary["report_path"] = str(report_path)
        (cfg.root / "chaos_report.json").write_text(
            json.dumps(summary, default=str))
        return summary

    # -- shrinking ------------------------------------------------------

    def _shrink(self, trial: int, schedule: ChaosSchedule,
                check: dict[str, Any]) -> dict[str, Any]:
        """Greedily reduce the failing schedule: drop faults while the
        SAME invariant keeps failing (each probe is a full re-run +
        re-check), then emit the minimal reproducer FaultPlan JSON."""
        cfg = self.cfg
        violated = {v["invariant"] for v in check["violations"]}
        probes = [0]

        def still_fails(faults: tuple[ChaosFault, ...]) -> bool:
            cand = ChaosSchedule(seed=schedule.seed, trial=schedule.trial,
                                 faults=faults)
            rel = f"trial{trial:03d}_shrink{probes[0]:02d}"
            probes[0] += 1
            logger.info("shrink probe %s: %s", rel, cand.describe())
            outcome = self._run_trial(rel, cand.to_fault_plan(), cfg.seed,
                                      cfg.trial_num_workers(),
                                      measured_boot_s=self._measured_boot_s,
                                      **({"serving": True}
                                         if cfg.payload == "serving"
                                         else {}))
            got = check_run(cfg.root / rel, outcome=outcome,
                            reference_dir=self.reference_dir)
            return bool({v["invariant"] for v in got["violations"]}
                        & violated)

        minimal, spent = shrink_faults(schedule.faults, still_fails,
                                       max_probes=cfg.shrink_max_probes)
        mini = ChaosSchedule(seed=schedule.seed, trial=schedule.trial,
                             faults=minimal)
        plan_path = cfg.root / f"reproducer_trial{trial:03d}.json"
        plan_path.write_text(json.dumps(
            mini.to_fault_plan().to_json_dict(), indent=2))
        sched_path = cfg.root / f"reproducer_trial{trial:03d}_schedule.json"
        sched_path.write_text(json.dumps(mini.to_json_dict(), indent=2))
        return {"faults": [f.to_dict() for f in minimal],
                "described": mini.describe(),
                "invariants": sorted(violated), "probes": spent,
                "fault_plan_path": str(plan_path),
                "schedule_path": str(sched_path)}


def run_campaign(cfg: ChaosConfig) -> dict[str, Any]:
    return ChaosCampaign(cfg).run()
