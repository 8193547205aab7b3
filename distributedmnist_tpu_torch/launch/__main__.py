"""The port's CLI (≙ ``distributedmnist_tpu/launch/__main__.py``), the
``train``, ``eval``, ``serve``, ``serve-load``, ``sweep``, ``report``,
``devices``, ``cluster`` and ``campaign`` verbs:

  python -m distributedmnist_tpu_torch.launch train --config C.json \\
      [section.key=value ...] [--device cpu]
  torchrun --nproc-per-node P -m distributedmnist_tpu_torch.launch train \\
      --config C.json mesh.num_replicas=N ... [--dist-backend nccl|gloo]
  python -m distributedmnist_tpu_torch.launch eval --train_dir D \\
      [--eval_dir E] [--single_device] [--max_evals N] [--device cpu]
  python -m distributedmnist_tpu_torch.launch serve --train-dir D \\
      --serve-dir S [--precision-tier fp32|bf16|int8] [--device cpu]
  python -m distributedmnist_tpu_torch.launch serve --decode \\
      --train-dir D --serve-dir S [--device cpu] [decode/serve flags]
  python -m distributedmnist_tpu_torch.launch serve [--decode] \\
      --train-dir D --serve-dir S --tp-ranks N [--device cpu]
  python -m distributedmnist_tpu_torch.launch serve-load \\
      --endpoints HOST:PORT[,...] | --cluster-root R [--requests N]
  python -m distributedmnist_tpu_torch.launch sweep --configs DIR_OR_FILE \\
      --results R [--only a,b] [--device cpu]
  python -m distributedmnist_tpu_torch.launch report --train_dir D \\
      [--eval_dir E] --out O [--name N]
  python -m distributedmnist_tpu_torch.launch devices [--device cpu]
  python -m distributedmnist_tpu_torch.launch cluster ACTION \\
      [--config C.json] [--device cpu] [cluster flags]
  python -m distributedmnist_tpu_torch.launch campaign [--groups G,...] \\
      [--quick] [--finalize-only] [--results R] [--device cpu]

``train`` builds the :class:`~..train.loop.Trainer` from the config and
its dotted overrides — any model the port has (``mnist_cnn``,
``resnet20`` on ``data.dataset=cifar10`` with a ``data.data_dir`` of
pickle batches, ``transformer`` over any number of replicas, with
``model.remat`` ``full`` or ``save_attn``), every optimizer (sgd,
momentum, lars, lamb), ``train.grad_accum_steps``,
``precision.param_dtype`` with or without ``master_weights``, ZeRO-1
(``parallel.shard_weight_update``, ``comm_buckets``,
``resident_sharded``, ``shard_min_leaf_size``) and the profiler windows
(``train.profile_steps``, ``train.trace_every_steps``), a
transformer with mixture-of-experts FFNs (``model.num_experts``) —
runs it, evaluates the test split and prints the
reference's last line ``{"summary": ..., "test": ...}`` (a SIGTERM/
SIGINT mid-run flushes a checkpoint, prints the summary alone and exits
with ``train.resumable_exit_code``). Under ``torchrun`` (``WORLD_SIZE``
set) it first joins the process group
(:func:`~..core.mesh.initialize_distributed`): the replicas split
evenly over the processes, ``P = P_r·m·s·e`` with each replica over
``m·s·e`` of them under tensor, sequence and expert parallelism
(``mesh.model_parallelism`` / ``seq_parallelism`` /
``expert_parallelism``), one device each (``cuda:$LOCAL_RANK``, or
``--device``), ``--dist-backend`` ``nccl`` on the card and ``gloo`` on
the CPU by default; every rank prints the last line, and the group is
torn down on every exit. ``eval`` runs the continuous evaluator
(:class:`~..evalsvc.evaluator.Evaluator`) on ``D``: each new checkpoint
once, the source paper's ``Num examples: ... Precision @ 1: ...`` line
for each; without ``--single_device`` it builds the training mesh, under
``torchrun`` (joining its group) where that mesh spans processes (a
pipeline-, tensor- or expert-parallel run: rank 0 prints and
journals). ``serve`` boots a :class:`~..servesvc.server.ServingReplica`
(one-shot classification, preferring the ``--precision-tier`` sidecar)
or, with ``--decode``, a :class:`~..servesvc.decode.DecodeReplica` on
the newest loadable checkpoint in ``D`` (adopting the run config saved
in it), follows ``D``'s publishes, serves until SIGTERM/SIGINT, and
drains. ``serve-load`` drives replicas closed-loop through the failover
client, journals every request to ``--out`` and prints the summary.
``sweep`` runs every config of a directory (:mod:`.sweep`: fresh runs,
``sweep_results.jsonl``, ``report.md``) and prints each experiment's
name, test accuracy and examples/sec; ``report`` writes a run's
``stats.json`` and figures (:mod:`..obsv.report`) and prints the stats;
``devices`` prints the process index and count and each device's index
and name. ``cluster`` forwards to :func:`.cluster.main`: the local
process cluster (create, delete, status, run, kill-all, exec, download,
poll), the self-healing supervisor (``supervise``, ``reconfigure``), the
resource broker over a mixed roster (``broker``) and the seeded chaos
campaign (``chaos``), whose workers are this CLI's own
``train`` processes, or with ``--payload serving`` a ``train``
publisher and ``serve`` replicas under a closed-loop load
(``--serve-decode``: decode replicas; ``--network``: transport faults
through the chaos proxies of :mod:`.netchaos`). ``campaign`` forwards
to :func:`.campaign.main`: the source paper's experiment grids (quorum,
interval, CDF, extras, the 99% repro with the evaluator live) on one
device, into ``results_torch/``. A ``train`` process whose environment names
``DMT_STANDBY_ACTIVATION`` is a warm standby: it precompiles, writes
``<activation>.ready``, parks until the activation file appears and
then adopts the ``train_dir`` it names
(:meth:`~..train.loop.Trainer.adopt_train_dir`); a ``serve`` process
with it is a warm serving spare: it waits for the publish dir's config,
makes its CUDA context and loads its kernel libraries (on the card),
writes ``<activation>.ready``, parks, and on promotion serves in the
worker logdir the activation file names — the pool the resource broker
(``cluster broker``, the chaos campaign's ``broker``) promotes a
scale-up replica from. The flag names are the reference CLI's. The
device is ``cuda:0`` unless ``--device`` names another; without CUDA
the default
is an error, not a CPU run. ``train``, ``eval`` and ``serve`` first
switch on the kernel build cache (``compile.cache_dir`` or
``DMT_COMPILE_CACHE_DIR``: the kernel libraries are built into and
loaded from ``<dir>/kernels``, :mod:`..core.compile_cache`), as the
reference's entry points switch on its persistent compile cache.

Accepted and not run, each logged once a Trainer: device prefetch, the
native loader and the ``compile.*`` knobs. Not ported yet (each raises):
ZeRO-1 over tensor-, sequence-, pipeline- or expert-parallel replicas,
the gcloud backend (``cluster --backend gcloud``), and the reference's
``pod`` and ``fetch`` verbs.

``serve --tp-ranks N`` (or ``serve.tp_ranks``) serves one replica as a
tensor-parallel group of ``N`` processes (:mod:`..servesvc.tp_group`):
this process becomes the group's supervisor and starts every rank as
``serve ... --tp-rank r`` with the group's rendezvous in its
environment; rank 0 serves (the socket, ``serve.json``, the journals),
ranks > 0 follow it, each on ``cuda:(r mod device_count)`` (or
``--device``) over NCCL when the host has a card a rank, else gloo.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

_SERVE_FLAGS = ("host", "port", "max_batch", "queue_depth",
                "batch_window_ms", "poll_secs", "default_deadline_ms",
                "precision_tier", "compute_dtype", "tp_ranks")
_DECODE_FLAGS = ("decode_slots", "max_new_tokens", "max_prompt_len",
                 "swap_policy", "attention_kernel")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="distributedmnist_tpu_torch.launch")
    sub = p.add_subparsers(dest="cmd", required=True)
    pt = sub.add_parser("train", help="run a training experiment (one "
                                      "process, or one a device under "
                                      "torchrun)")
    pt.add_argument("--config", default=None)
    pt.add_argument("--device", default=None,
                    help="torch device (default cuda:$LOCAL_RANK, else "
                         "cuda:0; 'cpu' runs the plain versions of the "
                         "kernels)")
    pt.add_argument("--dist-backend", dest="dist_backend", default=None,
                    choices=("nccl", "gloo"),
                    help="process-group backend under torchrun (default "
                         "nccl on a CUDA device, gloo on the CPU)")
    pt.add_argument("overrides", nargs="*", help="dotted overrides k=v")
    pe = sub.add_parser("eval", help="continuous evaluator: evaluate "
                                     "each new checkpoint of a train_dir "
                                     "once")
    from ..evalsvc.__main__ import add_eval_arguments
    add_eval_arguments(pe)
    pv = sub.add_parser(
        "serve", help="serving replica: hot-follow a train_dir's "
                      "published checkpoints (digest-verified, torn "
                      "publishes skipped) and serve inference over a "
                      "local socket with admission control and "
                      "zero-drop weight hot-swap")
    pv.add_argument("--train-dir", "--train_dir", dest="train_dir",
                    required=True, help="the publish dir to follow")
    pv.add_argument("--serve-dir", dest="serve_dir", default=".",
                    help="where serve.json / serve_log.jsonl / "
                         "heartbeats land")
    pv.add_argument("--device", default=None,
                    help="torch device (default cuda:0; 'cpu' runs the "
                         "plain versions of the kernels)")
    pv.add_argument("--decode", action="store_true",
                    help="serve continuous-batching autoregressive "
                         "decode (streaming tokens over a paged KV "
                         "cache) instead of one-shot classification")
    pv.add_argument("--host", default=None)
    pv.add_argument("--port", type=int, default=None,
                    help="0 = ephemeral (the bound port is published in "
                         "serve.json)")
    pv.add_argument("--max-batch", type=int, default=None, dest="max_batch")
    pv.add_argument("--queue-depth", type=int, default=None,
                    dest="queue_depth",
                    help="admission bound; a full queue sheds with a "
                         "typed reject")
    pv.add_argument("--batch-window-ms", type=float, default=None,
                    dest="batch_window_ms")
    pv.add_argument("--poll-secs", type=float, default=None,
                    dest="poll_secs", help="checkpoint-follow cadence")
    pv.add_argument("--default-deadline-ms", type=float, default=None,
                    dest="default_deadline_ms")
    pv.add_argument("--precision-tier", default=None,
                    dest="precision_tier",
                    help="fp32 | bf16 | int8 — prefer the named "
                         "quantized sidecar tier (quant.publish_tiers) "
                         "over the full-precision artifact; absent or "
                         "torn sidecars fall back to fp32, journaled")
    pv.add_argument("--compute-dtype", default=None, dest="compute_dtype",
                    help="serving-side compute dtype override "
                         "(serve.compute_dtype)")
    pv.add_argument("--decode-slots", type=int, default=None,
                    dest="decode_slots",
                    help="concurrently generating sequences "
                         "(decode.decode_slots)")
    pv.add_argument("--max-new-tokens", type=int, default=None,
                    dest="max_new_tokens",
                    help="per-request generation ceiling "
                         "(decode.max_new_tokens)")
    pv.add_argument("--max-prompt-len", type=int, default=None,
                    dest="max_prompt_len",
                    help="longest admissible prompt "
                         "(decode.max_prompt_len)")
    pv.add_argument("--swap-policy", default=None, dest="swap_policy",
                    help="pin | restart — what a weight hot-swap does "
                         "to sequences mid-generation "
                         "(decode.swap_policy)")
    pv.add_argument("--attention-kernel", default=None,
                    dest="attention_kernel",
                    help="dense | paged — decode attention "
                         "(decode.attention_kernel); paged runs the "
                         "paged-attention kernel")
    pv.add_argument("--tp-ranks", type=int, default=None, dest="tp_ranks",
                    help="serve the replica as an N-rank tensor-parallel "
                         "process group (serve.tp_ranks): rank 0 owns "
                         "the socket, every rank holds its shard of the "
                         "model; any rank dying takes the whole group "
                         "down for a unit restart")
    pv.add_argument("--tp-rank", type=int, default=None, dest="tp_rank",
                    help=argparse.SUPPRESS)  # set by the group's
    # supervisor when it starts each rank
    pl = sub.add_parser(
        "serve-load", help="closed-loop load generator over serving "
                           "replicas (failover client, per-request "
                           "journal, p50/p99 summary)")
    pl.add_argument("--cluster-root", default=None,
                    help="a root to discover worker*/serve.json "
                         "endpoints from")
    pl.add_argument("--endpoints", default=None,
                    help="comma-separated host:port list (overrides "
                         "--cluster-root)")
    pl.add_argument("--requests", type=int, default=200)
    pl.add_argument("--concurrency", type=int, default=2)
    pl.add_argument("--deadline-s", type=float, default=5.0,
                    dest="deadline_s")
    pl.add_argument("--max-attempts", type=int, default=6,
                    dest="max_attempts")
    pl.add_argument("--ready-timeout-s", type=float, default=120.0,
                    dest="ready_timeout_s")
    pl.add_argument("--out", default="loadgen.jsonl",
                    help="per-request journal path")
    ps = sub.add_parser("sweep", help="run a directory of experiment "
                                      "configs")
    ps.add_argument("--configs", required=True)
    ps.add_argument("--results", required=True)
    ps.add_argument("--only", default=None, help="comma-separated names")
    ps.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    pr = sub.add_parser("report", help="figures + stats from run logs")
    pr.add_argument("--train_dir", required=True)
    pr.add_argument("--eval_dir", default=None)
    pr.add_argument("--out", required=True)
    pr.add_argument("--name", default="experiment")
    pc = sub.add_parser(
        "cluster", add_help=False,
        help="local process cluster of `launch train` workers: "
             "lifecycle, fault plans, command journal, supervised "
             "self-healing runs, seeded chaos campaigns with invariant "
             "checking (`cluster chaos --trials N --seed S`)")
    pc.add_argument("rest", nargs=argparse.REMAINDER)
    pd = sub.add_parser("devices", help="show the process and its devices")
    pd.add_argument("--device", default=None,
                    help="'cpu' lists the CPU (default: the CUDA devices, "
                         "an error without CUDA)")
    return p


def build_trainer(argv: list[str], **trainer_kwargs):
    """Parse ``train`` arguments and construct (not run) the Trainer —
    the object ``train`` runs, for callers that drive it in process
    (``trainer_kwargs`` go to ``Trainer``)."""
    args = build_parser().parse_args(argv)
    if args.cmd != "train":
        raise SystemExit(f"build_trainer wants the train verb, got "
                         f"{args.cmd!r}")
    from ..core.config import ExperimentConfig, parse_cli_overrides
    from ..train.loop import Trainer

    cfg = (ExperimentConfig.from_file(args.config) if args.config
           else ExperimentConfig())
    cfg = cfg.override(parse_cli_overrides(args.overrides))
    return Trainer(cfg, device=args.device, **trainer_kwargs)


def _park_standby(trainer, activation: str) -> None:
    """The warm-standby protocol (≙ the reference's ``_park_standby``):
    precompile, signal readiness by writing ``<activation>.ready``, then
    PARK until the supervisor's promotion writes the activation file
    (an atomic rename — never read torn) naming the dead worker's
    train_dir, and adopt it. The parked process has already paid
    import, the kernel build and the capture, so promotion → first
    moved step is data-path time only."""
    import os
    from pathlib import Path

    try:
        trainer.precompile()
    except Exception as e:  # park anyway: a warm PROCESS still beats a
        # cold boot even if the capture must happen at the first step
        print(f"standby precompile failed ({type(e).__name__}: {e}); "
              "parking warm-process only", file=sys.stderr)
    act = Path(activation)
    act.parent.mkdir(parents=True, exist_ok=True)
    ready = act.with_name(act.name + ".ready")
    ready.write_text(json.dumps({"pid": os.getpid(),
                                 "ready_at": time.time()}))
    while not act.exists():
        time.sleep(0.1)
    assignment = json.loads(act.read_text())
    trainer.adopt_train_dir(assignment["train_dir"])


def _deterministic_cpu() -> None:
    """Put a CPU training process on torch's deterministic kernels. The
    one that matters is ``index_put_`` with ``accumulate=True`` (the
    backward of the transformer's ``embed[tokens]`` lookup): on several
    threads it adds rows with atomics, in an order that changes run to
    run, so the final params would not be bitwise the fault-free run's;
    the deterministic path adds them serially, in index order."""
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)


def train(argv: list[str]) -> None:
    """``launch train``: join the process group ``torchrun`` describes
    (if any), park as a warm standby when ``DMT_STANDBY_ACTIVATION``
    names an activation file, run, evaluate, print the summary line;
    leave the group on every exit."""
    import os

    from ..core.compile_cache import enable_persistent_cache
    from ..core.mesh import initialize_distributed, shutdown_distributed

    args = build_parser().parse_args(argv)
    initialize_distributed(args.dist_backend, args.device)
    try:
        trainer = build_trainer(argv)
        if trainer.device.type == "cpu":
            _deterministic_cpu()
        enable_persistent_cache(trainer.cfg.compile)
        activation = os.environ.get("DMT_STANDBY_ACTIVATION")
        if activation:
            _park_standby(trainer, activation)
        summary = trainer.run()
        shown = {k: v for k, v in summary.items() if k != "timing"}
        if summary.get("preempted"):
            print(json.dumps({"summary": shown}, default=str), flush=True)
            sys.exit(trainer.cfg.train.resumable_exit_code)
        result = trainer.evaluate("test")
        print(json.dumps({"summary": shown, "test": result}, default=str),
              flush=True)
    finally:
        shutdown_distributed()


def build_replica(argv: list[str]):
    """Parse ``serve`` arguments and construct (not start) the replica
    ``serve`` runs — a ``DecodeReplica`` with ``--decode``, else the
    classification ``ServingReplica`` — for callers that drive it in
    process."""
    args = build_parser().parse_args(argv)
    if args.cmd != "serve":
        raise SystemExit(f"build_replica wants the serve verb, got "
                         f"{args.cmd!r}")
    from ..servesvc.server import wait_for_run_config

    return _make_replica(args, wait_for_run_config(args.train_dir))


def _tp_supervisor_args(argv: list[str]):
    """The serve flags a TP group's supervisor needs, read without the
    CLI's parser (which imports torch), when the command line names
    ``--tp-ranks N > 1`` and no ``--tp-rank``; else None."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--train-dir", "--train_dir", dest="train_dir")
    p.add_argument("--serve-dir", dest="serve_dir", default=".")
    p.add_argument("--tp-ranks", type=int, dest="tp_ranks")
    p.add_argument("--tp-rank", type=int, dest="tp_rank")
    try:
        got, _ = p.parse_known_args(argv[1:])
    except SystemExit:
        return None  # the full parser reports it
    if ((got.tp_ranks or 0) > 1 and got.tp_rank is None and got.train_dir
            and not {"-h", "--help"} & set(argv)):
        return got
    return None


def _supervise_tp_group(args, argv: list[str], tp_ranks: int,
                        cfg=None) -> None:
    """A TP group's supervisor: this very command once a rank (rank 0
    the replica, the others its followers), babysat die-as-a-unit, with
    the run config's restart budget and poll cadence (read, when not
    given, while the ranks boot, after the whole command line is
    checked: a bad flag ends the supervisor, and its ranks with it)."""
    from ..servesvc.tp_group import ServeGroup, default_spawn_fn

    def configure(group) -> None:
        run = cfg
        if run is None:
            from ..train.checkpoint import wait_for_run_config
            build_parser().parse_args(argv)
            run = wait_for_run_config(args.train_dir)
        group.max_restarts = run.serve.tp_group_max_restarts
        group.poll_secs = run.serve.tp_group_poll_secs
    ServeGroup(args.serve_dir, tp_ranks,
               default_spawn_fn(argv, args.serve_dir, tp_ranks)
               ).run_forever(after_start=configure)


def _serve_tp_rank(args, cfg, tp_ranks: int) -> None:
    """One rank of a TP serving group: join the group (the rendezvous
    its supervisor put in the environment), on ``--device`` or
    ``cuda:(rank mod device_count)``, build the replica on the group's
    topology and serve (rank 0) or follow (ranks > 0); the group is
    torn down on every exit."""
    import torch

    from ..core.compile_cache import enable_persistent_cache
    from ..core.device import resolve_device
    from ..core.log import get_logger
    from ..core.mesh import (initialize_distributed, serving_backend,
                             shutdown_distributed)
    from ..servesvc.tp_group import (GROUP_TIMEOUT_S, process_started_at,
                                     run_rank_follower)

    marks = {"started": process_started_at(), "imported": time.time()}
    rank = args.tp_rank
    if args.device is None:
        args.device = (f"cuda:{rank % torch.cuda.device_count()}"
                       if torch.cuda.is_available() else "cuda:0")
    device = resolve_device(args.device)
    backend = serving_backend(device, tp_ranks)
    get_logger("tp_group").info(
        "TP serving group: rank %d of %d on %s over %s (%d cards for %d "
        "ranks)", rank, tp_ranks, device, backend,
        torch.cuda.device_count() if device.type == "cuda" else 0,
        tp_ranks)
    initialize_distributed(backend, device, timeout_s=GROUP_TIMEOUT_S)
    marks["joined"] = time.time()
    try:
        args.tp_ranks = tp_ranks
        replica = _make_replica(args, cfg)
        marks["built"] = time.time()
        replica.boot_marks = marks
        enable_persistent_cache(replica.cfg.compile)
        if rank > 0:
            run_rank_follower(replica)
        else:
            replica.serve_forever()
    finally:
        shutdown_distributed()


def _make_replica(args, cfg):
    from ..servesvc.server import ServingReplica

    scfg = dataclasses.replace(
        cfg.serve, **{k: getattr(args, k) for k in _SERVE_FLAGS
                      if getattr(args, k) is not None})
    if not args.decode:
        cfg = cfg.replace(serve=scfg)
        return ServingReplica(args.train_dir, serve_dir=args.serve_dir,
                              scfg=scfg, cfg=cfg, device=args.device)
    from ..servesvc.decode import DecodeReplica
    dcfg = dataclasses.replace(
        cfg.decode, **{k: getattr(args, k) for k in _DECODE_FLAGS
                       if getattr(args, k) is not None})
    cfg = cfg.replace(serve=scfg, decode=dcfg)
    return DecodeReplica(args.train_dir, serve_dir=args.serve_dir,
                         scfg=scfg, dcfg=dcfg, cfg=cfg, device=args.device)


def _warm_serving_spare(args, cfg) -> float:
    """What a parked serving spare pays before it parks, beyond the
    imports and the publish dir's config wait (the reference's spare
    pays only those): on the card, the CUDA context and the kernel
    libraries the replica launches — K1 (``flash_attention_fwd``) for a
    flash model's prefills, K5 (``paged_attention``) for paged decode —
    loaded from the kernel cache. Returns the seconds it took (0.0 on
    the CPU, which has neither)."""
    import torch

    from ..core.compile_cache import enable_persistent_cache
    from ..core.device import resolve_device
    from ..ops._build import load_library

    t0 = time.time()
    device = resolve_device(args.device)
    if device.type != "cuda":
        return 0.0
    enable_persistent_cache(cfg.compile)
    torch.zeros(1, device=device)
    if cfg.model.attention_impl == "flash":
        load_library("flash_attention_fwd")
    if args.decode and (args.attention_kernel
                        or cfg.decode.attention_kernel) == "paged":
        load_library("paged_attention")
    torch.cuda.synchronize(device)
    return time.time() - t0


def _park_serve_standby(activation: str, warm_s: float) -> str:
    """The serving half of the warm-standby protocol (≙ the reference's
    ``_park_serve_standby``): signal ready (``<activation>.ready``, with
    ``warm_s``, the seconds :func:`_warm_serving_spare` took), park
    until the promotion's activation file appears, and return the
    worker logdir it assigns (its ``train_dir`` key, the protocol's
    field name) for the replica to adopt as its serve_dir — it binds
    there and writes ``serve.json`` where ``discover_endpoints``
    looks."""
    import os
    from pathlib import Path

    act = Path(activation)
    act.parent.mkdir(parents=True, exist_ok=True)
    ready = act.with_name(act.name + ".ready")
    ready.write_text(json.dumps({"pid": os.getpid(),
                                 "ready_at": time.time(),
                                 "warm_s": round(warm_s, 3)}))
    while not act.exists():
        time.sleep(0.1)
    return json.loads(act.read_text())["train_dir"]


def serve(argv: list[str]) -> None:
    """``launch serve``: wait for the publish dir's run config, park as a
    warm serving spare when ``DMT_STANDBY_ACTIVATION`` names an
    activation file (then serve in the worker logdir the promotion
    assigns), build the replica and serve until SIGTERM/SIGINT."""
    import os

    activation = os.environ.get("DMT_STANDBY_ACTIVATION")
    early = _tp_supervisor_args(argv)
    if early is not None and not activation:
        # the ranks start before this process imports torch and reads the
        # run config
        _supervise_tp_group(early, argv, early.tp_ranks)
        return
    args = build_parser().parse_args(argv)
    from ..core.compile_cache import enable_persistent_cache
    from ..train.checkpoint import wait_for_run_config

    cfg = wait_for_run_config(args.train_dir)
    if activation:
        args.serve_dir = _park_serve_standby(
            activation, _warm_serving_spare(args, cfg))
    tp_ranks = (args.tp_ranks if args.tp_ranks is not None
                else cfg.serve.tp_ranks)
    if tp_ranks > 1 and args.tp_rank is None:
        _supervise_tp_group(args, argv, tp_ranks, cfg)
        return
    if args.tp_rank is not None:
        _serve_tp_rank(args, cfg, tp_ranks)
        return
    replica = _make_replica(args, cfg)
    enable_persistent_cache(replica.cfg.compile)
    replica.serve_forever()


def serve_load(argv: list[str]) -> dict:
    """``launch serve-load``: wait for a replica's meta, drive the
    replicas closed-loop through the failover client, journal every
    request's outcome to ``--out``; prints and returns the summary."""
    from ..servesvc.client import ServeClient, discover_endpoints
    from ..servesvc.loadgen import make_input_fn, run_load

    args = build_parser().parse_args(argv)
    if args.endpoints:
        eps = [(h, int(p)) for h, p in
               (e.rsplit(":", 1) for e in args.endpoints.split(","))]
        endpoints_fn = lambda: eps  # noqa: E731
    elif args.cluster_root:
        root = args.cluster_root
        endpoints_fn = lambda: discover_endpoints(root)  # noqa: E731
    else:
        raise SystemExit("serve-load needs --endpoints or --cluster-root")
    client = ServeClient(endpoints_fn, deadline_s=args.deadline_s,
                         max_attempts=args.max_attempts)
    deadline = time.time() + args.ready_timeout_s
    meta = None
    while meta is None and time.time() < deadline:
        meta = client.meta(deadline_s=2.0)
        if meta is None:
            time.sleep(0.5)
    if meta is None:
        raise SystemExit(f"no serving replica became ready within "
                         f"{args.ready_timeout_s:.0f}s")
    make_input = make_input_fn(meta["input_shape"], meta["input_dtype"])
    summary = run_load(client, args.requests, args.concurrency,
                       make_input, journal_path=args.out)
    print(json.dumps(summary), flush=True)
    return summary


def sweep(argv: list[str]) -> list[dict]:
    """``launch sweep``: every config of ``--configs`` (or those named by
    ``--only``) through :func:`.sweep.run_sweep`; prints each record's
    name, test accuracy and examples/sec."""
    from .sweep import load_sweep_configs, run_sweep

    args = build_parser().parse_args(argv)
    cfgs = load_sweep_configs(args.configs)
    if args.only:
        cfgs = [c for c in cfgs if c.name in set(args.only.split(","))]
    records = run_sweep(cfgs, args.results, device=args.device)
    print(json.dumps([{k: r[k] for k in ("name", "test_accuracy",
                                         "examples_per_sec")}
                      for r in records]), flush=True)
    return records


def report(argv: list[str]) -> dict:
    """``launch report``: a run's ``stats.json`` and figures; prints the
    stats."""
    from ..obsv.report import generate_report

    args = build_parser().parse_args(argv)
    stats = generate_report(args.train_dir, args.eval_dir, args.out,
                            name=args.name)
    print(json.dumps(stats, indent=2), flush=True)
    return stats


def devices(argv: list[str]) -> dict:
    """``launch devices`` (≙ the reference's, which lists the JAX
    devices): this process's index and the process count (from the
    process group, else ``torchrun``'s environment) and each device's
    index, platform and name — every CUDA device, or the CPU with
    ``--device cpu``."""
    import os

    import torch
    import torch.distributed as dist

    from ..core.device import resolve_device

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    if dist.is_available() and dist.is_initialized():
        index, count = dist.get_rank(), dist.get_world_size()
    else:
        index = int(os.environ.get("RANK", 0))
        count = int(os.environ.get("WORLD_SIZE", 1))
    listed = ([{"id": i, "platform": "gpu",
                "kind": torch.cuda.get_device_name(i)}
               for i in range(torch.cuda.device_count())]
              if dev.type == "cuda" else
              [{"id": 0, "platform": "cpu", "kind": "cpu"}])
    info = {"process_index": index, "process_count": count,
            "devices": listed}
    print(json.dumps(info, indent=2), flush=True)
    return info


def cluster(argv: list[str]) -> None:
    """``launch cluster``: the local process cluster, its supervisor and
    the chaos campaign (:func:`.cluster.main` parses the rest)."""
    from .cluster import main as cluster_main

    cluster_main(argv[1:])


_VERBS = {"sweep": sweep, "report": report, "devices": devices,
          "cluster": cluster}


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "campaign":
        # pre-dispatch: the campaign owns its own flags
        from .campaign import main as campaign_main
        campaign_main(argv[1:])
        return
    if argv and argv[0] == "train":
        train(argv)
        return
    if argv and argv[0] in _VERBS:
        _VERBS[argv[0]](argv)
        return
    if argv and argv[0] == "eval":
        from ..core.mesh import initialize_distributed, shutdown_distributed
        from ..evalsvc.__main__ import evaluator_from_args
        args = build_parser().parse_args(argv)
        # under torchrun the training mesh spans the group's processes
        if not args.single_device:
            initialize_distributed(None, args.device)
        try:
            from ..core.compile_cache import enable_persistent_cache
            evaluator = evaluator_from_args(args)
            enable_persistent_cache()
            evaluator.run()
        finally:
            shutdown_distributed()
        return
    if argv and argv[0] == "serve-load":
        serve_load(argv)
        return
    serve(argv)


if __name__ == "__main__":
    main()
