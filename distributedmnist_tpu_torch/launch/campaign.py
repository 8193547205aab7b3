"""The flagship experiment campaign (≙ ``distributedmnist_tpu/launch/
campaign.py``, the deliverable the reference exists to produce; the
source paper's ``tools/benchmark.py`` drove the same grids on EC2).

Runs the ``configs/`` grid on the port's Trainer, on one device
(``cuda:0`` unless ``--device`` names another), with 8 simulated
replicas wherever a config names no mesh of its own:

* quorum sweep  k ∈ {1,2,4,6,7,8}-of-8
* interval sweep {3000..7000} ms
* worker-time-CDF grid, 4 straggler profiles
* extras: fashion-mnist timeout drop, CIFAR ResNet-20, synthetic-LM
  transformer
* repro_mnist99: ``configs/repro/mnist_99.json`` end to end, with the
  continuous evaluator (``launch eval``) live against it

and the evaluator live against the quorum k=8 run too. The grids, the
overrides and the summary are the reference's, value for value.

Data: the idx and CIFAR-10 fixtures (:mod:`..data.fixtures`) are
written first, so every mnist, fashion_mnist and cifar10 config runs
the real ingest path (idx.gz or pickle parse, normalization, sharding)
on synthetic pixels.

Two departures from the reference:

* ``stop_evaluator`` waits for the evaluator to journal the run's newest
  checkpoint (or for the child to exit, or for ``STOP_BOUND_S``) where
  the reference sleeps a fixed 8 s, which a child still booting when a
  short run ends outlives without evaluating anything;
* results and the data cache default to ``results_torch/`` and
  ``data_cache_torch/`` under the working directory (``results/`` holds
  the reference's campaign).

Entry point: ``python -m distributedmnist_tpu_torch.launch campaign
[--groups g1,g2] [--quick] [--device cpu]``; ``--finalize-only``
regenerates the reports and the summary from disk.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from ..core.config import ExperimentConfig
from ..core.log import JsonlSink, get_logger
from .sweep import run_experiment, write_report

logger = get_logger("campaign")

GROUPS = {
    "quorum": [f"quorum_k{k}_of_8" for k in (1, 2, 4, 6, 7, 8)],
    "interval": [f"interval_{ms}ms" for ms in (3000, 4000, 5000, 6000, 7000)],
    "cdf": ["cdf_uniform", "cdf_lognormal_mild", "cdf_lognormal_heavy",
            "cdf_spike"],
    "extras": ["fashion_mnist_timeout", "cifar10_resnet20_sync",
               "synthetic_lm_transformer"],
    # the one-command 99% repro, with the evaluator live against it
    "repro_mnist99": ["mnist_99"],
    # Experiment A at the source paper's topology: 50 workers,
    # replicas_to_aggregate ∈ {1,10,20,30,40,49,50}; the configs name
    # their own 50-replica mesh (mesh.simulate_devices)
    "quorum50": [f"quorum50_k{k}_of_50" for k in (1, 10, 20, 30, 40, 49, 50)],
    # Experiment C at that topology: the four worker-time CDF profiles
    "cdf50": ["cdf50_uniform", "cdf50_lognormal_mild",
              "cdf50_lognormal_heavy", "cdf50_spike"],
    # convergence proofs for the two disciplines the grids leave short
    "long": ["interval_long", "cdf50_long"],
}

# Groups a plain `launch campaign` runs; the 50-replica groups and the
# long runs are launched on their own (--groups quorum50, ...)
DEFAULT_GROUPS = [g for g in GROUPS if g not in ("quorum50", "cdf50", "long")]

# Campaign-local deviations from the configs, recorded verbatim into
# each result record (the reference's values: its CPU-budget scale-downs
# and wall-clock save cadences for the evaluated runs)
OVERRIDES = {
    "cifar10_resnet20_sync": {"train.max_steps": 150, "data.batch_size": 256,
                              "train.log_every_steps": 10},
    "synthetic_lm_transformer": {"train.max_steps": 200},
    # wall-clock checkpoint cadence so the live evaluator sees a stream
    # of checkpoints, not just the final one
    "quorum_k8_of_8": {"train.save_interval_secs": 15.0},
    "mnist_99": {"train.save_interval_secs": 60.0},
    # cdf50 keeps the cdf grid's per-replica batch; the step budget
    # yields (100 timing samples a replica)
    **{f"cdf50_{p}": {"train.max_steps": 100}
       for p in ("uniform", "lognormal_mild", "lognormal_heavy", "spike")},
    # interval sweep: update-count-matched step budgets (steps ∝
    # interval_ms), so the accuracy column compares pacings at equal
    # update budgets
    **{f"interval_{ms}ms": {"train.max_steps": 800 * ms // 1000}
       for ms in (3000, 4000, 5000, 6000, 7000)},
}

EVALUATED_RUN = "quorum_k8_of_8"
# the runs the live evaluator watches (one per group that has one)
EVALUATED_RUNS = {EVALUATED_RUN, "mnist_99", "interval_long", "cdf50_long"}

# the campaign's ambient mesh: a config that names no device count runs
# 8 simulated replicas (the reference forces 8 virtual devices before
# any backend starts); one with its own mesh.simulate_devices keeps it
AMBIENT_REPLICAS = 8

# how long stop_evaluator waits for the final checkpoint's evaluation
# before it stops the evaluator anyway
STOP_BOUND_S = 120.0
STOP_POLL_S = 0.1


def resolve_config_path(configs_dir: Path, name: str) -> Path:
    """Grid configs sit in configs/; repro configs one level down."""
    candidates = [configs_dir / f"{name}.json",
                  configs_dir / "repro" / f"{name}.json"]
    for path in candidates:
        if path.exists():
            return path
    raise FileNotFoundError(
        f"no config named {name!r}; tried "
        + " and ".join(str(p) for p in candidates))


def with_ambient_mesh(cfg: ExperimentConfig) -> ExperimentConfig:
    """``cfg`` on the campaign's ambient mesh: ``AMBIENT_REPLICAS``
    simulated replicas unless the config names its own count. Not a
    per-run override, so it stays out of the record's ``overrides``."""
    if cfg.mesh.simulate_devices == 0:
        return cfg.override({"mesh.simulate_devices": AMBIENT_REPLICAS})
    return cfg


def run_group(group: str, names: list[str], results_dir: Path,
              configs_dir: Path, data_dir: Path, quick: bool,
              device: str = "cuda:0") -> list[dict]:
    gdir = results_dir / group
    gdir.mkdir(parents=True, exist_ok=True)
    records = []
    with JsonlSink(gdir / "sweep_results.jsonl") as sink:
        for name in names:
            cfg = ExperimentConfig.from_file(
                resolve_config_path(configs_dir, name))
            ov = {"data.data_dir": str(data_dir / cfg.data.dataset),
                  "data.download": False}
            ov.update(OVERRIDES.get(name, {}))
            if quick:
                ov["train.max_steps"] = 20
            cfg = with_ambient_mesh(cfg.override(ov))
            # campaign semantics are RUN, not resume: run_experiment's
            # fresh default (train.resume=False) guarantees it without
            # deleting the previous artifacts up front
            ev = None
            if name in EVALUATED_RUNS and not quick:
                ev = start_evaluator(gdir / name, device)
            t0 = time.time()
            try:
                rec = run_experiment(cfg, gdir, device=device)
            finally:
                if ev is not None:
                    stop_evaluator(ev, gdir / name)
                    # redraw this run's report with the evaluator's log
                    # so precision-vs-time (the oracle curve) lands
                    from ..obsv.report import generate_report
                    generate_report(gdir / name / "train",
                                    gdir / name / "eval",
                                    gdir / name / "figures", name=name)
            rec["overrides"] = ov
            rec["group"] = group
            logger.info("[%s] %s done in %.0fs", group, name, time.time() - t0)
            sink.write(rec)
            records.append(rec)
    write_report(records, gdir)
    return records


def start_evaluator(run_dir: Path, device: str = "cuda:0"
                    ) -> subprocess.Popen:
    """Launch the continuous evaluator against a run's train dir (the
    source paper's separate evaluator machine), one device, on the
    campaign's ``device``, under ``nice -n 5`` so it cannot starve the
    trainer it follows (``nice`` as a command prefix: running Python
    before exec in a fork of a threaded parent can deadlock the child).

    The child inherits the environment as it is, the repo root put
    first on ``PYTHONPATH``: the port forces no platform, so there is
    nothing to scrub (the reference strips its forced-mesh settings
    here)."""
    run_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    repo_root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        [repo_root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                       else []))
    with open(run_dir / "evaluator_stdout.log", "w") as log:
        proc = subprocess.Popen(
            ["nice", "-n", "5",
             sys.executable, "-m", "distributedmnist_tpu_torch.launch",
             "eval",
             "--train_dir", str(run_dir / "train"),
             "--eval_dir", str(run_dir / "eval"),
             "--eval_interval_secs", "2.0",
             "--single_device", "--device", str(device)],
            stdout=log, stderr=subprocess.STDOUT,  # child keeps its dup
            env=env)
    logger.info("evaluator pid %d watching %s on %s", proc.pid,
                run_dir / "train", device)
    return proc


def evaluated_steps(eval_dir: Path) -> set[int]:
    """Steps the evaluator journaled in ``eval_log.jsonl`` (a torn last
    line is skipped: the child may still be appending)."""
    path = eval_dir / "eval_log.jsonl"
    steps: set[int] = set()
    if not path.exists():
        return steps
    for line in path.read_text().splitlines():
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if rec.get("event") == "eval" and isinstance(rec.get("step"), int):
            steps.add(rec["step"])
    return steps


def stop_evaluator(proc: subprocess.Popen, run_dir: Path,
                   bound_s: float | None = None) -> dict:
    """Stop the evaluator once it has evaluated the run's newest
    checkpoint (its ``eval_log.jsonl`` holds an ``eval`` record at that
    step), or once it has exited, or after ``bound_s`` (default
    ``STOP_BOUND_S``), whichever comes first; then terminate it (kill
    after 30 s). Returns ``{"waited_s", "ended_by", "step"}``,
    ``ended_by`` one of ``evaluated``, ``exited``, ``bound``."""
    from ..train.checkpoint import latest_checkpoint_step

    bound_s = STOP_BOUND_S if bound_s is None else bound_s
    step = latest_checkpoint_step(run_dir / "train")
    t0 = time.monotonic()
    while True:
        if step is not None and step in evaluated_steps(run_dir / "eval"):
            ended_by = "evaluated"
            break
        if proc.poll() is not None:
            ended_by = "exited"
            break
        if time.monotonic() - t0 >= bound_s:
            ended_by = "bound"
            break
        time.sleep(STOP_POLL_S)
    waited = time.monotonic() - t0
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    logger.info("evaluator stopped after %.1fs (%s, step %s; rc=%s)",
                waited, ended_by, step, proc.returncode)
    return {"waited_s": waited, "ended_by": ended_by, "step": step}


def prune_heavy_artifacts(results_dir: Path) -> None:
    """Drop checkpoint payloads: reproducible from config + seed, and
    tens of MB each."""
    for p in results_dir.rglob("ckpt-*.msgpack"):
        p.unlink()
    for p in results_dir.rglob("CHECKPOINT"):
        p.unlink()


# Self-description for the summary JSON: groups whose accuracy columns
# are step-budget-bounded by design carry a pointer to the long-run
# convergence proof. Each note is keyed (group, proof-run name) and only
# emitted when the cited proof run exists in the same results dir.
SUMMARY_NOTES = {
    ("interval", "interval_long"): (
        "budgets are update-count-matched: steps scale with interval_ms "
        "(campaign OVERRIDES) so every pacing applies ~680-750 updates "
        "— the count long/interval_long converged at — and the accuracy "
        "column compares pacings at equal, convergence-sufficient "
        "update budgets rather than penalizing slow pacings for a "
        "fixed step count."),
    ("cdf50", "cdf50_long"): (
        "accuracies are a 100-step-budget artifact: this grid measures "
        "barrier timing, not convergence. Convergence proof: "
        "long/cdf50_long (full-barrier at n=50, 400 updates, "
        "test_accuracy 1.0)."),
}


def finalize(results_dir: Path) -> None:
    """Regenerate every group's report.md and figures from its
    sweep_results.jsonl, rebuild the top-level summary from what is on
    disk, and prune checkpoint payloads — idempotent, safe after
    partial or rerun campaigns."""
    summary = {}
    for gdir in sorted(p for p in results_dir.iterdir() if p.is_dir()):
        f = gdir / "sweep_results.jsonl"
        if not f.exists():
            continue
        records = [json.loads(line) for line in f.read_text().splitlines()
                   if line.strip()]
        # a rerun appends to the group's jsonl; reports and the summary
        # reflect each experiment's latest record only
        records = list({r.get("name"): r for r in records}.values())
        write_report(records, gdir)
        summary[gdir.name] = [{k: r.get(k) for k in
                               ("name", "test_accuracy", "examples_per_sec",
                                "updates_applied")} for r in records]
        logger.info("finalized %s (%d experiments)", gdir.name, len(records))
    long_names = {r.get("name") for r in summary.get("long", ())}
    notes = {g: note for (g, proof), note in SUMMARY_NOTES.items()
             if g in summary and proof in long_names}
    (results_dir / "campaign_summary.json").write_text(
        json.dumps({"groups": summary, "notes": notes}, indent=2))
    prune_heavy_artifacts(results_dir)


def campaign_device(requested: str | None) -> str:
    """The one device every run and the evaluator use: ``cuda:0``
    unless ``requested`` names another; CUDA is required unless the CPU
    was asked for."""
    import torch

    device = requested or "cuda:0"
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(
            f"the campaign wants {device!r} but CUDA is not available on "
            "this machine; pass --device cpu to run it on the CPU")
    return device


def main(argv=None, root: Path | None = None) -> int:
    root = root or Path.cwd()
    ap = argparse.ArgumentParser(prog="campaign")
    ap.add_argument("--results", default=str(root / "results_torch"))
    ap.add_argument("--configs", default=str(root / "configs"))
    ap.add_argument("--data-cache", default=str(root / "data_cache_torch"))
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--groups", default=",".join(DEFAULT_GROUPS))
    ap.add_argument("--finalize-only", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of every run and of the evaluator "
                         "(default cuda:0; 'cpu' runs the plain versions "
                         "of the kernels)")
    args = ap.parse_args(argv)
    groups = args.groups.split(",")
    unknown = [g for g in groups if g not in GROUPS]
    if unknown:
        ap.error(f"unknown groups {unknown}; choose from {sorted(GROUPS)}")
    results_dir = Path(args.results)
    results_dir.mkdir(parents=True, exist_ok=True)
    if args.finalize_only:
        finalize(results_dir)
        return 0
    device = campaign_device(args.device)

    from ..data.fixtures import (materialize_cifar10_fixture,
                                 materialize_idx_fixture)
    data_dir = Path(args.data_cache)
    for ds in ("mnist", "fashion_mnist"):
        materialize_idx_fixture(data_dir / ds, ds)
    materialize_cifar10_fixture(data_dir / "cifar10")
    logger.info("idx + cifar10 fixtures ready under %s", data_dir)

    t0 = time.time()
    for group in groups:
        t_group = time.time()
        run_group(group, GROUPS[group], results_dir, Path(args.configs),
                  data_dir, args.quick, device=device)
        logger.info("group %s done in %.1fs", group, time.time() - t_group)
    # rebuild the summary from everything on disk (not just the groups
    # this invocation ran): a partial run merges into the summary
    finalize(results_dir)
    logger.info("campaign complete in %.0fs", time.time() - t0)
    return 0
