"""Experiment sweep runner and report generation (≙
``distributedmnist_tpu/launch/sweep.py``, the source paper's benchmark
harness ``tools/benchmark.py``): an experiment is an
``ExperimentConfig`` run in process on the port's Trainer; a sweep is a
directory of config files, one experiment each, its records appended
to ``sweep_results.jsonl`` and tabulated in ``report.md`` with the
figures beside it (best-effort).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Iterable

from ..core.config import ExperimentConfig
from ..core.log import JsonlSink, get_logger

logger = get_logger("sweep")


def run_experiment(cfg: ExperimentConfig, results_dir: str | Path,
                   datasets=None, fresh: bool = True,
                   device=None) -> dict[str, Any]:
    """Run one experiment to max_steps on ``device`` (the Trainer's
    default: ``cuda:0``); return (and persist) a result record: final
    metrics, eval accuracy, step-time CDF stats.

    ``fresh`` (default): force ``train.resume=False`` so a leftover
    checkpoint in the run dir (an aborted attempt, or a re-run with a
    raised step budget) can't splice the record — a silent resume
    reports ``steps`` = final step while ``wall_seconds`` and the
    timing arrays cover only the post-resume tail. Pass
    ``fresh=False`` only for a deliberately resumable long run.
    """
    from ..train.loop import Trainer

    results_dir = Path(results_dir) / cfg.name
    results_dir.mkdir(parents=True, exist_ok=True)
    cfg = cfg.override({"train.train_dir": str(results_dir / "train")})
    if fresh:
        cfg = cfg.override({"train.resume": False})
    cfg.save(results_dir / "config.json")

    t0 = time.time()
    trainer = Trainer(cfg, datasets=datasets, device=device)
    summary = trainer.run()
    wall = time.time() - t0
    final_eval = trainer.evaluate("test")

    record = {
        "name": cfg.name,
        "mode": cfg.sync.mode,
        "num_replicas": trainer.topo.num_replicas,
        "aggregate_k": cfg.sync.num_replicas_to_aggregate,
        "interval_ms": cfg.sync.interval_ms,
        "straggler_profile": cfg.sync.straggler_profile,
        "steps": summary["final_step"],
        "updates_applied": summary["updates_applied"],
        "wall_seconds": wall,
        "examples_per_sec": summary["last_metrics"].get("examples_per_sec"),
        "final_loss": summary["last_metrics"].get("loss"),
        "final_train_acc": summary["last_metrics"].get("train_acc"),
        "test_accuracy": final_eval["accuracy"],
        "test_loss": final_eval["loss"],
        "timing": summary["timing"],
    }
    (results_dir / "result.json").write_text(json.dumps(record, indent=2))
    try:
        from ..obsv.report import generate_report
        generate_report(results_dir / "train", None, results_dir / "figures",
                        name=cfg.name)
    except Exception as e:  # reporting is best-effort, never fails a sweep
        logger.warning("per-experiment report skipped: %s", e)
    logger.info("experiment %s: test_acc=%.4f, %.1f ex/s, p99 barrier=%.3fms",
                cfg.name, record["test_accuracy"],
                record["examples_per_sec"] or -1,
                record["timing"]["barrier"].get("p99", float("nan")))
    return record


def load_sweep_configs(path: str | Path) -> list[ExperimentConfig]:
    """Load every config file in a sweep directory (sorted), or a
    single file."""
    path = Path(path)
    files = ([path] if path.is_file() else
             sorted(p for p in path.iterdir()
                    if p.suffix in (".json", ".cfg", ".py") and p.is_file()))
    cfgs = [ExperimentConfig.from_file(f) for f in files]
    names = [c.name for c in cfgs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate experiment names in sweep: {names}")
    return cfgs


def run_sweep(configs: Iterable[ExperimentConfig], results_dir: str | Path,
              datasets=None, device=None) -> list[dict[str, Any]]:
    """Each config's experiment in turn, its record appended to
    ``sweep_results.jsonl``; then :func:`write_report`."""
    results_dir = Path(results_dir)
    results_dir.mkdir(parents=True, exist_ok=True)
    records = []
    with JsonlSink(results_dir / "sweep_results.jsonl") as sink:
        for cfg in configs:
            rec = run_experiment(cfg, results_dir, datasets=datasets,
                                 device=device)
            sink.write(rec)
            records.append(rec)
    write_report(records, results_dir)
    return records


def write_report(records: list[dict[str, Any]], results_dir: str | Path,
                 loss_threshold: float = 1.5) -> Path:
    """Markdown summary table + optional CDF/convergence plots.

    Two convergence-speed views per experiment: steps to reach
    ``loss_threshold`` (per-step quality — nearly discipline-invariant,
    since any masked mean is an unbiased gradient) and MODELED time to
    reach it (cumulative slowest-contributor barrier — where quorum
    k<n wins by not waiting for straggling backups)."""
    import numpy as np

    from ..obsv.report import (load_jsonl, modeled_step_durations_ms,
                               steps_to_loss)

    results_dir = Path(results_dir)
    lines = [
        "# Sweep report", "",
        f"| name | mode | k | steps | updates | test acc | "
        f"steps→loss≤{loss_threshold:g} | modeled s→loss≤{loss_threshold:g} "
        f"| modeled barrier p50/p99 (ms) | ex/s | full-barrier p99 (ms) |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    step_series = {
        r["name"]: load_jsonl(
            results_dir / r["name"] / "train" / "train_log.jsonl", "step")
        for r in records}
    for r in records:
        b = r["timing"]["barrier"]
        steps = step_series[r["name"]]
        to_loss = steps_to_loss(steps, loss_threshold)
        st_path = results_dir / r["name"] / "train" / "step_times.npy"
        durations = modeled_step_durations_ms(
            steps, np.load(st_path) if st_path.exists() else None)
        if durations is not None and len(durations):
            modeled_sec = (float(np.cumsum(durations)[to_loss - 1]) / 1e3
                           if to_loss is not None else None)
            d50, d99 = np.percentile(durations, [50, 99])
            modeled_col = (f"{modeled_sec:.1f}" if modeled_sec is not None
                           else "—")
            pct_col = f"{d50:.0f} / {d99:.0f}"
        else:
            modeled_col, pct_col = "—", "—"
        lines.append(
            f"| {r['name']} | {r['mode']} | {r['aggregate_k']} | {r['steps']} "
            f"| {r['updates_applied']} | {r['test_accuracy']:.4f} "
            f"| {to_loss if to_loss is not None else '—'} "
            f"| {modeled_col} | {pct_col} "
            f"| {r['examples_per_sec'] or 0:.0f} "
            f"| {b.get('p99', 0):.3f} |")
    report = results_dir / "report.md"
    report.write_text("\n".join(lines) + "\n")
    try:
        from ..obsv.report import plot_group_overlays, plot_sweep
        plot_sweep(records, results_dir)
        plot_group_overlays(records, results_dir, step_series=step_series)
    except Exception as e:  # plotting is best-effort, never fails a sweep
        logger.warning("plotting skipped: %s", e)
    return report
