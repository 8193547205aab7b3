"""Experiment report generation (≙ ``distributedmnist_tpu/obsv/
report.py``): figures and stats from a run's structured logs
(``train_log.jsonl``, ``eval_log.jsonl``, the ``time_acc.npy`` /
``step_times.npy`` series) — time-vs-precision, step-vs-loss,
time-vs-loss, time-vs-step and the per-replica step-time CDFs, as the
source paper's ``tools/benchmark.py`` drew them from scraped stdout.

Figures are drawn with matplotlib's Agg backend (headless) and written
as PNG next to ``stats.json``. Plotting is best-effort: where
matplotlib is missing or fails, ``stats.json`` still lands.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np

from ..core.log import get_logger
from .timing import compute_stats

logger = get_logger("report")


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------

def load_jsonl(path: str | Path, event: str | None = None) -> list[dict]:
    """Load a JSONL log, optionally filtering by record ``event`` type.
    Tolerates a torn final line (the writer may still be appending)."""
    out: list[dict] = []
    path = Path(path)
    if not path.exists():
        return out
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue  # torn tail write
        if event is None or rec.get("event") == event:
            out.append(rec)
    return out


def load_experiment(train_dir: str | Path,
                    eval_dir: str | Path | None = None) -> dict[str, Any]:
    """Gather everything one experiment produced.

    Returns {"steps": [...], "evals": [...], "step_times": [S,R] array
    or None, "time_acc": [S,4] array or None}.
    """
    train_dir = Path(train_dir)
    # Rollback splicing (obsv/invariants.py): after a NaN rollback or a
    # restart-resume the append-only log re-emits the replayed span, so
    # the raw series doubles back. Every stat/figure consumer wants the
    # spliced monotone view (identical to raw for a clean run); the raw
    # records stay available under "steps_raw".
    from .invariants import splice_rollbacks
    raw_steps = load_jsonl(train_dir / "train_log.jsonl", "step")
    spliced_steps, rewinds = splice_rollbacks(raw_steps)
    data: dict[str, Any] = {
        "steps": spliced_steps,
        "steps_raw": raw_steps,
        "log_rewinds": rewinds,
        "evals": [],
        "step_times": None,
        "time_acc": None,
        # trainer-side self-healing events (NaN rollbacks, corrupt-
        # checkpoint fallbacks, preemption flushes) — empty for a run
        # that never needed to recover
        "recovery": load_jsonl(train_dir / "recovery_journal.jsonl",
                               "recovery"),
    }
    if eval_dir is not None:
        data["evals"] = load_jsonl(Path(eval_dir) / "eval_log.jsonl", "eval")
    st = train_dir / "step_times.npy"
    if st.exists():
        data["step_times"] = np.load(st)
    ta = train_dir / "time_acc.npy"
    if ta.exists():
        data["time_acc"] = np.load(ta)
    return data


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------

def experiment_stats(data: dict[str, Any]) -> dict[str, Any]:
    """Timing + convergence stats (≙ compute_stdev_and_percentiles and
    friends, tools/benchmark.py:60-144)."""
    out: dict[str, Any] = {}
    steps = data["steps"]
    if steps:
        out["num_steps"] = steps[-1]["step"]
        out["final_loss"] = steps[-1]["loss"]
        out["final_train_acc"] = steps[-1]["train_acc"]
        rates = [s["examples_per_sec"] for s in steps if s.get("examples_per_sec")]
        if rates:
            out["examples_per_sec"] = {"mean": float(np.mean(rates)),
                                       "max": float(np.max(rates))}
    if data.get("log_rewinds"):
        out["log_rewinds"] = data["log_rewinds"]
    if data["evals"]:
        best = max(e["precision_at_1"] for e in data["evals"])
        out["best_precision_at_1"] = best
        out["final_precision_at_1"] = data["evals"][-1]["precision_at_1"]
    if data.get("recovery"):
        from .journal import summarize_recovery_events
        out["recovery"] = summarize_recovery_events(data["recovery"])
    m = data["step_times"]
    if m is not None and m.size:
        out["per_replica"] = [compute_stats(m[:, i]).to_dict()
                              for i in range(m.shape[1])]
        out["barrier"] = compute_stats(m.max(axis=1)).to_dict()
        # per-iteration straggler quantiles (≙ ITERATION TIMES analysis,
        # tools/benchmark.py:86-111): p95/p99/p100 within each step row
        per_iter = np.percentile(m, [95, 99, 100], axis=1)
        out["per_iteration"] = {
            f"p{p}": {"mean": float(v.mean()), "median": float(np.median(v))}
            for p, v in zip((95, 99, 100), per_iter)}
    return out


# ---------------------------------------------------------------------------
# figures
# ---------------------------------------------------------------------------

def _axes(title: str, xlabel: str, ylabel: str):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(7, 4.5))
    ax.set_title(title, fontsize=10)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    return fig, ax


def _save(fig, path: Path) -> Path:
    import matplotlib.pyplot as plt
    fig.tight_layout()
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_experiment(data: dict[str, Any], out_dir: str | Path,
                    name: str = "experiment") -> list[Path]:
    """The reference's four curve figures + the per-replica CDF figure
    for a single experiment (tools/benchmark.py:165-263)."""
    out_dir = Path(out_dir)
    written: list[Path] = []
    steps = data["steps"]
    # logs from older runs may lack the "time" field — time-axis
    # figures degrade away individually, the rest still draw
    timed_steps = [s for s in steps if "time" in s]
    t0 = timed_steps[0]["time"] if timed_steps else None
    if steps:
        xs = np.array([s["step"] for s in steps])
        losses = np.array([s["loss"] for s in steps])
        fig, ax = _axes(f"{name}: loss vs step", "global step", "train loss")
        ax.plot(xs, losses)
        written.append(_save(fig, out_dir / "step_loss.png"))

    if timed_steps:
        ts = np.array([s["time"] - t0 for s in timed_steps])
        xs = np.array([s["step"] for s in timed_steps])
        losses = np.array([s["loss"] for s in timed_steps])

        fig, ax = _axes(f"{name}: loss vs time", "seconds", "train loss")
        ax.plot(ts, losses)
        written.append(_save(fig, out_dir / "time_loss.png"))

        fig, ax = _axes(f"{name}: step vs time", "seconds", "global step")
        ax.plot(ts, xs)
        written.append(_save(fig, out_dir / "time_step.png"))

    timed_evals = [e for e in data["evals"] if "time" in e]
    if timed_evals and t0 is not None:
        ets = np.array([e["time"] - t0 for e in timed_evals])
        prec = np.array([e["precision_at_1"] for e in timed_evals])
        fig, ax = _axes(f"{name}: test precision vs time", "seconds",
                        "precision @ 1")
        ax.plot(ets, prec, marker="o", markersize=3)
        written.append(_save(fig, out_dir / "time_precision.png"))

    m = data["step_times"]
    if m is not None and m.size:
        fig, ax = _axes(f"{name}: per-replica compute-time CDFs",
                        "step time (ms)", "CDF")
        for i in range(m.shape[1]):
            col = np.sort(m[:, i])
            ax.step(col, np.arange(1, col.size + 1) / col.size,
                    where="post", alpha=0.6, linewidth=0.9)
        written.append(_save(fig, out_dir / "replica_time_cdf.png"))
    return written


def plot_sweep(records: list[dict[str, Any]], out_dir: str | Path) -> list[Path]:
    """Cross-experiment comparison figures for a sweep: accuracy and
    throughput against the swept quorum size / interval, plus the
    overlaid per-replica mean CDFs (≙ the multi-cfg overlays,
    tools/benchmark.py:165-224)."""
    out_dir = Path(out_dir)
    written: list[Path] = []
    if not records:
        return written

    def numeric_sweep(key):
        vals = [r.get(key) for r in records]
        return (all(isinstance(v, (int, float)) for v in vals)
                and len(set(vals)) > 1)

    sweep_key = next((k for k in ("aggregate_k", "interval_ms")
                      if numeric_sweep(k)), None)
    if sweep_key:
        order = sorted(records, key=lambda r: r[sweep_key])
        xs = [r[sweep_key] for r in order]
        fig, ax = _axes(f"test accuracy vs {sweep_key}", sweep_key,
                        "test accuracy")
        ax.plot(xs, [r["test_accuracy"] for r in order], marker="o")
        written.append(_save(fig, out_dir / f"acc_vs_{sweep_key}.png"))

        fig, ax = _axes(f"throughput vs {sweep_key}", sweep_key,
                        "examples/sec")
        ax.plot(xs, [r["examples_per_sec"] or 0 for r in order], marker="o")
        written.append(_save(fig, out_dir / f"throughput_vs_{sweep_key}.png"))

    fig, ax = _axes("per-replica mean step time CDFs", "mean step time (ms)",
                    "CDF over replicas")
    drew = False
    for r in records:
        per_replica = r.get("timing", {}).get("per_replica", [])
        if not per_replica:
            continue
        means = sorted(s["mean"] for s in per_replica)
        ax.step(means, np.arange(1, len(means) + 1) / len(means),
                where="post", label=r["name"])
        drew = True
    if drew:
        ax.legend(fontsize=7)
        written.append(_save(fig, out_dir / "step_time_cdf.png"))
    else:
        import matplotlib.pyplot as plt
        plt.close(fig)
    return written


def steps_to_loss(steps: list[dict], threshold: float) -> int | None:
    """First logged step whose train loss falls to ``threshold``. With
    reference-parity dropout the train-acc forward runs at p=0.5, so
    loss is the usable per-step convergence signal."""
    for s in steps:
        if s.get("loss", float("inf")) <= threshold:
            return int(s["step"])
    return None


def modeled_step_durations_ms(steps: list[dict],
                              step_times: np.ndarray | None) -> np.ndarray | None:
    """Per-step MODELED barrier: the slowest CONTRIBUTING replica's
    sampled time — the wall-clock cost the aggregation discipline
    actually pays. Under quorum k-of-n this is the k-th order statistic
    of the per-replica times (backups past it are not waited for,
    arXiv:1604.00981's core effect); under full sync/cdf it is the max.

    This is what the reference's Experiment A measures on real EC2
    stragglers: convergence per STEP is nearly k-invariant (any masked
    mean is an unbiased gradient), so the whole quorum tradeoff lives
    in how long each step takes. Requires the per-step `flags` record
    and the [steps, n] step_times matrix."""
    if step_times is None or not len(step_times):
        return None
    out = []
    for rec in steps:
        i = rec["step"] - 1
        if not (0 <= i < len(step_times)):
            return None  # resumed run: rows don't align with steps
        row = step_times[i]
        flags = rec.get("flags")
        if flags and sum(flags) and len(flags) == len(row):
            out.append(max(t for t, f in zip(row, flags) if f))
        else:
            out.append(float(row.max()))
    return np.asarray(out)


def plot_group_overlays(records: list[dict[str, Any]],
                        results_dir: str | Path,
                        step_series: dict[str, list[dict]] | None = None
                        ) -> list[Path]:
    """Cross-experiment per-step overlays for one sweep group: train
    loss vs step and train accuracy vs step, one curve per experiment
    (≙ the reference's multi-cfg step_loss overlays,
    tools/benchmark.py:165-224). Reads each experiment's
    train_log.jsonl from ``results_dir/<name>/train`` unless the caller
    already loaded the series (``step_series``: name → step records)."""
    results_dir = Path(results_dir)
    series = []
    for r in records:
        steps = (step_series.get(r["name"]) if step_series is not None
                 else load_jsonl(results_dir / r["name"] / "train"
                                 / "train_log.jsonl", "step"))
        if steps:
            series.append((r["name"], steps))
    if not series:
        return []
    written = []
    for key, ylabel, fname in (("loss", "train loss", "group_step_loss.png"),
                               ("train_acc", "train accuracy",
                                "group_step_acc.png")):
        fig, ax = _axes(f"{results_dir.name}: {ylabel} vs step",
                        "global step", ylabel)
        for name, steps in series:
            xs = [s["step"] for s in steps]
            ys = [s[key] for s in steps]
            ax.plot(xs, ys, label=name, linewidth=1.0, alpha=0.85)
        ax.legend(fontsize=7)
        written.append(_save(fig, results_dir / fname))

    # loss vs MODELED wall-clock (cumulative contributor-barrier): the
    # discipline tradeoff the step-axis overlays can't show — under
    # heavy-tailed stragglers small k pays far less time per step at
    # near-identical per-step convergence (≙ the reference's
    # time_loss/time_precision figures, tools/benchmark.py:165-224)
    fig, ax = _axes(f"{results_dir.name}: train loss vs modeled wall-clock",
                    "modeled seconds (cumulative contributor barrier)",
                    "train loss")
    drew = False
    for name, steps in series:
        st = results_dir / name / "train" / "step_times.npy"
        durations = modeled_step_durations_ms(
            steps, np.load(st) if st.exists() else None)
        if durations is None:
            continue
        ax.plot(np.cumsum(durations) / 1e3, [s["loss"] for s in steps],
                label=name, linewidth=1.0, alpha=0.85)
        drew = True
    if drew:
        ax.legend(fontsize=7)
        written.append(_save(fig, results_dir / "group_modeled_time_loss.png"))
    else:
        import matplotlib.pyplot as plt
        plt.close(fig)
    return written


def generate_report(train_dir: str | Path, eval_dir: str | Path | None,
                    out_dir: str | Path, name: str = "experiment") -> dict:
    """One-stop: load logs → stats.json + figures. Returns the stats."""
    data = load_experiment(train_dir, eval_dir)
    stats = experiment_stats(data)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "stats.json").write_text(json.dumps(stats, indent=2))
    try:
        figs = plot_experiment(data, out_dir, name)
        logger.info("report: %d figures → %s", len(figs), out_dir)
    except Exception as e:  # plotting is best-effort, stats always land
        logger.warning("figure generation skipped: %s", e)
    return stats
