"""The continuous checkpoint evaluator (≙ ``distributedmnist_tpu/
evalsvc/evaluator.py``, the source paper's evaluator process,
src/mnist_eval.py and src/nn_eval.py).

Poll the trainer's checkpoint directory, restore each new step once,
evaluate the full test split, print the paper's parseable line
(:func:`..core.log.eval_line`) and journal an ``eval`` record into
``eval_dir/eval_log.jsonl`` plus the ``Validation Accuracy`` /
``Validation Loss`` TensorBoard scalars under ``eval_dir/tb``.

The model and data come from the config saved in the checkpoint itself
(:func:`..train.checkpoint.wait_for_run_config`), so evaluator and
trainer cannot disagree on the model. The follow loop is
:class:`..train.checkpoint.CheckpointFollower`: a torn, corrupt or
garbage-collected newest artifact is skipped and retried, never fatal;
each skip is a ``follow_skip`` recovery record in
``eval_dir/recovery_journal.jsonl``. It evaluates on ``device`` —
``cuda:0`` by default (an error without CUDA), where the transformer's
attention runs the flash forward kernel K1.
"""

from __future__ import annotations

import time
from pathlib import Path

import torch
import torch.distributed as dist

from ..core.config import (EvalConfig, ExperimentConfig, MeshConfig,
                           effective_model_config)
from ..core.device import resolve_device
from ..core.log import JsonlSink, eval_line, get_logger
from ..core.mesh import Topology, make_topology
from ..data.datasets import Datasets, load_datasets
from ..models.convert import list_form, params_from_reference
from ..models.registry import get_model
from ..obsv.tb import SummaryWriter
from ..parallel.api import build_eval_step, build_params, tp_shard
from ..parallel.partition_rules import make_zero1_plan, zero1_logical
from ..train import checkpoint as ckpt
from ..train.evaluation import run_full_eval

logger = get_logger("eval")


class Evaluator:
    """Polls ``train_dir`` and evaluates each new checkpoint once.

    ``single_device`` evaluates as one replica whatever the training
    mesh (the co-located mode beside a live trainer); it refuses what
    the reference refuses there: pipeline-stacked layouts, and an
    expert- or sequence-sharded MoE run without ``model.moe_num_groups``.
    Without it the evaluator builds the training mesh — under
    ``torchrun`` for a mesh that spans processes (``launch eval`` joins
    the group): each process evaluates its shard of the params (model,
    expert and stage shards cut from the checkpoint's whole leaves), the
    processes agree on each step to evaluate (the smallest newest step
    any of them sees), and only rank 0 writes the eval journals. The
    batch size is ``eval_cfg.eval_batch_size`` (0: up to 4096)."""

    def __init__(self, train_dir: str | Path,
                 eval_cfg: EvalConfig | None = None,
                 cfg: ExperimentConfig | None = None,
                 topo: Topology | None = None,
                 datasets: Datasets | None = None,
                 single_device: bool = False,
                 device: str | torch.device | None = None):
        self.train_dir = Path(train_dir)
        self.eval_cfg = eval_cfg or EvalConfig()
        self.device = resolve_device(device)
        if cfg is None:
            cfg = ckpt.wait_for_run_config(self.train_dir)
        self.cfg = cfg
        if topo is not None:
            self.topo = topo
        elif single_device:
            m = cfg.mesh
            if m.pipeline_parallelism > 1:
                raise ValueError(
                    "single_device evaluation cannot restore "
                    "pipeline-stacked parameter layouts; run the "
                    "evaluator without --single_device (it builds the "
                    "training mesh)")
            if (cfg.model.num_experts > 0 and cfg.model.moe_num_groups == 0
                    and (m.expert_parallelism > 1 or m.seq_parallelism > 1)):
                raise ValueError(
                    "single_device evaluation of an expert-/seq-sharded "
                    "MoE run needs an explicit model.moe_num_groups: with "
                    "the mesh-derived auto grouping the 1-device routing "
                    "(groups/capacity) differs from the training mesh and "
                    "metrics would silently diverge; set moe_num_groups "
                    "or run the evaluator without --single_device")
            self.topo = make_topology(MeshConfig(num_replicas=1))
        else:
            self.topo = make_topology(cfg.mesh)
        self.model = get_model(effective_model_config(cfg))
        self.datasets = datasets if datasets is not None else load_datasets(
            cfg.data, cfg.model.image_size, cfg.model.num_channels,
            cfg.model.num_classes, cfg.model.seq_len, cfg.model.vocab_size)
        self.eval_fn = build_eval_step(self.model, cfg, self.topo)
        # the params' logical shapes where a per-host checkpoint holds
        # resident ZeRO-1 params flat and padded (drawn only then: the
        # CNN's threefry init takes seconds even on the meta device)
        self._logical = (make_zero1_plan(build_params(
            self.model, cfg, self.topo, torch.device("meta")), None, 1)
            if cfg.parallel.shard_weight_update
            and cfg.parallel.resident_sharded else None)
        self.follower = ckpt.CheckpointFollower(self.train_dir,
                                                on_event=self._skipped)
        self._sink: JsonlSink | None = None
        self._recovery_sink: JsonlSink | None = None
        self._tb: SummaryWriter | None = None

    @property
    def last_step_evaluated(self) -> int:
        return self.follower.last_step

    def _skipped(self, record: dict) -> None:
        if self._recovery_sink is not None:
            self._recovery_sink.write({"event": "recovery",
                                       "time": time.time(), **record})

    def evaluate_checkpoint(self, step: int | None = None) -> dict | None:
        """Evaluate one checkpoint (default: the newest loadable); None
        when its artifact is unreadable."""
        try:
            return self._read_and_eval(step)
        except (OSError, ValueError, KeyError) as e:
            logger.warning("checkpoint step=%s unreadable (%s); skipping",
                           step, e)
            return None

    def _read_and_eval(self, step: int | None) -> dict | None:
        """Restore and evaluate, raising on an unreadable artifact (the
        ``read`` the follower wraps with skip-and-retry)."""
        restored = ckpt.restore_params(self.train_dir, step)
        if restored is None:
            return None
        saved, _, at_step = restored
        if self._logical is not None:
            saved = zero1_logical(list_form(saved), self._logical)
        params = tp_shard(params_from_reference(saved, device=self.device),
                          self.model, self.topo)
        out = run_full_eval(self.eval_fn, params, self.datasets.test,
                            self.eval_cfg.eval_batch_size,
                            device=self.device, topo=self.topo)
        result = {"event": "eval", "step": at_step, "time": time.time(),
                  "num_examples": out["num_examples"],
                  "precision_at_1": out["accuracy"], "loss": out["loss"],
                  "seconds": out["seconds"]}
        if self.topo.rank == 0:
            print(eval_line(result["num_examples"],
                            result["precision_at_1"], result["loss"],
                            result["seconds"]), flush=True)
        if self._sink is not None:
            self._sink.write(result)
        if self._tb is not None:
            self._tb.add_scalars({"Validation Accuracy": out["accuracy"],
                                  "Validation Loss": out["loss"]},
                                 step=at_step)
            self._tb.flush()
        return result

    def poll_once(self) -> dict | None:
        """One follow tick: evaluate the newest checkpoint if its step
        advanced past the last one evaluated."""
        newest = self.follower.newest_step()
        if self.topo.distributed:
            # every process evaluates the same step: the smallest newest
            # step any of them sees (a process may read the pointer
            # before another's view of it moves)
            seen = torch.tensor([1.0 if newest is None else -newest],
                                dtype=torch.float64)
            self.topo.comm.timed(dist.all_reduce, seen,
                                 op=dist.ReduceOp.MAX,
                                 group=self.topo.host_group)
            newest = None if seen.item() > 0 else int(-seen.item())
        if newest is None:
            logger.info("no checkpoint yet in %s", self.train_dir)
            return None
        return self.follower.poll(self._read_and_eval, step=newest)

    def run(self) -> list[dict]:
        """The poll loop, until ``run_once`` has one result or
        ``max_evals`` are done (0: forever), sleeping
        ``eval_interval_secs`` between polls."""
        ecfg = self.eval_cfg
        eval_dir = Path(ecfg.eval_dir)
        eval_dir.mkdir(parents=True, exist_ok=True)
        writer = self.topo.rank == 0
        if writer:
            self._sink = JsonlSink(eval_dir / "eval_log.jsonl")
            self._recovery_sink = JsonlSink(eval_dir /
                                            "recovery_journal.jsonl")
            self._tb = SummaryWriter(eval_dir / "tb")
        results: list[dict] = []
        try:
            while True:
                out = self.poll_once()
                if out is not None:
                    results.append(out)
                if ecfg.run_once and results:
                    break
                if ecfg.max_evals and len(results) >= ecfg.max_evals:
                    break
                time.sleep(ecfg.eval_interval_secs)
        finally:
            for sink in (self._sink, self._recovery_sink, self._tb):
                if sink is not None:
                    sink.close()
            self._sink = self._recovery_sink = self._tb = None
        return results
