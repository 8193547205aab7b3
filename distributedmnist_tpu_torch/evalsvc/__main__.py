"""``python -m distributedmnist_tpu_torch.evalsvc --train_dir D
[--eval_dir E] [--device cpu] ...``: the continuous evaluator (≙
``distributedmnist_tpu/evalsvc/__main__.py``, the source paper's
evaluator binary src/mnist_eval.py)."""

from __future__ import annotations

import argparse
import os
import tempfile

from ..core.config import EvalConfig
from .evaluator import Evaluator


def add_eval_arguments(p: argparse.ArgumentParser) -> None:
    """The evaluator's flags, shared with ``launch eval``."""
    p.add_argument("--train_dir", "--train-dir", dest="train_dir",
                   required=True)
    p.add_argument("--eval_dir", default=None,
                   help="where eval_log.jsonl and tb/ land (default "
                        "$TMPDIR/dmt_eval)")
    p.add_argument("--eval_interval_secs", type=float, default=1.0)
    p.add_argument("--eval_batch_size", type=int, default=0)
    p.add_argument("--run_once", action="store_true")
    p.add_argument("--max_evals", type=int, default=0)
    p.add_argument("--single_device", action="store_true",
                   help="evaluate as one replica whatever the training "
                        "mesh (the co-located mode beside a trainer)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda:0; 'cpu' runs the "
                        "plain versions of the kernels)")


def evaluator_from_args(args: argparse.Namespace) -> Evaluator:
    eval_dir = args.eval_dir or os.path.join(tempfile.gettempdir(),
                                             "dmt_eval")
    ecfg = EvalConfig(eval_interval_secs=args.eval_interval_secs,
                      eval_dir=eval_dir,
                      eval_batch_size=args.eval_batch_size,
                      run_once=args.run_once, max_evals=args.max_evals)
    return Evaluator(args.train_dir, ecfg, single_device=args.single_device,
                     device=args.device)


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(prog="distributedmnist_tpu_torch.evalsvc",
                                description="continuous checkpoint "
                                            "evaluator")
    add_eval_arguments(p)
    evaluator_from_args(p.parse_args(argv)).run()


if __name__ == "__main__":
    main()
