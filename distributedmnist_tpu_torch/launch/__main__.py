"""The port's CLI (≙ ``distributedmnist_tpu/launch/__main__.py``), the
``train``, ``eval`` and ``serve --decode`` verbs:

  python -m distributedmnist_tpu_torch.launch train --config C.json \\
      [section.key=value ...] [--device cpu]
  torchrun --nproc-per-node P -m distributedmnist_tpu_torch.launch train \\
      --config C.json mesh.num_replicas=N ... [--dist-backend nccl|gloo]
  python -m distributedmnist_tpu_torch.launch eval --train_dir D \\
      [--eval_dir E] [--single_device] [--max_evals N] [--device cpu]
  python -m distributedmnist_tpu_torch.launch serve --decode \\
      --train-dir D --serve-dir S [--device cpu] [decode/serve flags]

``train`` builds the :class:`~..train.loop.Trainer` from the config and
its dotted overrides, runs it, evaluates the test split and prints the
reference's last line ``{"summary": ..., "test": ...}`` (a SIGTERM/
SIGINT mid-run flushes a checkpoint, prints the summary alone and exits
with ``train.resumable_exit_code``). Under ``torchrun`` (``WORLD_SIZE``
set) it first joins the process group
(:func:`~..core.mesh.initialize_distributed`): the replicas split
evenly over the processes, one device each (``cuda:$LOCAL_RANK``, or
``--device``), ``--dist-backend`` ``nccl`` on the card and ``gloo`` on
the CPU by default; every rank prints the last line, and the group is
torn down on every exit. ``eval`` runs the continuous evaluator
(:class:`~..evalsvc.evaluator.Evaluator`) on ``D``: each new checkpoint
once, the source paper's ``Num examples: ... Precision @ 1: ...`` line
for each. ``serve --decode``
boots a :class:`~..servesvc.decode.DecodeReplica` on the newest
loadable checkpoint in ``D`` (adopting the run config saved in it),
serves until SIGTERM/SIGINT, and drains. The flag names are the
reference CLI's. The device is ``cuda:0`` unless ``--device`` names
another; without CUDA the default is an error, not a CPU run.
Classification serving (``serve`` without ``--decode``) and the other
verbs are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

_SERVE_FLAGS = ("host", "port", "queue_depth", "default_deadline_ms",
                "compute_dtype")
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
        "serve", help="decode replica: serve a published causal-LM "
                      "checkpoint as streaming generations over a local "
                      "socket (continuous batching, paged KV cache)")
    pv.add_argument("--train-dir", "--train_dir", dest="train_dir",
                    required=True, help="the publish dir to serve from")
    pv.add_argument("--serve-dir", dest="serve_dir", default=".",
                    help="where serve.json / serve_log.jsonl / "
                         "heartbeats land")
    pv.add_argument("--device", default=None,
                    help="torch device (default cuda:0; 'cpu' runs the "
                         "plain versions of the kernels)")
    pv.add_argument("--decode", action="store_true",
                    help="serve autoregressive decode (the only serving "
                         "workload ported so far)")
    pv.add_argument("--host", default=None)
    pv.add_argument("--port", type=int, default=None,
                    help="0 = ephemeral (the bound port is published in "
                         "serve.json)")
    pv.add_argument("--queue-depth", type=int, default=None,
                    dest="queue_depth",
                    help="admission bound; a full queue sheds with a "
                         "typed reject")
    pv.add_argument("--default-deadline-ms", type=float, default=None,
                    dest="default_deadline_ms")
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
                    help="pin | restart (decode.swap_policy; validated — "
                         "this replica serves its boot checkpoint)")
    pv.add_argument("--attention-kernel", default=None,
                    dest="attention_kernel",
                    help="dense | paged — decode attention "
                         "(decode.attention_kernel); paged runs the "
                         "paged-attention kernel")
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


def train(argv: list[str]) -> None:
    """``launch train``: join the process group ``torchrun`` describes
    (if any), run, evaluate, print the summary line; leave the group on
    every exit."""
    from ..core.mesh import initialize_distributed, shutdown_distributed

    args = build_parser().parse_args(argv)
    initialize_distributed(args.dist_backend, args.device)
    try:
        trainer = build_trainer(argv)
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


def build_decode_replica(argv: list[str]):
    """Parse ``serve`` arguments and construct (not start) the replica —
    the same object ``serve`` runs, for callers that drive it in
    process."""
    args = build_parser().parse_args(argv)
    if args.cmd != "serve" or not args.decode:
        raise SystemExit("only `serve --decode` is ported so far "
                         "(classification serving is not)")
    from ..servesvc.decode import DecodeReplica
    from ..servesvc.server import wait_for_run_config

    cfg = wait_for_run_config(args.train_dir)
    scfg = dataclasses.replace(
        cfg.serve, **{k: getattr(args, k) for k in _SERVE_FLAGS
                      if getattr(args, k) is not None})
    dcfg = dataclasses.replace(
        cfg.decode, **{k: getattr(args, k) for k in _DECODE_FLAGS
                       if getattr(args, k) is not None})
    cfg = cfg.replace(serve=scfg, decode=dcfg)
    return DecodeReplica(args.train_dir, serve_dir=args.serve_dir,
                         scfg=scfg, dcfg=dcfg, cfg=cfg, device=args.device)


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "train":
        train(argv)
        return
    if argv and argv[0] == "eval":
        from ..evalsvc.__main__ import evaluator_from_args
        evaluator_from_args(build_parser().parse_args(argv)).run()
        return
    build_decode_replica(argv).serve_forever()


if __name__ == "__main__":
    main()
