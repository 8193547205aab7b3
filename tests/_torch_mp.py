"""The launcher of the port's model-parallel parity tests: one group of
gloo worker processes on the CPU (``torchrun``'s environment, a free
port on localhost) runs a list of cases from a cases module
(``_torch_tp_cases`` unless named) and hands each rank's results back.
The children import the port only; the reference side runs in the
pytest process.
"""

import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
TESTS = Path(__file__).resolve().parent

_CHILD = r"""
import os, pickle, sys, traceback
sys.path.insert(0, os.environ["DMT_TESTS"])
import torch
torch.set_num_threads(1)
from distributedmnist_tpu_torch.core.mesh import (initialize_distributed,
                                                  shutdown_distributed)
assert initialize_distributed("gloo", "cpu", timeout_s=120)
import importlib
cases = importlib.import_module(os.environ["DMT_CASES"])
rank = int(os.environ["RANK"])
out = {}
try:
    with open(os.environ["DMT_IN"], "rb") as f:
        jobs = pickle.load(f)
    for name, payload in jobs:
        out[name] = getattr(cases, payload["case"])(payload)
finally:
    with open(f"{os.environ['DMT_OUT']}/out{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    shutdown_distributed()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(tmp: Path, world: int, jobs: list, timeout_s: float = 240.0,
              argv: list | None = None,
              cases: str = "_torch_tp_cases") -> list:
    """Run ``jobs`` (``[(name, payload)]``, each payload naming its
    ``case``, a function of the module ``cases``) in ``world`` gloo
    processes, or ``python argv`` in each when given; every process
    must exit 0 within ``timeout_s`` (a failed sibling is killed).
    Returns each rank's ``{name: result}`` (its log text with
    ``argv``)."""
    tmp.mkdir(parents=True, exist_ok=True)
    with open(tmp / "jobs.pkl", "wb") as f:
        pickle.dump(jobs, f)
    port, procs = _free_port(), []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1", DMT_TESTS=str(TESTS),
                   DMT_CASES=cases,
                   DMT_IN=str(tmp / "jobs.pkl"), DMT_OUT=str(tmp))
        with open(tmp / f"rank{rank}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, *(argv or ["-c", _CHILD])], env=env,
                cwd=REPO, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
    errs = [f"rank {r} rc {p.returncode}:\n"
            f"{(tmp / f'rank{r}.log').read_text()[-4000:]}"
            for r, p in enumerate(procs) if p.returncode != 0]
    assert not errs, "\n".join(errs)
    if argv:
        return [(tmp / f"rank{r}.log").read_text() for r in range(world)]
    out = []
    for r in range(world):
        with open(tmp / f"out{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out
