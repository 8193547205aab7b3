"""Import hygiene of the port: importing every module of
``distributedmnist_tpu_torch`` (and ``chip_smoke.py``) loads no ``jax``,
no ``flax`` and nothing of ``distributedmnist_tpu`` — checked in a fresh
interpreter, through ``sys.modules`` — and no source names them (or
``ml_dtypes``, which the chip machine lacks) in an import statement. ``chip_smoke.py`` refuses to run without CUDA and
without the rest of the repository."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "distributedmnist_tpu_torch"
FORBIDDEN = ("jax", "flax", "ml_dtypes", "distributedmnist_tpu")

_PROBE = """
import importlib, pkgutil, runpy, sys
import distributedmnist_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
runpy.run_path("chip_smoke.py", run_name="chip_smoke")
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "ml_dtypes",
                                    "distributedmnist_tpu"))
print("LOADED", len([k for k in sys.modules
                     if k.startswith("distributedmnist_tpu_torch")]))
print("BAD", bad)
print("HAVE", sorted(k for k in sys.modules
                     if k.startswith("distributedmnist_tpu_torch.")))
"""

# the training path's modules (the walk above imports every module; these
# are named so that a module dropped from the package fails loudly)
TRAIN_PATH = ("data.datasets", "data.pipeline", "parallel.api",
              "train.optim", "train.lr_schedule", "train.evaluation",
              "train.loop", "train.checkpoint", "ops.flash_attention",
              "models.convert", "launch.__main__",
              # the CNN sync-SGD path over N replicas
              "core.prng", "core.mesh", "models.cnn", "models.registry",
              "ops.masked_psum", "ops.drop_connect", "parallel.policies",
              # the process-group path, the step-time collector and the
              # adaptive discipline controller
              "obsv.timing", "train.discipline",
              # durable checkpoints, TensorBoard scalars and the
              # continuous evaluator
              "train.storage", "obsv.tb", "evalsvc", "evalsvc.evaluator",
              "evalsvc.__main__",
              # the serving tier: classification, hot-follow and swaps,
              # the quantized tiers, the client and the load generator
              "quant", "quant.ptq", "servesvc.server", "servesvc.decode",
              "servesvc.client", "servesvc.loadgen",
              # the rest of the data-parallel step: the CIFAR-10 fixture,
              # ResNet-20 and the ZeRO-1 plan
              "data.fixtures", "models.resnet", "parallel.partition_rules",
              # the port's own observability and the sweep runner
              "obsv.schema", "obsv.journal", "obsv.invariants",
              "obsv.report", "launch.sweep",
              # the local process cluster, its supervisor and the chaos
              # campaign, with the network chaos proxies of its serving
              # trial
              "launch.exec", "launch.cluster", "launch.supervisor",
              "launch.chaos", "launch.netchaos",
              # the resource broker
              "launch.broker",
              # the flagship campaign
              "launch.campaign",
              # the port's static checks
              "analysis", "analysis.core", "analysis.__main__",
              "analysis.schema_check", "analysis.config_check",
              "analysis.threads_check", "analysis.durability_check",
              "analysis.net_check", "analysis.paged_check",
              "analysis.torch_check",
              # tensor, sequence and expert parallelism
              "ops.collectives", "ops.moe", "ops.ring_attention",
              "ops.ulysses_attention")


def test_port_modules_load_no_jax():
    p = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.splitlines()
    assert "BAD []" in lines, p.stdout
    assert int(lines[0].split()[1]) >= 20
    have = next(line for line in lines if line.startswith("HAVE"))
    for m in TRAIN_PATH:
        assert f"'distributedmnist_tpu_torch.{m}'" in have, m


def test_no_import_statement_names_the_reference():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, f"{f}: {n}"


def test_chip_smoke_refuses_without_cuda_or_repo(tmp_path):
    """Without a GPU, or in a directory holding only the script (no
    port to drive): nonzero exit, no result line."""
    import torch
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone)
    dirs = [alone] if torch.cuda.is_available() else [REPO, alone]
    for cwd in dirs:
        p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                           capture_output=True, text=True, timeout=300)
        assert p.returncode != 0, (cwd, p.stdout[-2000:])
        assert '"ok": true' not in p.stdout
