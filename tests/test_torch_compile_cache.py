"""The port's kernel build cache (``distributedmnist_tpu_torch/core/
compile_cache.py`` over ``ops/_build.py``) against the reference's
``core/compile_cache.py``, on the CPU.

* ``resolve_cache_dir`` gives the reference's answer over every
  combination of ``compile.cache_dir``, ``DMT_COMPILE_CACHE_DIR`` and
  ``compile.persistent_cache``; ``cache_stats`` has the reference's keys.
* With a stand-in ``nvcc`` first on ``PATH`` (a script that compiles a
  tiny C file with ``cc -shared -fPIC`` into the ``-o`` path it is
  given), ``_build`` runs here without CUDA, each case in fresh
  processes sharing one cache directory: the first process misses all
  three libraries and builds them into ``<dir>/kernels``, a second one
  hits all three and builds nothing; a truncated library is deleted,
  logged and rebuilt once, and then loads; two processes building the
  same cold directory at once leave one whole, loadable library a
  source and no temporary file.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from distributedmnist_tpu.core import compile_cache as ref_cc
from distributedmnist_tpu.core.config import CompileConfig as RefCompileConfig
from distributedmnist_tpu_torch.core import compile_cache as cc
from distributedmnist_tpu_torch.core.config import CompileConfig
from distributedmnist_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent

FAKE_NVCC = """#!/bin/sh
# stands in for nvcc: compiles a tiny C library into the -o path
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  shift
done
sleep "${FAKE_NVCC_SLEEP:-0}"
printf 'int dmt_fake(void) { return 7; }\\n' > "$out.c"
cc -shared -fPIC -o "$out" "$out.c"
rc=$?
rm -f "$out.c"
exit $rc
"""

# each child: switch the cache on from the environment, load every
# library, call one, print the stats and the build counters
CHILD = textwrap.dedent("""
    import json, logging, sys
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    from distributedmnist_tpu_torch.core import compile_cache as cc
    from distributedmnist_tpu_torch.ops import _build
    assert cc.enable_persistent_cache() is not None
    libs = [_build.load_library(n) for n in _build.SOURCES]
    assert all(lib.dmt_fake() == 7 for lib in libs)
    print(json.dumps({"stats": cc.cache_stats(),
                      "counters": _build.cache_counters()}))
""")


@pytest.mark.parametrize("persistent", [True, False])
@pytest.mark.parametrize("env", [None, "env"])
@pytest.mark.parametrize("cfg_dir", ["", "cfg"])
def test_resolve_cache_dir_matches_reference(monkeypatch, tmp_path, cfg_dir,
                                             env, persistent):
    if env is None:
        monkeypatch.delenv(cc.CACHE_DIR_ENV, raising=False)
    else:
        monkeypatch.setenv(cc.CACHE_DIR_ENV, str(tmp_path / env))
    kw = {"persistent_cache": persistent,
          "cache_dir": str(tmp_path / cfg_dir) if cfg_dir else ""}
    assert cc.CACHE_DIR_ENV == ref_cc.CACHE_DIR_ENV
    got = cc.resolve_cache_dir(CompileConfig(**kw))
    assert got == ref_cc.resolve_cache_dir(RefCompileConfig(**kw))
    want = (None if not persistent else tmp_path / cfg_dir if cfg_dir
            else tmp_path / env if env else None)
    assert got == want


def test_cache_stats_has_the_reference_keys(tmp_path):
    assert set(cc.cache_stats(tmp_path)) == set(ref_cc.cache_stats(tmp_path))
    assert cc.cache_stats(tmp_path)["entries"] == 0
    assert cc.cross_process_reuse_quarantined() is None


@pytest.fixture
def fake_nvcc(tmp_path):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    env = dict(os.environ, PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}",
               DMT_COMPILE_CACHE_DIR=str(tmp_path / "cache"),
               PYTHONPATH=str(REPO))
    return env, tmp_path / "cache"


def _child(env, extra=None) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", CHILD], cwd=REPO,
                            env=dict(env, **(extra or {})),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _result(proc) -> tuple[dict, str]:
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err
    return json.loads(out.strip().splitlines()[-1]), err


def test_cold_then_warm_across_processes(fake_nvcc):
    env, cache = fake_nvcc
    cold, _ = _result(_child(env))
    n = len(_build.SOURCES)
    assert cold["stats"]["dir"] == str(cache)
    assert (cold["counters"]["misses"], cold["counters"]["hits"]) == (n, 0)
    assert cold["stats"]["entries"] == n and cold["stats"]["bytes"] > 0
    assert len(list((cache / "kernels").glob("lib*.so"))) == n
    warm, _ = _result(_child(env))
    assert (warm["counters"]["misses"], warm["counters"]["hits"]) == (0, n)
    assert warm["stats"]["entries"] == n
    assert warm["counters"]["rebuilds"] == 0


def test_truncated_library_heals_with_one_rebuild(fake_nvcc):
    env, cache = fake_nvcc
    _result(_child(env))
    lib = sorted((cache / "kernels").glob("libpaged_attention-*.so"))[0]
    lib.write_bytes(lib.read_bytes()[:64])  # a torn write
    healed, err = _result(_child(env))
    assert healed["counters"]["rebuilds"] == 1
    assert "does not load" in err and lib.name in err
    assert healed["stats"]["entries"] == len(_build.SOURCES)
    again, _ = _result(_child(env))
    assert again["counters"]["rebuilds"] == 0
    assert again["counters"]["misses"] == 0


def test_concurrent_cold_builds_leave_one_library(fake_nvcc):
    env, cache = fake_nvcc
    procs = [_child(env, {"FAKE_NVCC_SLEEP": "1"}) for _ in range(2)]
    for p in procs:
        got, _ = _result(p)
        assert got["stats"]["entries"] == len(_build.SOURCES)
    kernels = cache / "kernels"
    for name in _build.SOURCES:
        assert len(list(kernels.glob(f"lib{name}-*.so"))) == 1
    assert not list(kernels.glob("*.tmp"))
    warm, _ = _result(_child(env))
    assert warm["counters"]["misses"] == 0
