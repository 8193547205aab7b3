"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles on its own into a shared library with a plain C
interface, which is loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds, not minutes:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so
         csrc/<name>.cu

Libraries land in the build directory — ``distributedmnist_tpu_torch/
_build/`` (listed in ``.gitignore``), or ``<cache_dir>/kernels`` once
an entry point has enabled the kernel build cache
(:func:`..core.compile_cache.enable_persistent_cache`, which calls
:func:`set_build_dir`) — named by a hash of the source, the shared
headers (``csrc/*.cuh``, which every source may include) and the flags,
so an edited source or header rebuilds and an unchanged one is reused,
by this process or by any later one that shares the directory.
Building happens at first use — importing this module compiles nothing
— and :func:`build` compiles every stale source at once, one ``nvcc``
process per source, all started together; each writes a per-process
temporary name and renames it into place, so processes building the
same library at once leave one whole library. The compiler's output
(``-Xptxas -v``: each kernel's registers, stack and spill bytes) is kept
beside each library as ``.log``; :func:`ptxas_report` reads it and names
each kernel instantiation through the toolkit's ``cu++filt``.

The first time a process needs a library it counts a hit (the library
was there) or a miss (it had to be compiled): :func:`cache_counters`.
A library that exists but does not load (a torn or truncated file:
``ctypes.CDLL`` raises ``OSError``) is deleted, logged and rebuilt once:
cache damage costs one compile, never a crash.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..core.log import get_logger

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
DEFAULT_BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("flash_attention_fwd", "flash_attention_bwd", "paged_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

logger = get_logger("build")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# process-wide, as the loaded libraries are: where they are built, and
# the first-need hit/miss count of each library name
_build_dir = DEFAULT_BUILD_DIR
_counted: set[str] = set()
_counters = {"hits": 0, "misses": 0, "rebuilds": 0}


def build_dir() -> Path:
    """The directory libraries are built into and loaded from."""
    return _build_dir


def set_build_dir(path: str | Path) -> None:
    """Build into and load from ``path`` from now on (libraries this
    process already loaded stay loaded)."""
    global _build_dir
    with _lock:
        _build_dir = Path(path)


def cache_counters() -> dict[str, int]:
    """This process's ``hits`` and ``misses`` (one per library name, at
    its first need) and ``rebuilds`` (damaged libraries compiled
    again)."""
    return dict(_counters)


def _count(name: str, hit: bool) -> None:
    if name not in _counted:
        _counted.add(name)
        _counters["hits" if hit else "misses"] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels cannot be built on this machine")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _build_dir / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: tuple[str, ...] = SOURCES) -> dict[str, float]:
    """Compile every stale library among ``names`` in parallel; returns
    the seconds each compile took (empty when all were up to date).
    Raises ``RuntimeError`` with the compiler's output on a failure."""
    todo = []
    for n in names:
        present = library_path(n).exists()
        _count(n, present)
        if not present:
            todo.append(n)
    if not todo:
        return {}
    out_dir = _build_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.time()
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    took: dict[str, float] = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = round(time.time() - t0, 3)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        for suffix in (".so", ".log"):  # an older build's library and log
            for stale in out_dir.glob(f"lib{name}-*{suffix}"):
                if stale.stem != out.stem:
                    stale.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return took


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if its
    source changed since the last build; a library that fails to load
    is deleted and rebuilt once. Thread-safe; loads once per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build((name,))
            path = library_path(name)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                logger.warning("kernel library %s does not load (%s): "
                               "deleted, rebuilding it", path.name, e)
                path.unlink(missing_ok=True)
                _counters["rebuilds"] += 1
                build((name,))
                lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib


def toolkit_tool(tool: str) -> str:
    """The CUDA toolkit's ``tool`` (``cuobjdump``, ``cu++filt``) from the
    toolkit whose ``nvcc`` builds the kernels."""
    path = Path(_nvcc()).resolve().parent / tool
    if not path.exists():
        raise RuntimeError(f"{tool} not found beside nvcc in {path.parent}")
    return str(path)


def demangle(mangled: list[str]) -> list[str]:
    """Kernel names as ``bwd_dq_kernel<__nv_bfloat16, 128>``: the
    toolkit's ``cu++filt``, without the return type, the namespace, the
    ``(int)`` casts and the parameter list."""
    if not mangled:
        return []
    p = subprocess.run([toolkit_tool("cu++filt"), *mangled],
                       capture_output=True, text=True, timeout=60)
    lines = p.stdout.splitlines()
    if p.returncode != 0 or len(lines) != len(mangled):
        raise RuntimeError(f"cu++filt failed (rc {p.returncode}): "
                           f"{p.stderr.strip()}")
    names = []
    for line in lines:
        s = line.replace("(int)", "").removeprefix("void ").replace(
            "(anonymous namespace)", "<unnamed>")
        start, end, depth = 0, len(s), 0
        for i, ch in enumerate(s):
            depth += (ch == "<") - (ch == ">")
            if depth == 0 and s.startswith("::", i):  # a namespace ends
                start = i + 2
            elif depth == 0 and ch == "(":  # the parameter list begins
                end = i
                break
        names.append(re.sub(r"\s*,\s*", ", ", s[start:end].strip()))
    return names


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")


def ptxas_report(name: str) -> list[dict]:
    """Per kernel instantiation of the built ``csrc/<name>.cu``: its
    registers a thread, stack frame and spill bytes, as ``ptxas -v``
    printed them when the library was built."""
    log = library_path(name).with_suffix(".log")
    rows: list[dict] = []
    for line in log.read_text().splitlines():
        if (m := _ENTRY.search(line)):
            rows.append({"kernel": m.group(1)})
        elif rows and (m := _FRAME.search(line)):
            rows[-1].update(stack_bytes=int(m.group(1)),
                            spill_store_bytes=int(m.group(2)),
                            spill_load_bytes=int(m.group(3)))
        elif rows and (m := _USED.search(line)):
            rows[-1]["registers"] = int(m.group(1))
    for row, kernel in zip(rows, demangle([r["kernel"] for r in rows])):
        row["kernel"] = kernel
    return rows
