"""The kernel build cache (≙ ``distributedmnist_tpu/core/compile_cache.py``).

The reference keeps JAX's persistent compilation cache: a restarted
worker reuses its predecessor's XLA compiles instead of paying them on
its boot path. The port has no XLA compile. What a fresh process pays
instead is the ``nvcc`` build of its kernel libraries
(:mod:`..ops._build`), so the build directory plays the part of the
persistent cache: with a cache directory the libraries are built into
and loaded from ``<dir>/kernels``, shared by every process pointed at
it, and a warm process compiles nothing.

* :func:`resolve_cache_dir` — the reference's precedence:
  ``compile.cache_dir``, then ``DMT_COMPILE_CACHE_DIR``, then none; none
  when ``compile.persistent_cache`` is false.
* :func:`enable_persistent_cache` — point the build directory at
  ``<dir>/kernels``. Only the entry points call it (``launch train``,
  ``eval``, ``serve``), as the reference's ``launch/__main__.py`` does.
  With no directory the libraries stay in the package's ``_build/``:
  unlike the reference, where no directory means a cold compile in
  every process, the port's default directory already persists across
  processes of one checkout.
* :func:`cache_stats` — the reference's keys: ``dir``, ``entries`` and
  ``bytes`` (the ``lib*.so`` files in the directory) and this process's
  ``hits`` and ``misses`` (:func:`..ops._build.cache_counters`).

A CUDA graph cannot be serialized, so there is no executable disk cache
to go with it (``parallel/graphs.py``): the build cache is the whole of
the port's warm path, as the reference's persistent cache is where its
executable serialization is unsupported.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

from ..ops import _build
from .config import CompileConfig
from .log import get_logger

logger = get_logger("compile_cache")

#: the environment variable a launcher sets to share one cache directory
CACHE_DIR_ENV = "DMT_COMPILE_CACHE_DIR"

_enabled_dir: Path | None = None


def resolve_cache_dir(cfg: CompileConfig | None = None) -> Path | None:
    """The cache dir a config resolves to: ``cfg.cache_dir`` when set,
    else ``DMT_COMPILE_CACHE_DIR``, else None (no cache directory)."""
    cfg = cfg or CompileConfig()
    if not cfg.persistent_cache:
        return None
    raw = cfg.cache_dir or os.environ.get(CACHE_DIR_ENV, "")
    return Path(raw) if raw else None


def cross_process_reuse_quarantined() -> str | None:
    """Always None. The reference quarantines cross-process reuse on
    JAX releases that deserialize another process's executables wrong;
    a kernel library is a plain shared object that the dynamic loader
    maps the same way in every process, so no process's build is unsafe
    to load in another."""
    return None


def kernels_dir(cache_dir: Path) -> Path:
    """Where the kernel libraries of ``cache_dir`` live."""
    return Path(cache_dir) / "kernels"


def enable_persistent_cache(cfg: CompileConfig | None = None) -> Path | None:
    """Build and load the kernel libraries in ``<dir>/kernels`` for the
    dir ``cfg`` resolves to; returns that dir (None: no directory, the
    libraries stay in the package's ``_build/``). The two size and time
    floors of JAX's cache are logged as no-ops: every kernel library is
    kept whatever its size or build time."""
    global _enabled_dir
    cfg = cfg or CompileConfig()
    for knob in ("min_entry_size_bytes", "min_compile_time_secs"):
        if getattr(cfg, knob):
            logger.info("compile.%s is a no-op in the port: every kernel "
                        "library is kept whatever its size or build time",
                        knob)
    cache_dir = resolve_cache_dir(cfg)
    if cache_dir is None:
        return None
    try:
        kernels_dir(cache_dir).mkdir(parents=True, exist_ok=True)
    except OSError as e:
        logger.warning("kernel build cache unavailable (%s): the kernels "
                       "build in %s", e, _build.build_dir())
        return None
    _build.set_build_dir(kernels_dir(cache_dir))
    if _enabled_dir != cache_dir:
        logger.info("kernel build cache: %s", kernels_dir(cache_dir))
        _enabled_dir = cache_dir
    return cache_dir


def cache_stats(cache_dir: str | Path | None = None) -> dict[str, Any]:
    """``entries``/``bytes`` of the kernel libraries under ``cache_dir``
    (default: the dir last enabled in this process; none without one)
    plus this process's hit and miss counts."""
    d = Path(cache_dir) if cache_dir is not None else _enabled_dir
    entries = size = 0
    if d is not None and kernels_dir(d).is_dir():
        for p in kernels_dir(d).glob("lib*.so"):
            try:
                size += p.stat().st_size
                entries += 1
            except OSError:
                continue
    counts = _build.cache_counters()
    return {"dir": str(d) if d is not None else None,
            "entries": entries, "bytes": size,
            "hits": counts["hits"], "misses": counts["misses"]}
