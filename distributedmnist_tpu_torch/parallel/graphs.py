"""Capture of a step's device body as CUDA graphs (≙ ``distributedmnist_tpu/
parallel/aot.py``).

The reference compiles its train step ahead of time
(``jit(step).lower(args).compile()``) before the first batch, so compile
time is journaled on its own and every step runs one executable. The
port's counterpart is a CUDA graph: :func:`aot_compile` records the
kernels a body launches, the hand-written ones included (their ``ctypes``
launches go to the current stream, which during a capture is the
capture stream), and every later step replays them with one launch.

A graph replays the addresses it recorded: a body captured here must
read every per-step value from a static buffer (the train step's batch
and input buffers, ``parallel/api.py``; the decode step's token,
position, length and block-table buffers, ``servesvc/decode.py``), and
the tensors it updates must stay the same tensors for as long as the
graph lives.

Not ported: the reference's ``ExecutableCache`` (the compiled executable
serialized into ``<cache_dir>/aot``). A CUDA graph cannot be serialized,
so every process captures its own; the warm path across processes is the
kernel build cache (``core/compile_cache.py``), as the reference's
persistent cache is where its platform refuses executable serialization
(``SERIALIZATION_UNSUPPORTED``).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable

import torch

from ..core.compile_cache import cache_stats

#: the ``source`` of a captured body and of one that runs eagerly
CUDA_GRAPH = "cuda_graph"
EAGER = "eager"


class GraphReplay:
    """Named stages, each replayed from its CUDA graph: ``replay(name)``
    launches the graph on the current stream and returns the stage's
    static outputs (overwritten by the next replay)."""

    def __init__(self, graphs: dict[str, torch.cuda.CUDAGraph],
                 outputs: dict[str, Any], pool_bytes: int):
        self.graphs = graphs
        self.outputs = outputs
        self.pool_bytes = pool_bytes
        self.replays = 0

    def replay(self, name: str) -> Any:
        self.graphs[name].replay()
        self.replays += 1
        return self.outputs[name]


def _capture(stages: dict[str, Callable[[], Any]], device: torch.device,
             snapshot: Callable[[], Callable[[], None]] | None,
             warmup: int) -> GraphReplay:
    """Warm every stage up on a side stream (each kernel library loaded,
    each one-time attribute set, cuBLAS's workspace made for that stream),
    put back what the warm-up moved, then capture each stage in order
    into one memory pool."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device=device)
    restore = snapshot() if snapshot is not None else None
    side.wait_stream(current)
    try:
        with torch.cuda.stream(side):
            for _ in range(warmup):
                for fn in stages.values():
                    fn()
    finally:
        current.wait_stream(side)
        if restore is not None:
            restore()
    torch.cuda.synchronize(device)
    # a capture empties the allocator's cache first: so does the baseline
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    pool = torch.cuda.graph_pool_handle()
    graphs, outputs = {}, {}
    for name, fn in stages.items():
        g = torch.cuda.CUDAGraph()
        # thread_local: other threads (the checkpoint writer, a serving
        # loop) may go on calling CUDA while this thread captures
        with torch.cuda.graph(g, pool=pool, stream=side,
                              capture_error_mode="thread_local"):
            outputs[name] = fn()
        graphs[name] = g
    return GraphReplay(graphs, outputs,
                       torch.cuda.memory_reserved(device) - reserved)


def aot_compile(stages: dict[str, Callable[[], Any]], device: torch.device,
                *, eager_reason: str | None = None,
                snapshot: Callable[[], Callable[[], None]] | None = None,
                cache_dir: str | Path | None = None, warmup: int = 2
                ) -> tuple[GraphReplay | None, dict[str, Any]]:
    """Capture ``stages`` (no-argument bodies, in the order they run) as
    CUDA graphs on ``device``; returns ``(replay, info)``. ``snapshot()``
    saves what the warm-up steps move and returns the function that puts
    it back, so warming up leaves the state as it was. With an
    ``eager_reason``, or off the card, nothing is captured: ``replay``
    is None and the stages run as they are.

    ``info`` is the ``compile`` record's payload (the reference's keys):
    ``compile_s``, ``source`` (``"cuda_graph"`` or ``"eager"``, with its
    ``reason``), ``serialized`` (always False: a graph cannot be), the
    graph count and the bytes their memory pool holds, and, with a
    ``cache_dir``, ``persistent_cache``: what the kernel build cache did
    meanwhile (``entries``, ``new_entries``, ``hits``, ``misses``). A
    failed capture raises."""
    t0 = time.perf_counter()
    before = cache_stats(cache_dir) if cache_dir is not None else None
    if eager_reason is None and device.type != "cuda":
        eager_reason = ("cpu: CUDA graphs need the card; the same bodies "
                        "run eagerly")
    replay = None
    if eager_reason is None:
        with torch.cuda.device(device):
            replay = _capture(stages, device, snapshot, warmup)
    info: dict[str, Any] = {
        "compile_s": round(time.perf_counter() - t0, 3),
        "source": CUDA_GRAPH if replay is not None else EAGER,
        "serialized": False,
        "graphs": len(replay.graphs) if replay is not None else 0,
        "pool_bytes": replay.pool_bytes if replay is not None else 0}
    if eager_reason is not None:
        info["reason"] = eager_reason
    if before is not None:
        after = cache_stats(cache_dir)
        info["persistent_cache"] = {
            "dir": after["dir"], "entries": after["entries"],
            "new_entries": after["entries"] - before["entries"],
            "hits": after["hits"] - before["hits"],
            "misses": after["misses"] - before["misses"]}
    return replay, info
