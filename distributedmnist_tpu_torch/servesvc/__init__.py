"""Online serving tier (≙ ``distributedmnist_tpu/servesvc``): a
:class:`~.server.ServingReplica` hot-follows a publish dir's
checkpoints (digest-verified; a torn publish is skipped, never served)
and answers one-shot classification requests over a local socket in
power-of-2 batches behind a bounded queue, swapping weights at a batch
boundary; a :class:`~.decode.DecodeReplica` streams generations over a
paged KV cache with the ``pin``/``restart`` mid-generation swap
policies; :class:`~.client.ServeClient` is the failover client and
:func:`~.loadgen.run_load` the closed-loop load generator; a
:class:`~.tp_group.ServeGroup` runs one replica as a tensor-parallel
group of processes."""

import importlib

# each export's module, imported at the first use of the name, so that
# a TP group's supervisor (:mod:`.tp_group`) starts its ranks without
# importing torch first
_EXPORTS = {"ServingReplica": ".server", "DecodeReplica": ".decode",
            "ServeClient": ".client", "discover_endpoints": ".client",
            "run_load": ".loadgen", "BlockAllocator": ".kv_cache",
            "PagedKVCache": ".kv_cache"}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(_EXPORTS[name], __name__), name)
